"""A new cell, configuration, traffic mix and metric are new files and
entries: dropped into a copy of the harness, run.py finds and runs them by
name with no other file edited."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from harness import core

CALLS_PER_S = '''"""calls_per_s: library calls over the window's wall."""


def read(rec):
    return rec["attempted"] / rec["wall_s"]
'''

EXACT_READS = '''"""exact_reads: reads the exact kernel mode classified over the window."""


def read(rec):
    done = rec["kernel_work"].get("exact")
    return None if done is None else done[1]
'''


@pytest.mark.parametrize("precision,metric,source", [
    (None, "calls_per_s", CALLS_PER_S),  # a new mix and metric on a configuration there
    ("exact", "exact_reads", EXACT_READS),  # and a new configuration at another precision
])
def test_new_cell_mix_and_metric_run_by_name(tmp_path, precision, metric, source):
    repo = tmp_path / "repo"
    shutil.copytree(core.BENCH_DIR, repo / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(core.REPO, "ribodetector_tpu_torch"), repo / "ribodetector_tpu_torch")
    with open(os.path.join(core.REPO, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    before = {p: (repo / p).read_bytes() for p in
              [str(q.relative_to(repo)) for q in (repo / "benchmark").rglob("*") if q.is_file()]}
    # the new files
    mix = core.load_json("traffic", "lib_pe_gz.json")
    mix["library"]["pairs"] = 200
    (repo / "benchmark/traffic/lib_pe_tiny.json").write_text(json.dumps(mix))
    (repo / "benchmark/limits/detect_tiny.json").write_text(
        (repo / "benchmark/limits/detect_l100_pe_gz.json").read_text())
    (repo / f"benchmark/metrics/{metric}.py").write_text(source)
    config = "rd_v1_l100"
    if precision:
        cfg = core.load_json("configs", "rd_v1_l100.json")
        config = cfg["name"] = f"rd_v1_l100_{precision}"
        cfg["precision"] = precision
        (repo / f"benchmark/configs/{config}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": config, "source": cfg["source"],
                                 "file": f"benchmark/configs/{config}.json", "reduced": [],
                                 "why": "a test's"})
    # and the new entries
    bench["workloads"].append({"name": "detect_tiny", "config": config,
                               "traffic": "lib_pe_tiny", "chips": 1, "why": "a test's"})
    bench["end_to_end"].append({"name": metric, "unit": "1", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["detect_tiny"]})
    (repo / "BENCHMARK.json").write_text(json.dumps(bench))
    prog = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(repo / 'benchmark')!r})\n"
        "from harness import core\n"
        "r = core.run_cell(['--workload', 'detect_tiny', '--seed', '3', '--seconds', '0.1',"
        " '--trace', '0'], device='cpu')\n"
        "print(json.dumps(r))\n"
    )
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         timeout=600, cwd=repo)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert set(result["metrics"]) == {metric, "setup_s"}
    assert result["metrics"][metric]["value"] > 0
    for p, data in before.items():  # no file of the harness was edited
        assert (repo / p).read_bytes() == data, p


def test_run_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run prints no result and exits with another code than 0."""
    shutil.copytree(core.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(core.REPO, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    prog = (
        "import sys\n"
        f"sys.path.insert(0, {str(tmp_path / 'benchmark')!r})\n"
        "from harness import core\n"
        "core.run_cell(['--workload', 'detect_l100_pe_gz', '--seed', '3', '--seconds', '1',"
        " '--trace', '0'], device='cpu')\n"
        "print('a result')\n"
    )
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and "a result" not in out.stdout
    assert "ribodetector_tpu_torch" in out.stderr
