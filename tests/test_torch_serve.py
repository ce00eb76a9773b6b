"""The port's JSONL job server (serve.main_cpu) against the JAX server.

The JAX server (--kernel scan) runs once, in a module-scoped fixture, over a
JSONL of jobs: a single-end job, a job whose input is missing, a paired
-e both job, a malformed line and a paired -e norrna job, each with
"chunk_size": 1 at -l 50 -m 3 (a 1024-row device batch). Its responses and
output files are kept; then the port serves the same JSONL, at
--precision fast, and must answer the same responses (seconds excepted)
and write byte-identical outputs (gz: decompressed content). On the CPU both
packages run the fp32 recurrence at --precision fast, and every read's
margin is checked first (test_torch_cli.py), so identity is well-defined.
"""

import io
import json
import os
import shutil

import numpy as np
import pytest

from ribodetector_tpu.serve import main as jax_serve
from ribodetector_tpu_torch import serve
from ribodetector_tpu_torch.config import DEFAULT_CONFIG, ConfigParser
from ribodetector_tpu_torch.runtime.pipeline import resolve_state_path
from tests.conftest import random_reads
from tests.test_torch_cli import LEN, assert_margins, content, write_fastq

ARGV = ["-l", str(LEN), "-m", "3", "--precision", "fast"]


@pytest.fixture(scope="module")
def jobs(tmp_path_factory, ref_params_path):
    """(JSONL lines, output paths) over freshly written inputs."""
    d = tmp_path_factory.mktemp("serve")
    rng = np.random.default_rng(31)
    single = random_reads(rng, 50, lmin=20, lmax=70)
    r1 = random_reads(rng, 40, lmin=30, lmax=60)
    r2 = random_reads(rng, 40, lmin=30, lmax=60)
    assert_margins(ref_params_path, single, r1, r2)
    write_fastq(d / "single.fq.gz", [f"s{i}" for i in range(50)], single)
    write_fastq(d / "r1.fq", [f"p{i}" for i in range(40)], r1)
    write_fastq(d / "r2.fq", [f"p{i}" for i in range(40)], r2)
    p = lambda name: str(d / name)
    reqs = [
        {"id": 1, "input": [p("single.fq.gz")], "output": [p("o1.fq.gz")],
         "rrna": [p("rr1.fq")], "chunk_size": 1},
        {"id": 2, "input": [p("missing.fq")], "output": [p("x.fq")],
         "chunk_size": 1},
        {"id": 3, "input": [p("r1.fq"), p("r2.fq")],
         "output": [p("po1.fq"), p("po2.fq")],
         "rrna": [p("pr1.fq.gz"), p("pr2.fq.gz")], "ensure": "both",
         "chunk_size": 1},
        {"id": 4, "input": [p("r1.fq"), p("r2.fq")],
         "output": [p("no1.fq"), p("no2.fq")],
         "rrna": [p("nr1.fq"), p("nr2.fq")], "ensure": "norrna",
         "chunk_size": 1},
    ]
    lines = [json.dumps(r) + "\n" for r in reqs]
    lines.insert(3, '{"id": 5, "input": [\n')  # malformed
    outs = [p(n) for n in ("o1.fq.gz", "rr1.fq", "po1.fq", "po2.fq", "pr1.fq.gz",
                           "pr2.fq.gz", "po1.fq.unclassified.gz",
                           "po2.fq.unclassified.gz", "no1.fq", "no2.fq",
                           "nr1.fq", "nr2.fq")]
    return lines, outs


def run(main, argv, lines):
    out = io.StringIO()
    main(argv, stdin=list(lines), stdout=out)
    return [json.loads(l) for l in out.getvalue().splitlines()]


def strip_seconds(resps):
    return [{k: v for k, v in r.items() if k != "seconds"} for r in resps]


@pytest.fixture(scope="module")
def jax_run(jobs):
    """The JAX server's responses and the content of each output file; the
    files are removed so the port writes them anew."""
    lines, outs = jobs
    resps = run(jax_serve, [*ARGV, "--kernel", "scan"], lines)
    files = {f: content(f) for f in outs}
    for f in outs:
        os.remove(f)
    return resps, files


def check_port(jobs, jax_run, argv):
    lines, outs = jobs
    want, files = jax_run
    got = run(serve.main_cpu, argv, lines)
    assert strip_seconds(got) == strip_seconds(want)
    for f in outs:
        assert content(f) == files[f], f
        os.remove(f)
    return got


def test_serve_matches_jax(jobs, jax_run):
    got = check_port(jobs, jax_run, ARGV)
    assert [r["status"] for r in got] == ["ok", "error", "ok", "error", "ok"]
    assert got[0]["num_read"] == 50 and got[2]["num_read"] == 40
    assert sum(got[2]["counts"].values()) == 40
    assert got[2]["counts"]["unclf"] > 0  # discordant pairs under -e both


def test_serve_errors_are_isolated(jobs, jax_run):
    """A failing job and a malformed line answer status=error in place, and
    the jobs after them run."""
    got = check_port(jobs, jax_run, ARGV)
    assert [r["id"] for r in got] == [1, 2, 3, None, 4]
    assert "missing.fq" in got[1]["error"]
    assert got[3]["error"].startswith("JSONDecodeError")
    assert got[4]["status"] == "ok"


def test_serve_concurrency_two_keeps_order(jobs, jax_run):
    """Two jobs in flight on Predictor copies: the same responses in request
    order and the same bytes as the sequential JAX server (-m 3 // 2 is
    floored at 3, so the batches are the same)."""
    check_port(jobs, jax_run, [*ARGV, "--concurrency", "2"])


def _server(argv, config=None):
    args = serve.build_arg_parser().parse_args(argv)
    return serve.Server(args, config or ConfigParser.from_json(DEFAULT_CONFIG),
                        device="cpu")


def test_serve_reuses_the_memo(tmp_path):
    """A second job of the same shape reuses the first job's classify steps
    (Predictor._build_infer memo): the memo is unchanged after it."""
    rng = np.random.default_rng(8)
    seqs = random_reads(rng, 30, lmin=20, lmax=50)
    write_fastq(tmp_path / "in.fq", [f"s{i}" for i in range(30)], seqs)
    srv = _server(ARGV)
    job = {"input": [str(tmp_path / "in.fq")], "output": [str(tmp_path / "o.fq")],
           "chunk_size": 1}
    assert srv.run_job(job)["status"] == "ok"
    p = srv._predictors["mcc"]
    after_first = dict(p._infer_cache)
    assert after_first
    second = srv.run_job({**job, "output": [str(tmp_path / "o2.fq")]})
    assert second["status"] == "ok" and second["num_read"] == 30
    assert p._infer_cache == after_first
    assert content(tmp_path / "o2.fq") == content(tmp_path / "o.fq")


@pytest.mark.parametrize("distinct", [False, True])
def test_serve_norrna_routes_to_recall(tmp_path, distinct):
    """-e norrna selects the "recall" weights key (quirk #6): the same
    Predictor when the config aliases both keys to one file (the shipped
    config), a second one holding the other file otherwise."""
    rng = np.random.default_rng(9)
    write_fastq(tmp_path / "r1.fq", ["a", "b"], random_reads(rng, 2, 30, 50))
    write_fastq(tmp_path / "r2.fq", ["a", "b"], random_reads(rng, 2, 30, 50))
    config = ConfigParser.from_json(DEFAULT_CONFIG)
    if distinct:
        recall = tmp_path / "recall.npz"
        shutil.copy(resolve_state_path(config.config["state_file"]["recall"]), recall)
        config.config["state_file"]["recall"] = str(recall)
    srv = _server(ARGV, config)
    job = {"input": [str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")],
           "output": [str(tmp_path / "o1.fq"), str(tmp_path / "o2.fq")],
           "chunk_size": 1}
    assert srv.run_job(job)["status"] == "ok"
    assert srv.run_job({**job, "ensure": "norrna"})["status"] == "ok"
    mcc, rec = srv._predictors["mcc"], srv._predictors["recall"]
    assert (rec is not mcc) == distinct
    if distinct:
        assert rec.state_file == str(tmp_path / "recall.npz")


def test_serve_main_needs_the_card(jobs):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: serve.main runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(serve.main, ARGV, jobs[0])
