"""Rehearsals of the cells on the CPU at a tiny size, through the same
harness as a measured run (run_cell with device="cpu": the measured
command fails where it finds no card and never falls back to the CPU); the
faults a cell can have, planted in the program under the timed path; and
the control (harness/control.py: the reference at TF32 in the program's
place). Each fault and the control must turn `correct` false under the
cell's limits, judged by the cell's own run and check. The control runs on
the card at each cell's own size on three seeds (python3 -m pytest
benchmark/tests -m cuda -s, which prints each run's compared numbers: the
upper readings the limits are set from), and on the CPU where a test's
size shows it."""

import json

import pytest
import torch

from harness import control, core

TINY = {
    "detect_l100_pe_gz": {"library": "pairs:300"},
    "detect_l300_fa": {"library": "pairs:40"},
    "train_l100_b200": {"train_reads": 800, "val_reads": 256, "warmup_reads": 400,
                        "trace_from": 2, "trace_steps": 2},
}
CONTROL_SEEDS = (3_300_000_777, 3_300_000_778, 3_300_000_779)


def overrides(workload):
    out = {}
    for key, value in TINY[workload].items():
        if isinstance(value, str):  # a smaller library: "pairs:<n>"
            with open(f"{core.BENCH_DIR}/traffic/{traffic_of(workload)}.json") as fh:
                lib = json.load(fh)["library"]
            lib["pairs"] = int(value.split(":")[1])
            value = lib
        out[key] = value
    return out


def cell_of(workload):
    with open(f"{core.REPO}/BENCHMARK.json") as fh:
        return {c["name"]: c for c in json.load(fh)["workloads"]}[workload]


def traffic_of(workload):
    return cell_of(workload)["traffic"]


def run(workload, trace=0, seconds=0.1, seed=2**31 + 7, device="cpu"):
    """One run of the cell: on the CPU at its tiny size, on the card at its
    own."""
    if device == "cpu":
        torch.set_num_threads(2)
    return core.run_cell(["--workload", workload, "--seed", str(seed), "--seconds",
                          str(seconds), "--trace", str(trace)], device=device,
                         overrides=overrides(workload) if device == "cpu" else None)


def control_run(workload, seed, device):
    max_len = core.load_json("configs", f"{cell_of(workload)['config']}.json")["len"]
    with control.reference_in_place(max_len):
        result = run(workload, seed=seed, device=device)
    print(json.dumps({"control": workload, "seed": seed,
                      "compared": {k: c["value"] for k, c in result["compared"].items()}}))
    return result


def test_measured_command_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert core.main(["--workload", "detect_l100_pe_gz", "--seed", "1", "--seconds", "1",
                      "--trace", "0"]) == 3
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("workload", sorted(TINY))
def test_cell_rehearsal_is_correct(workload):
    result = run(workload)
    assert result["correct"], result["compared"]
    assert "setup_s" in result["metrics"] and len(result["metrics"]) >= 2
    assert list(result)[-1] == "compared"


def test_traced_rehearsal_reports_host_metrics():
    result = run("detect_l100_pe_gz", trace=1)
    assert result["correct"]
    with open(f"{core.REPO}/BENCHMARK.json") as fh:
        listed = {m["name"] for m in json.load(fh)["per_layer"]
                  if m["source"] != "device_trace"
                  and "detect_l100_pe_gz" in m.get("workloads", ["detect_l100_pe_gz"])}
    # every metric of the program's spans, and the wall-clock mfu (the
    # device trace's need a card; the deflate pool splits only payloads
    # larger than this library's)
    assert listed - {"deflate_s_per_mread.detect"} <= set(result["metrics"])
    assert result["device"]["window_s"] > 0
    # each stretch's calls and wall, for the profiler's cost
    stretches = result["stretches"]
    assert set(stretches) == {"unprofiled", "profiled"}
    assert all(p["calls"] >= 1 and p["wall_s"] > 0 for p in stretches.values())
    assert sum(p["calls"] for p in stretches.values()) == result["attempted"]


def swap_first_read(monkeypatch):
    """An answer altered where it is produced: the first read of every
    classify call gets its two logits swapped."""
    import ribodetector_tpu_torch.ops as ops

    orig = ops.classify_logits

    def classify_logits(*a, **kw):
        out = orig(*a, **kw).clone()
        out[0] = out[0].flip(0)
        return out

    monkeypatch.setattr(ops, "classify_logits", classify_logits)


def state_unchanged(monkeypatch):
    """A step that leaves the parameters as they were."""
    from ribodetector_tpu_torch.train import optim

    monkeypatch.setattr(optim.Adam, "update", lambda self, grad: None)


def half_batch(monkeypatch):
    """Half of each batch left out, the mean taken over the rest."""
    from ribodetector_tpu_torch.train import trainer

    orig = trainer._loss_fn

    def loss_fn(params, tokens, lengths, labels, *a, **kw):
        h = len(labels) // 2
        return orig(params, tokens[:h], None if lengths is None else lengths[:h],
                    labels[:h], *a, **kw)

    monkeypatch.setattr(trainer, "_loss_fn", loss_fn)


@pytest.mark.parametrize("workload,fault", [
    ("detect_l100_pe_gz", swap_first_read),
    ("detect_l300_fa", swap_first_read),
    ("train_l100_b200", state_unchanged),
    ("train_l100_b200", half_batch),
])
def test_fault_makes_run_incorrect(monkeypatch, workload, fault):
    fault(monkeypatch)
    result = run(workload)
    assert result["correct"] is False, result["compared"]


def test_control_makes_run_incorrect():
    """At a test's size the control shows in the training cell (its losses
    and changes); the detect cells' libraries are too small for it on the
    CPU."""
    result = control_run("train_l100_b200", CONTROL_SEEDS[0], "cpu")
    assert result["correct"] is False, result["compared"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", CONTROL_SEEDS)
@pytest.mark.parametrize("workload", ["detect_l100_pe_gz", "train_l100_b200",
                                      "detect_l300_fa"])
def test_control_makes_run_incorrect_on_the_card(workload, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells' own sizes")
    result = control_run(workload, seed, "cuda")
    assert result["correct"] is False, result["compared"]
