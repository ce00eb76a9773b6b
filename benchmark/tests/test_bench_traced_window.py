"""The detect entry's window on the CPU at a tiny size: what a traced and
an untraced window record, and the ranges a traced call leaves in the
trace.

A traced window runs two stretches of whole calls (entries/detect_cli.py),
each with its own calls, wall, reads and stage totals, and only the second
under the profiler; an untraced one is not split and keeps no stages. In a
traced call each stage the StageTimer enters opens one profiler range
"stage.<name>" (the program's own, runtime/profiling.py), and the trace's
reduction names the device's idle gaps by them."""

from collections import Counter

import pytest
import torch

from harness import core, hooks, trace

CELL = "detect_l100_pe_gz"


@pytest.fixture
def make_run(tmp_path, monkeypatch):
    """(trace) -> (run, the entry, its state after set-up), at 300 pairs."""
    monkeypatch.setenv("RIBODETECTOR_TPU_TORCH_CACHE", str(tmp_path / "marker-cache"))
    torch.set_num_threads(2)
    lib = core.load_json("traffic", "lib_pe_gz.json")["library"]
    lib["pairs"] = 300
    cell = {"name": CELL, "config": "rd_v1_l100", "traffic": "lib_pe_gz", "chips": 1}
    entry = core.load_module("entries", "detect_cli")

    def make(traced):
        run = core.Run(cell, 2**31 + 11, 0.1, traced, "cpu", str(tmp_path / "run"),
                       {"library": lib})
        return run, entry, entry.setup(run)

    return make


def test_untraced_record_holds_no_stages_or_stretches(make_run):
    run, entry, state = make_run(False)
    rec = entry.window(run, state)
    assert "stages" not in rec and "stretches" not in rec and "trace" not in rec
    assert rec["attempted"] >= 2 and rec["reads"] == rec["attempted"] * 600


def test_traced_record_holds_both_stretches(make_run):
    run, entry, state = make_run(True)
    rec = entry.window(run, state)
    unprofiled, profiled = rec["stretches"]["unprofiled"], rec["stretches"]["profiled"]
    assert unprofiled["calls"] >= 1 and profiled["calls"] >= 1
    assert unprofiled["calls"] + profiled["calls"] == rec["attempted"]
    for p in (unprofiled, profiled):
        assert p["wall_s"] > 0 and p["reads"] == p["calls"] * 600
        assert "route" in p["stages"]["main"] and "rd-parse:parse_work" in p["stages"]["worker"]
    # only the second stretch ran under the profiler
    assert "trace" not in unprofiled and profiled["trace"]["window_s"] > 0
    assert "stages" not in rec and "trace" not in rec


def test_traced_call_opens_one_range_per_stage(make_run, monkeypatch):
    run, entry, state = make_run(True)
    events = []

    def keep(evs, window_s):
        events.extend(evs)
        return reduce(evs, window_s)

    reduce = trace.reduce
    monkeypatch.setattr(trace, "reduce", keep)
    with hooks.predictors(run) as preds:
        sl = trace.Slice(run.tmp, run.device)
        sl.start()
        entry.call(run, state, 0)
        sl.stop()
        sl.finish()
    (timer,) = preds.timers
    ranges = Counter(e["name"] for e in events if e.get("cat") == "user_annotation")
    assert timer.counts and {f"stage.{k}": ranges[f"stage.{k}"] for k in timer.counts} == {
        f"stage.{k}": n for k, n in timer.counts.items()}
    # the reduction names a gap of the card by the innermost range open at
    # its midpoint: with kernels just before and after the shortest stage
    # range, the gap between them is that stage's (and the two gaps outside
    # them are some range's, perhaps one of the same name)
    stages = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"].startswith("stage.")]
    inner = min(stages, key=lambda e: e["dur"])
    a, b = inner["ts"], inner["ts"] + inner["dur"]
    kernels = [{"ph": "X", "cat": "kernel", "name": "k", "ts": a - 1, "dur": 1},
               {"ph": "X", "cat": "kernel", "name": "k", "ts": b, "dur": 1}]
    gaps = dict(reduce(events + kernels, 1.0)["idle_gaps"])
    assert gaps[inner["name"]] >= inner["dur"] / 1e6 - 1e-9
