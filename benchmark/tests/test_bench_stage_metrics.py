"""The per-layer readers of the detect cells on synthetic records.

A traced detect window is split into an unprofiled stretch and a profiled
one (entries/detect_cli.py), whose stage totals, walls and reads differ
here. Every reader of the program's stages (main-thread stage seconds over
the stretch's wall, in %; worker stage seconds per 10^6 of its reads) and
mfu.detect read the unprofiled stretch; the device-trace readers read the
profiled one. A record that is not split (an untraced run) is read whole,
and a reader finds nothing where the record holds no stages or the program
lacks the stage."""

import json

import pytest

from harness import core, work

MAIN = {"detect": 0.4, "open": 0.2, "steps": 0.6, "route": 1.5, "drain": 2.5, "close": 0.2,
        "parse": 3.0, "write": 1.0, "infer_wait": 0.7}
WORKER = {"rd-inflate:inflate": 0.3, "rd-deflate:deflate": 0.8, "rd-parse:parse_work": 0.5,
          "thread:parse_work": 0.1, "rd-dispatch:h2d_call": 1.0}
UNPROFILED = {"wall_s": 10.0, "calls": 5, "reads": 2_000_000, "bases": 190_000_000,
              "load_model_s": 0.05, "kernel_work": {"high": (190_000_000, 2_000_000)},
              "stages": {"main": MAIN, "worker": WORKER}}
# the profiler slows the same calls: fewer reads in a longer wall, each stage longer
PROFILED = {"wall_s": 12.5, "calls": 4, "reads": 1_600_000, "bases": 152_000_000,
            "load_model_s": 0.06, "kernel_work": {"high": (152_000_000, 1_600_000)},
            "stages": {"main": {k: 1.5 * v for k, v in MAIN.items()},
                       "worker": {k: 1.2 * v for k, v in WORKER.items()}},
            "trace": {"window_s": 12.5, "busy_s": 2.5, "device_span_s": 12.0,
                      "kernel_s": {"bilstm_high_kernel": 0.5}}}
# each reader of the program's stages over UNPROFILED, worked by hand
WANT = {"startup_share.detect": 0.5, "parse_share.detect": 30.0, "write_share.detect": 10.0,
        "infer_wait_share.detect": 7.0, "route_share.detect": 15.0, "drain_share.detect": 25.0,
        "call_overhead_share.detect": 10.0, "unnamed_share.detect": 4.0,
        "inflate_s_per_mread.detect": 0.15, "deflate_s_per_mread.detect": 0.4,
        "parse_work_s_per_mread.detect": 0.3}
# ... and over the split window, with the wall-clock mfu
WANT_UNPROFILED = {**WANT, "mfu.detect": 100 * work.flops(190_000_000, 2_000_000)
                   / (10.0 * work.PEAK_FLOPS)}
WANT_PROFILED = {"high_roofline": 100 * work.bound_seconds(152_000_000, 1_600_000) / 0.5,
                 "device_idle.detect": 80.0}


def read(name, rec):
    return core.load_module("metrics", name).read(rec)


def split(unprofiled, profiled):
    """A traced detect window's record (entries/detect_cli.py window)."""
    return {"attempted": unprofiled["calls"] + profiled["calls"], "failed": 0,
            "stretches": {"unprofiled": unprofiled, "profiled": profiled},
            **{k: unprofiled[k] + profiled[k] for k in ("wall_s", "reads", "bases")}}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_its_stages(name):
    rec = {k: v for k, v in UNPROFILED.items() if k != "kernel_work"}
    assert read(name, rec) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_finds_nothing_without_the_stages(name):
    # an untraced run keeps no stages; a program without these stages (one
    # older than them) times none of them
    assert read(name, {"wall_s": 10.0, "reads": 2_000_000}) is None
    assert read(name, {"wall_s": 10.0, "reads": 2_000_000, "stages": None}) is None
    rec = {"wall_s": 10.0, "reads": 2_000_000, "stages": {"main": {}, "worker": {}}}
    assert read(name, split(rec | {"calls": 1, "bases": 1}, dict(PROFILED))) is None


@pytest.mark.parametrize("name", sorted(WANT_UNPROFILED))
def test_reader_reads_the_unprofiled_stretch(name):
    assert read(name, split(UNPROFILED, PROFILED)) == pytest.approx(WANT_UNPROFILED[name])
    assert read(name, split(PROFILED, UNPROFILED)) != pytest.approx(WANT_UNPROFILED[name])


@pytest.mark.parametrize("name", sorted(WANT_PROFILED))
def test_device_reader_reads_the_profiled_stretch(name):
    assert read(name, split(UNPROFILED, PROFILED)) == pytest.approx(WANT_PROFILED[name])
    swapped = split({k: v for k, v in PROFILED.items() if k != "trace"}, UNPROFILED)
    assert read(name, swapped) is None


def detect_metrics():
    """Every per-layer metric that BENCHMARK.json lists for a detect cell."""
    with open(f"{core.REPO}/BENCHMARK.json") as fh:
        bench = json.load(fh)
    cells = {c["name"] for c in bench["workloads"]
             if core.load_json("traffic", f"{c['traffic']}.json")["entry"] == "detect_cli"}
    return [m for m in bench["per_layer"] if cells & set(m.get("workloads", cells))]


@pytest.mark.parametrize("metric", detect_metrics(), ids=lambda m: m["name"])
def test_each_detect_metric_reads_its_stretch(metric):
    """A device-trace metric moves with the profiled stretch alone, every
    other metric (the program's spans, the wall-clock mfu) with the
    unprofiled stretch alone."""
    name = metric["name"]
    base = read(name, split(UNPROFILED, PROFILED))
    assert base is not None
    other = {**UNPROFILED, "wall_s": 7.0, "reads": 3_000_000, "bases": 280_000_000,
             "load_model_s": 0.02, "stages": PROFILED["stages"], "trace": PROFILED["trace"]}
    if metric["source"] == "device_trace":
        assert read(name, split(other, PROFILED)) == base
        assert read(name, split(UNPROFILED, {**other, "trace": {
            **PROFILED["trace"], "busy_s": 3.0, "kernel_s": {"bilstm_high_kernel": 0.6}}})) != base
    else:
        assert read(name, split(UNPROFILED, other)) == base
        assert read(name, split(other, PROFILED)) != base
