"""The port's one span mechanism (runtime/profiling.py): StageTimer self
time, the "stage.<name>" profiler ranges of StageTimer.stage and span(),
--trace-dir over every thread, the stages of a detect call and of
load_model, and the trainer's spans.

Runs on the CPU (torch.profiler's CPU activity, the native runner and the
plain recurrence); imports nothing of JAX.
"""

import collections
import gzip
import json
import threading
import time
from contextlib import contextmanager, nullcontext

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ribodetector_tpu_torch.cli import build_arg_parser, main_cpu
from ribodetector_tpu_torch.config import DEFAULT_CONFIG, ConfigParser
from ribodetector_tpu_torch.models import bilstm as tb
from ribodetector_tpu_torch.runtime import native_pipeline, profiling
from ribodetector_tpu_torch.runtime.pipeline import Predictor
from ribodetector_tpu_torch.runtime.profiling import StageTimer, all_threads_config, span
from ribodetector_tpu_torch.train import trainer as tt

COMMON = ["-l", "50", "-m", "3", "--chunk_size", "1"]
# the stages of a detect call on the main thread, and of load_model
CALL_STAGES = {"detect", "open", "steps", "route", "flush", "drain", "close"}
LOAD_STAGES = {"load.devices", "load.weights", "load.probe"}
# stages an accepted per-layer metric reads: none may hold another stage
READ_STAGES = {"parse", "write", "infer_wait", "inflate", "deflate"}


def write_library(path, n, seed, gz=False):
    rng = np.random.default_rng(seed)
    op = gzip.open if gz else open
    with op(path, "wt") as fh:
        for i in range(n):
            length = int(rng.integers(30, 61))
            seq = "".join(rng.choice(list("ACGT"), length))
            fh.write(f"@r{i}\n{seq}\n+\n{'I' * length}\n")
    return str(path)


def stage_names(prof):
    return collections.Counter(e.name for e in prof.events() if e.name.startswith("stage."))


def run_nested(timer):
    """outer (10 ms of its own) > mid (10 ms) > inner (30 ms); returns the
    host clock's seconds around the whole."""
    t0 = time.perf_counter()
    with timer.stage("outer"):
        time.sleep(0.01)
        with timer.stage("mid"):
            time.sleep(0.01)
            with timer.stage("inner"):
                time.sleep(0.03)
    return time.perf_counter() - t0


@pytest.mark.parametrize("where", ["main", "worker"])
def test_self_time_excludes_child_stages(where):
    timer = StageTimer()
    box = {}
    if where == "main":
        box["wall"] = run_nested(timer)
        rows = dict(timer.totals)
    else:
        t = threading.Thread(target=lambda: box.update(wall=run_nested(timer)),
                             name="rd-test")
        t.start()
        t.join()
        rows = {name: s for (role, name), s in timer.worker_totals.items()
                if role == "rd-test"}
        assert not timer.totals
    assert set(rows) == {"outer", "mid", "inner"}
    assert rows["inner"] >= 0.03
    # each parent's row is its duration less its child's: its own sleep,
    # never the child's 30 ms
    assert 0.01 <= rows["mid"] < 0.03
    assert 0.01 <= rows["outer"] < 0.03
    assert sum(rows.values()) <= box["wall"]


def test_self_times_of_concurrent_threads_stay_apart():
    """Two threads nest their own stages at once: each thread's stack is its
    own, so neither thread's child is taken off the other's parent."""
    timer = StageTimer()
    start = threading.Barrier(2)

    def work():
        start.wait()
        run_nested(timer)

    threads = [threading.Thread(target=work, name=f"rd-test_{k}") for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rows = {name: s for (_, name), s in timer.worker_totals.items()}
    assert timer.worker_counts[("rd-test", "outer")] == 2
    assert rows["inner"] >= 0.06
    assert 0.02 <= rows["outer"] < 0.06 and 0.02 <= rows["mid"] < 0.06


def test_summary_prints_self_time_and_unnamed_row():
    timer = StageTimer()
    run_nested(timer)
    text = timer.summary()
    assert text.startswith("stage timings, self time")
    rows = {line.split()[0]: float(line.split()[1].rstrip("s"))
            for line in text.splitlines()[1:]}
    assert {"outer", "mid", "inner", "(unnamed)"} <= set(rows)
    assert rows["(unnamed)"] >= 0


@pytest.mark.parametrize("enabled", [True, False], ids=["timer_on", "timer_off"])
def test_stage_and_span_open_ranges_while_profiling(enabled):
    """With a profiler on, stage() opens "stage.<name>" whether or not the
    timer counts, and span() opens one without a timer."""
    timer = StageTimer(enabled=enabled)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.stage("alpha"):
            with span("beta"):
                torch.ones(4).sum()
    names = stage_names(prof)
    assert names["stage.alpha"] == 1 and names["stage.beta"] == 1
    assert bool(timer.totals) == enabled


def test_no_range_is_opened_without_a_profiler(monkeypatch):
    opened = []
    monkeypatch.setattr(profiling, "record_function",
                        lambda name: opened.append(name) or nullcontext())
    for enabled in (True, False):
        with StageTimer(enabled=enabled).stage("alpha"), span("beta"):
            pass
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        with StageTimer(enabled=False).stage("alpha"), span("beta"):
            pass
    assert opened == ["stage.alpha", "stage.beta"]


def test_trace_dir_records_worker_stages(tmp_path):
    """--trace-dir on the native runner records every thread: the worker
    threads' stages (parse_work on rd-parse, write_io on rd-write) lie in
    the trace beside the main thread's."""
    if all_threads_config() is None:
        pytest.skip("this torch's profiler cannot record every thread")
    inp = write_library(tmp_path / "in.fq", 3000, seed=3)
    trace = tmp_path / "trace"
    main_cpu(["-i", inp, *COMMON, "-o", str(tmp_path / "o.fq"), "--trace-dir", str(trace)])
    events = json.loads(next(trace.glob("trace_*.json")).read_text())["traceEvents"]
    tids = collections.defaultdict(set)
    for e in events:
        if str(e.get("name", "")).startswith("stage."):
            tids[e["name"]].add(e["tid"])
    main = tids["stage.route"]
    assert main and tids["stage.parse"] == main
    workers = tids["stage.parse_work"] | tids["stage.write_io"]
    assert workers and not workers & main


def predictor(argv):
    args = build_arg_parser().parse_args(argv)
    p = Predictor(ConfigParser.from_json(DEFAULT_CONFIG), args, device="cpu")
    p.load_model()
    return p


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_profile_records_the_stages_of_a_call(tmp_path, paired):
    """A native CPU detect run with --profile: load_model's and the call's
    stages are all there, the call's once each (close twice: the outputs'
    and the threads'; route once a take, and two chunks here), and the main
    thread's self times add up to no more than the wall."""
    sides = (1, 2) if paired else (1,)
    inputs = [write_library(tmp_path / f"in_{s}.fq", 2500, seed=s) for s in sides]
    outputs = [str(tmp_path / f"o_{s}.fq") for s in sides]
    t0 = time.time()
    p = predictor(["-i", *inputs, *COMMON, "-o", *outputs, "--profile"])
    p.detect()
    wall = time.time() - t0
    rows = p.timer.totals
    assert CALL_STAGES | LOAD_STAGES <= set(rows)
    counts = p.timer.counts
    assert [counts[name] for name in ("detect", "open", "steps", "drain", "close")] == [
        1, 1, 1, 1, 2]
    assert counts["route"] >= 2
    assert sum(rows.values()) <= wall


def test_read_stages_hold_no_child_stage(tmp_path, monkeypatch):
    """No stage that an accepted per-layer metric reads (parse, write,
    infer_wait, inflate, deflate) holds another stage, on any thread, so
    each one's self time is its duration: a paired gz run with gz outputs
    and a deflate pool (its payloads cut at 1 KiB so that the pool runs on a
    small library)."""
    parents, seen = collections.defaultdict(set), set()
    local = threading.local()
    orig = StageTimer.stage

    @contextmanager
    def stage(self, name):
        stack = local.__dict__.setdefault("stack", [])
        if stack:
            parents[stack[-1]].add(name)
        seen.add(name)
        stack.append(name)
        try:
            with orig(self, name):
                yield
        finally:
            stack.pop()

    monkeypatch.setattr(StageTimer, "stage", stage)
    monkeypatch.setattr(native_pipeline._Writer, "BLOCK", 1024)
    inputs = [write_library(tmp_path / f"in_{s}.fq.gz", 2500, seed=s, gz=True) for s in (1, 2)]
    outputs = [str(tmp_path / f"o_{s}.fq.gz") for s in (1, 2)]
    rrna = [str(tmp_path / f"r_{s}.fq.gz") for s in (1, 2)]
    p = predictor(["-i", *inputs, *COMMON, "-o", *outputs, "-r", *rrna, "-e", "both",
                   "-t", "4", "--profile"])
    p.detect()
    assert READ_STAGES | CALL_STAGES <= seen
    assert not READ_STAGES & set(parents)
    # the call's stages nest as the metrics read them
    assert {"open", "steps", "route", "flush", "drain", "close"} <= parents["detect"]
    assert ("rd-deflate", "deflate") in p.timer.worker_totals


def test_trainer_spans(tmp_path):
    """fit under a profiler names a step's host part, the eval and the
    checkpoint, one range each a step or an epoch."""
    data = tt.synthetic_dataset(np.random.default_rng(5), 64, max_len=20)
    params = tb.init_params(torch.Generator().manual_seed(0), hidden=8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tt.fit(params, data, tt.TrainConfig(), epochs=2, batch_size=32, eval_data=data,
               log_fn=lambda m: None, checkpoint_dir=str(tmp_path / "ck"))
    names = stage_names(prof)
    assert names["stage.train.step"] == 4
    assert names["stage.train.eval"] == 2 and names["stage.train.checkpoint"] == 2
