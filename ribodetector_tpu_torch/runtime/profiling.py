"""Per-stage wall-time counters, their profiler ranges, and the --trace-dir
profiler trace.

The reference has no tracing at all (SURVEY.md 5: only tqdm progress bars).
Here every run can report where time went via --profile.

One span mechanism. While a torch profiler records anywhere in the process
(--trace-dir, or a caller's own ``torch.profiler.profile``), every
``StageTimer.stage(name)`` and every ``span(name)`` opens a profiler range
``stage.<name>``, whether or not the timer counts: the ranges share the
device trace's clock, so each gap in the card's activity can be put down
to the stage the host had open then. ``span`` serves code that has no
timer (the trainer, the CLI before the Predictor exists).

Self time. Stages nest (``detect`` holds ``route``, which holds
``infer_wait`` and ``write``); each thread keeps its own stack of open
stages, and a stage adds to its row its duration less the time covered by
its child stages, so the main thread's rows add up to no more than the
wall and the wall less their sum is what no stage names.

Counters: ``StageTimer.count(name)`` counts events beside the stages while
the timer is on, and the summary prints them after the stages; the native
runner counts ``write_parts_overlapped``, the write parts of a chunk written
while a later part of the same chunk still had a batch on the card.

Thread attribution: the engine's work is spread over worker threads --
parse/inflate prefetchers, the H2D dispatcher pool, the writer thread and
its deflate pool -- so main-thread timers alone cannot say what to tune on
N cores. Stages recorded off the main thread accumulate under their own
(stage, thread-role) rows; the summary prints main-thread stages first and
then worker-side stages with the number of distinct threads that
contributed, whose seconds OVERLAP the main-thread rows rather than adding
to wall. Worker threads are named rd-<role> at creation so roles group
cleanly.
"""

import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

from torch.autograd import profiler as _autograd_profiler
from torch.autograd.profiler import record_function


def span(name):
    """A profiler range "stage.<name>" while a torch profiler records in
    this process; nothing otherwise. The check reads the process-wide flag
    that ``profile`` sets on entry: the per-thread
    ``torch.autograd._profiler_enabled()`` reads False on every thread, the
    one that started the profiler included, when it records all threads
    (``maybe_trace``). On a thread the profiler does not record, the range
    costs a call and records nothing."""
    if _autograd_profiler._is_profiler_enabled:
        return record_function(f"stage.{name}")
    return nullcontext()


def _role():
    """Thread role for attribution: 'main' or the rd-<role> prefix."""
    name = threading.current_thread().name
    if name == "MainThread":
        return "main"
    if name.startswith("rd-"):
        # strip any pool index suffix ("rd-deflate_0" -> "rd-deflate")
        return name.split("_", 1)[0]
    return "thread"


class StageTimer:
    """Accumulates self time and invocation counts per (stage, role).

    Thread-safe: stages may be entered concurrently from worker threads
    (one short lock take per stage exit; stages wrap multi-ms units of
    work, so contention is negligible). Each thread nests its stages on a
    stack of its own."""

    def __init__(self, enabled=True):
        self.enabled = enabled
        self.totals = defaultdict(float)  # main-thread stages' self time
        self.counts = defaultdict(int)
        self.worker_totals = defaultdict(float)  # (role, stage) -> seconds
        self.worker_counts = defaultdict(int)
        self._threads = defaultdict(set)  # (role, stage) -> thread idents
        self.counters = defaultdict(int)  # events counted beside the stages
        self._lock = threading.Lock()
        self._local = threading.local()
        self._t0 = time.time()

    @contextmanager
    def stage(self, name):
        with span(name):
            if not self.enabled:
                yield
                return
            # each open stage's slot sums its children's durations
            stack = getattr(self._local, "stack", None)
            if stack is None:
                stack = self._local.stack = []
            stack.append(0.0)
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                own = dt - stack.pop()
                if stack:
                    stack[-1] += dt
                role = _role()
                if role == "main":
                    # single writer on the main thread: no lock
                    self.totals[name] += own
                    self.counts[name] += 1
                else:
                    key = (role, name)
                    with self._lock:
                        self.worker_totals[key] += own
                        self.worker_counts[key] += 1
                        self._threads[key].add(threading.get_ident())

    def count(self, name, n=1):
        """Add n to the counter `name` (nothing while the timer is off)."""
        if self.enabled:
            with self._lock:
                self.counters[name] += n

    def summary(self):
        wall = time.time() - self._t0
        lines = [f"stage timings, self time (total wall {wall:.2f}s):"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t = self.totals[name]
            lines.append(
                f"  {name:<16} {t:8.2f}s  {100 * t / wall:5.1f}%  x{self.counts[name]}"
            )
        # main-thread self times never overlap, so the rest of the wall is
        # what no stage names
        rest = wall - sum(self.totals.values())
        lines.append(f"  {'(unnamed)':<16} {rest:8.2f}s  {100 * rest / wall:5.1f}%")
        # snapshot under the lock: worker threads (prefetchers, deflate
        # pool) may still be finishing stages while another thread prints
        # the summary (serve --concurrency shares one timer across jobs)
        with self._lock:
            wt = dict(self.worker_totals)
            wc = dict(self.worker_counts)
            nth = {k: len(v) for k, v in self._threads.items()}
            counters = dict(self.counters)
        if wt:
            lines.append(
                "  worker threads (overlap the rows above; seconds summed "
                "across threads):"
            )
            for key in sorted(wt, key=wt.get, reverse=True):
                role, name = key
                t = wt[key]
                nthreads = nth[key]
                lines.append(
                    "  {:<16} {:8.2f}s  {:5.1f}%  x{}  [{} thread{}]".format(
                        f"{role[3:] if role.startswith('rd-') else role}:{name}",
                        t,
                        100 * t / wall,
                        wc[key],
                        nthreads,
                        "s" if nthreads != 1 else "",
                    )
                )
        if counters:
            lines.append("  counters:")
            for name in sorted(counters):
                lines.append(f"  {name:<16} {counters[name]:8d}")
        return "\n".join(lines)

    def worker_seconds(self):
        """{'role:stage': seconds} snapshot (bench reporting)."""
        with self._lock:
            return {
                f"{role}:{name}": round(t, 2)
                for (role, name), t in self.worker_totals.items()
            }


def all_threads_config():
    """A profiler ``experimental_config`` that records every thread of the
    process, or None where the installed torch lacks the field (the
    profiler then records the thread that started it)."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


@contextmanager
def maybe_trace(trace_dir, device_type="cpu"):
    """torch.profiler trace of the block when a directory is given: host
    activity of every thread (the stages' ranges on the main thread and on
    the rd-* workers; only the starting thread's where torch cannot record
    them all, see all_threads_config), plus the card's kernels and copies
    (CUPTI) when the run is on the card. On exit the Chrome trace is
    written into trace_dir as trace_<pid>_<ms>.json (open it in Perfetto or
    chrome://tracing; events of category "kernel" are device busy time)."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device_type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 experimental_config=all_threads_config()) as prof:
        yield
        if device_type == "cuda":
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace_{os.getpid()}_{int(time.time() * 1000)}.json"))
