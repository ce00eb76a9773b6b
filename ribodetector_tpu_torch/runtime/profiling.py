"""Per-stage wall-time counters and the --trace-dir profiler trace.

The reference has no tracing at all (SURVEY.md 5: only tqdm progress bars).
Here every run can report where time went via --profile.

Thread attribution (round 5): the engine's work is spread over worker
threads -- parse/inflate prefetchers, the H2D dispatcher pool, the writer
thread and its deflate pool -- so main-thread timers alone cannot answer
"what do I tune on N cores" (round-4 verdict: the paired soak's 6 deflate
streams showed up nowhere except aggregate CPU util). Stages recorded off
the main thread accumulate under their own (stage, thread-role) rows; the
summary prints main-thread stages first (they sum to ~wall time) and then
worker-side stages with the number of distinct threads that contributed,
whose seconds OVERLAP the main-thread rows rather than adding to wall.
Worker threads are named rd-<role> at creation so roles group cleanly.
"""

import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager


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
    """Accumulates wall time and invocation counts per (stage, role).

    Thread-safe: stages may be entered concurrently from worker threads
    (one short lock take per stage exit; stages wrap multi-ms units of
    work, so contention is negligible)."""

    def __init__(self, enabled=True):
        self.enabled = enabled
        self.totals = defaultdict(float)  # main-thread stages (legacy keys)
        self.counts = defaultdict(int)
        self.worker_totals = defaultdict(float)  # (role, stage) -> seconds
        self.worker_counts = defaultdict(int)
        self._threads = defaultdict(set)  # (role, stage) -> thread idents
        self._lock = threading.Lock()
        self._t0 = time.time()

    @contextmanager
    def stage(self, name):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            role = _role()
            if role == "main":
                # single-writer on the main thread: keep the lock-free
                # legacy counters (bench.py reads .totals directly)
                self.totals[name] += dt
                self.counts[name] += 1
            else:
                key = (role, name)
                with self._lock:
                    self.worker_totals[key] += dt
                    self.worker_counts[key] += 1
                    self._threads[key].add(threading.get_ident())

    def add(self, name, seconds, n=1):
        if self.enabled:
            self.totals[name] += seconds
            self.counts[name] += n

    def summary(self):
        wall = time.time() - self._t0
        lines = [f"stage timings (total wall {wall:.2f}s):"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t = self.totals[name]
            lines.append(
                f"  {name:<16} {t:8.2f}s  {100 * t / wall:5.1f}%  x{self.counts[name]}"
            )
        # snapshot under the lock: worker threads (prefetchers, deflate
        # pool) may still be finishing stages while another thread prints
        # the summary (serve --concurrency shares one timer across jobs)
        with self._lock:
            wt = dict(self.worker_totals)
            wc = dict(self.worker_counts)
            nth = {k: len(v) for k, v in self._threads.items()}
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
        return "\n".join(lines)

    def worker_seconds(self):
        """{'role:stage': seconds} snapshot (bench reporting)."""
        with self._lock:
            return {
                f"{role}:{name}": round(t, 2)
                for (role, name), t in self.worker_totals.items()
            }


@contextmanager
def maybe_trace(trace_dir, device_type="cpu"):
    """torch.profiler trace of the block when a directory is given: host
    activity, plus the card's kernels and copies (CUPTI) when the run is on
    the card. On exit the Chrome trace is written into trace_dir as
    trace_<pid>_<ms>.json (open it in Perfetto or chrome://tracing; events
    of category "kernel" are device busy time)."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device_type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if device_type == "cuda":
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace_{os.getpid()}_{int(time.time() * 1000)}.json"))
