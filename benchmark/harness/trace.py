"""A profiler slice of the window, reduced to what the per-layer metrics
read: device busy time, each kernel's summed time, and the idle gaps named
by what the host had open then.

The interval arithmetic is chip_smoke.py ``traced_run``'s (busy = the union
of kernel, copy and memset intervals), copied. Host spans are the
benchmark's own ``record_function`` ranges ("bench.*") and the program's
StageTimer stages ("stage.*", see hooks.py).
"""

import json
import os
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def _union(spans):
    """Merged [start, end) intervals of a list of (start, end)."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class Slice:
    """start() ... stop() around whole units of work, then, once the
    window has closed, finish() leaves the reduction in .summary.
    overhead_s is the host time the profiler's own start and stop took."""

    def __init__(self, tmp, device):
        self.tmp, self.device, self.prof, self.summary = tmp, device, None, None
        self.overhead_s = 0.0

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        t = time.perf_counter()
        activities = [ProfilerActivity.CPU]
        if self.device == "cuda":
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        self.overhead_s += self.t0 - t

    def stop(self):
        import torch

        if self.device == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        self.window_s = t - self.t0
        self.prof.__exit__(None, None, None)
        self.overhead_s += time.perf_counter() - t

    def finish(self):
        path = os.path.join(self.tmp, "trace.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        with open(path) as fh:
            events = [e for e in json.load(fh)["traceEvents"]
                      if e.get("ph") == "X" and "dur" in e]
        os.remove(path)
        self.summary = reduce(events, self.window_s)


def reduce(events, window_s):
    """Chrome-trace "X" events of one slice -> {window_s, busy_s,
    device_span_s, kernel_s: {name: s}, kernels, device_ops, idle_gaps}.
    device_span_s runs from the first device event's start to the last
    one's end: the profiler's own start and stop fall outside it."""
    dev = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
           if e.get("cat") in DEVICE_CATS]
    kernel_s = defaultdict(float)
    kernels = 0
    for e in events:
        if e.get("cat") == "kernel":
            kernel_s[e["name"]] += e["dur"] / 1e6
            kernels += 1
    busy = _union([(a, b) for a, b, _ in dev])
    busy_s = sum(b - a for a, b in busy) / 1e6
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("cat") == "user_annotation"
            and e["name"].startswith(("bench.", "stage."))]
    gaps = defaultdict(float)
    if busy:
        # the slice's ends: its first and last event of any kind
        lo = min(e["ts"] for e in events)
        hi = max(e["ts"] + e["dur"] for e in events)
        edges = [lo] + [x for ab in busy for x in ab] + [hi]
        spans = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        for (a, b), name in zip(spans, _open_at([(a + b) / 2 for a, b in spans], host)):
            gaps[name] += (b - a) / 1e6
    by_op = defaultdict(float)
    for a, b, name in dev:
        by_op[name[:120]] += (b - a) / 1e6
    return {
        "window_s": window_s,
        "busy_s": busy_s,
        "device_span_s": (busy[-1][1] - busy[0][0]) / 1e6 if busy else 0.0,
        "kernel_s": dict(kernel_s),
        "kernels": kernels,
        "device_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP],
    }


def _open_at(times, host):
    """For each of the ascending times, the innermost host span open then
    (the shortest that covers it), or "no span": one sweep over the spans
    in order of their start."""
    host = sorted(host)
    active, names, k = [], [], 0
    for t in times:
        while k < len(host) and host[k][0] <= t:
            active.append(host[k])
            k += 1
        active = [h for h in active if h[1] > t]
        names.append(min(active, key=lambda h: h[1] - h[0])[2] if active else "no span")
    return names


def kernel_seconds(summary, part):
    """Summed device time of the kernels whose name holds `part`."""
    return sum(s for name, s in summary["kernel_s"].items() if part in name)
