"""Arithmetic the per-layer metric readers (metrics/*.py) share. Each
returns None where the run's record has nothing to read."""

from harness import work
from harness.trace import kernel_seconds


def main_share(rec, stage):
    """A main-thread StageTimer stage over the window's wall, in %."""
    stages = rec.get("stages")
    if not stages or stage not in stages["main"]:
        return None
    return 100 * stages["main"][stage] / rec["wall_s"]


def per_mread(rec, key):
    """A worker stage's seconds, summed over its threads, per 10^6 reads."""
    stages = rec.get("stages")
    if not stages or key not in stages["worker"] or not rec.get("reads"):
        return None
    return stages["worker"][key] / (rec["reads"] / 1e6)


def roofline(rec, mode, kernel):
    """The chip's bound on the model's work for the reads kernel `mode`
    classified in the traced slice, over the kernel's summed device time
    there, in %."""
    summary = rec.get("trace")
    done = rec.get("kernel_work", {}).get(mode)
    if summary is None or not done:
        return None
    seconds = kernel_seconds(summary, kernel)
    if seconds <= 0:
        return None
    return 100 * work.bound_seconds(*done) / seconds


def idle(rec, span="window_s"):
    """1 - the device's busy union over the traced slice's span, in %: the
    host-clock window, or with span="device_span_s" the first device
    event to the last."""
    summary = rec.get("trace")
    if summary is None or summary[span] <= 0:
        return None
    return 100 * (1 - summary["busy_s"] / summary[span])
