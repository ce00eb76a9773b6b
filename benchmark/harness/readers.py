"""Arithmetic the per-layer metric readers (metrics/*.py) share. Each
returns None where the run's record has nothing to read.

A traced detect window is split into two stretches (entries/detect_cli.py):
the program's stage times and the wall-clock ratios are read over the
unprofiled one, the device trace over the profiled one."""

from harness import work
from harness.trace import kernel_seconds


def part(rec, name):
    """The stretch `name` ("unprofiled" or "profiled") of a split window's
    record; the record itself where the window was not split (an untraced
    run, the train entry)."""
    return rec["stretches"][name] if "stretches" in rec else rec


def main_share(rec, stage):
    """A main-thread StageTimer stage over the unprofiled stretch's wall,
    in %."""
    rec = part(rec, "unprofiled")
    stages = rec.get("stages")
    if not stages or stage not in stages["main"]:
        return None
    return 100 * stages["main"][stage] / rec["wall_s"]


def per_mread(rec, key):
    """A worker stage's seconds, summed over its threads, per 10^6 reads of
    the unprofiled stretch. `key` is "<role>:<stage>", or "*:<stage>" to
    sum over every worker role that times the stage."""
    rec = part(rec, "unprofiled")
    stages = rec.get("stages")
    if not stages or not rec.get("reads"):
        return None
    role, stage = key.split(":", 1)
    found = [s for k, s in stages["worker"].items()
             if k == key or (role == "*" and k.split(":", 1)[1] == stage)]
    if not found:
        return None
    return sum(found) / (rec["reads"] / 1e6)


def roofline(rec, mode, kernel):
    """The chip's bound on the model's work for the reads kernel `mode`
    classified in the traced slice, over the kernel's summed device time
    there, in %."""
    rec = part(rec, "profiled")
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
    summary = part(rec, "profiled").get("trace")
    if summary is None or summary[span] <= 0:
        return None
    return 100 * (1 - summary["busy_s"] / summary[span])
