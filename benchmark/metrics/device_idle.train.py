"""device_idle.train: 1 - the union of kernel, copy and memset intervals over the traced
steps, from their first device event to their last, in %."""

from harness.readers import idle


def read(rec):
    return idle(rec, "device_span_s")
