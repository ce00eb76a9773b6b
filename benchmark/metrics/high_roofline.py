"""high_roofline: The high kernel's share of its roofline: the chip's bound on the
model's work for the reads it classified in the traced slice (the profiled
stretch; harness/work.py) over its summed device time there, in %."""

from harness.readers import roofline


def read(rec):
    return roofline(rec, "high", "bilstm_high_kernel")
