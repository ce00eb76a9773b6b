"""inflate_s_per_mread.detect: StageTimer "inflate" seconds summed over the rd-inflate threads, per
10^6 reads of the unprofiled stretch."""

from harness.readers import per_mread


def read(rec):
    return per_mread(rec, "rd-inflate:inflate")
