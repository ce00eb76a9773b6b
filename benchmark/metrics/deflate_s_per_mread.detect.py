"""deflate_s_per_mread.detect: StageTimer "deflate" seconds summed over the rd-deflate threads, per
10^6 reads of the unprofiled stretch."""

from harness.readers import per_mread


def read(rec):
    return per_mread(rec, "rd-deflate:deflate")
