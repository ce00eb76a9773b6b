"""unnamed_share.detect: Main-thread StageTimer "detect" self time (the part of a detect call
that no finer stage of the program names) over the unprofiled stretch's wall, in %."""

from harness.readers import main_share


def read(rec):
    return main_share(rec, "detect")
