"""infer_wait_share.detect: Main-thread StageTimer "infer_wait" (waiting on H2D, classify and
D2H) over the unprofiled stretch's wall, in %."""

from harness.readers import main_share


def read(rec):
    return main_share(rec, "infer_wait")
