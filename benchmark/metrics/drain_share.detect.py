"""drain_share.detect: Main-thread StageTimer "drain" (the writer's close at a call's end:
waiting on every queued deflate and write) over the unprofiled stretch's wall, in %."""

from harness.readers import main_share


def read(rec):
    return main_share(rec, "drain")
