"""route_share.detect: Main-thread StageTimer "route" self time (the cursors' takes, each
record's length bucket and the row copies into staging; its dispatches, waits and writes
left out) over the unprofiled stretch's wall, in %."""

from harness.readers import main_share


def read(rec):
    return main_share(rec, "route")
