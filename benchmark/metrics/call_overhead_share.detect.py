"""call_overhead_share.detect: Main-thread StageTimer "open" + "steps" + "close" (a call's
streams, outputs and threads opened, its classify steps built, and all of it closed again)
over the unprofiled stretch's wall, in %."""

from harness.readers import main_share


def read(rec):
    shares = [main_share(rec, stage) for stage in ("open", "steps", "close")]
    if None in shares:
        return None
    return sum(shares)
