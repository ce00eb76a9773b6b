"""parse_share.detect: Main-thread StageTimer "parse" over the unprofiled stretch's wall, in %."""

from harness.readers import main_share


def read(rec):
    return main_share(rec, "parse")
