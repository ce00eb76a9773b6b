"""parse_share.detect: Main-thread StageTimer "parse" over the window's wall, in %."""

from harness.readers import main_share


def read(rec):
    return main_share(rec, "parse")
