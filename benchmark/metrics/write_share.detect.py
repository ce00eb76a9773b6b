"""write_share.detect: Main-thread StageTimer "write" over the window's wall, in %."""

from harness.readers import main_share


def read(rec):
    return main_share(rec, "write")
