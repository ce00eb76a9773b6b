"""device_idle.detect: 1 - the union of kernel, copy and memset intervals over the traced
slice's span, in %."""

from harness.readers import idle


def read(rec):
    return idle(rec)
