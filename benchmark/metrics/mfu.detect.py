"""mfu.detect: The model's forward work for every read of the unprofiled stretch over
that stretch's wall (host clock) at the bf16 dense peak, in %. It reads no trace: the
calls it divides by run at the untraced pace."""

from harness import work
from harness.readers import part


def read(rec):
    if "stretches" not in rec:
        return None
    rec = part(rec, "unprofiled")
    return 100 * work.flops(rec["bases"], rec["reads"]) / (rec["wall_s"] * work.PEAK_FLOPS)
