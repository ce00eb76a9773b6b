"""mfu.caduceus: Caduceus-Ph's forward work (harness/work_caduceus.py) for every read of
the unprofiled stretch over that stretch's wall (host clock) at the bf16 dense peak, in %."""

from harness import work_caduceus
from harness.readers import part


def read(rec):
    if "stretches" not in rec:
        return None
    rec = part(rec, "unprofiled")
    return 100 * work_caduceus.flops(rec["bases"], rec["reads"]) / (
        rec["wall_s"] * work_caduceus.PEAK_FLOPS)
