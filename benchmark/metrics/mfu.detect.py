"""mfu.detect: The model's forward work for every read of the window over the
window's wall at the bf16 dense peak, in %."""

from harness import work


def read(rec):
    if rec.get("trace") is None or "bases" not in rec:
        return None
    return 100 * work.flops(rec["bases"], rec["reads"]) / (rec["wall_s"] * work.PEAK_FLOPS)
