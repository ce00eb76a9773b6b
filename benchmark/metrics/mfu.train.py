"""mfu.train: 3 x the forward work of each training read stepped, plus eval's
forward work, over the window's wall at the bf16 dense peak, in %."""

from harness import work


def read(rec):
    if rec.get("trace") is None or "train_bases" not in rec:
        return None
    f = 3 * work.flops(rec["train_bases"], rec["train_reads"])
    f += work.flops(rec["eval_bases"], rec["eval_reads"])
    return 100 * f / (rec["wall_s"] * work.PEAK_FLOPS)
