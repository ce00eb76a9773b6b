"""pad_share.caduceus: 1 - the program's counters cad.tokens (bases classified, both strands)
over cad.padded_tokens (rows x bucket width x strands the kernels computed), summed over the
unprofiled stretch's StageTimers, in %: what bucketing and the calls' padding rows cost."""

from harness.readers import part


def read(rec):
    counters = (part(rec, "unprofiled").get("stages") or {}).get("counters") or {}
    if not counters.get("cad.padded_tokens"):
        return None
    return 100 * (1 - counters.get("cad.tokens", 0) / counters["cad.padded_tokens"])
