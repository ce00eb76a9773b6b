"""reads_per_s: Reads classified and written (each end of a pair counts) over the
window's whole wall."""

def read(rec):
    if "reads" not in rec:
        return None
    return rec["reads"] / rec["wall_s"]
