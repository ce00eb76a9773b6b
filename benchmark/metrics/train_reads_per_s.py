"""train_reads_per_s: Training reads stepped over the window's whole wall: the capture, the
evals and the checkpoints included."""

def read(rec):
    if "train_reads" not in rec:
        return None
    return rec["train_reads"] / rec["wall_s"]
