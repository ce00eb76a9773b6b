"""The model's own work, and the chip's peaks: the one definition every
roofline and mfu of the benchmark reads.

The published model (4 inputs, hidden 128, one bidirectional LSTM layer,
Linear(256, 2)) does, for each base of a read and each direction, the
gate pre-activations [x, h] (4 + 128 wide) times [4 + 128, 4 * 128]:
2 * (4 + 128) * (4 * 128) = 135,168 FLOPs, so 270,336 a base for both
directions, and once a read the head, 2 * 256 * 2 = 1,024. A read counts
its own bases, at most -l of them. That is the same whatever computes it:
limb products, bucket padding and pad steps are the implementation's and
are not counted, so no float32 or bfloat16 implementation can read above
100% of the bound.

The chip's bound on that work is the larger of the FLOPs at the bf16
dense peak and the bytes (one token a base in, two float32 logits a read
out) at HBM's bandwidth. Peaks: one NVIDIA H100 SXM, dense, NVIDIA's data
sheet, at its 700 W limit.
"""

import numpy as np

HIDDEN = 128
INPUT = 4
FLOPS_PER_BASE = 2 * 2 * (INPUT + HIDDEN) * (4 * HIDDEN)  # 270,336
HEAD_FLOPS = 2 * (2 * HIDDEN) * 2  # 1,024
BYTES_PER_BASE = 1
BYTES_PER_READ = 2 * 4
PEAK_FLOPS = 989e12  # bf16 dense
PEAK_BYTES = 3.35e12  # HBM3


def bases(lengths, max_len):
    """The bases the model's work counts: each read's own, capped at -l."""
    return int(np.minimum(np.asarray(lengths), max_len).sum())


def flops(n_bases, n_reads):
    """The forward FLOPs of n_reads reads holding n_bases bases."""
    return FLOPS_PER_BASE * n_bases + HEAD_FLOPS * n_reads


def bound_seconds(n_bases, n_reads):
    """The least time the chip could take for that forward work."""
    return max(flops(n_bases, n_reads) / PEAK_FLOPS,
               (BYTES_PER_BASE * n_bases + BYTES_PER_READ * n_reads) / PEAK_BYTES)
