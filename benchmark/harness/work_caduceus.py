"""Caduceus-Ph's work and its scan's bound: the one definition that
mfu.caduceus and scan_roofline.caduceus read.

Per base and layer (d_model D = 256, E = 2D = 512 channels, d_state S =
16, dt_rank R = 16, d_conv K = 4), each product counted once:

    in-projection (shared by both directions)   2 D 2E        524,288
    out-projection (once, on the summed output) 2 E D         262,144
    per direction: conv 2 E K (4,096), x_proj 2 E (R + 2S) (49,152),
    dt 2 R E (16,384), scan 6 E S (49,152)      x 2           237,568
                                                            1,024,000

so 16 layers x 2 strands (the read and its reverse complement) make
32,768,000 FLOPs a base, and each strand's head 2 D 2 = 1,024 a read. A
read counts its own bases, at most -l; padding and products computed twice
are not counted.

The scan's bound (the conv and scan kernels between the in- and the
out-projection), per base, layer and strand, both directions: the larger
of its FLOPs (conv, dt, scan, one FLOP an exp and the gate: 159,744) at the
fp32 CUDA-core peak (the gate, (y_f + y_r) SiLU(z), at 8 E), its transcendentals (2 E S exp and 2 E softplus:
17,408) at the SFU's rate, and its least bytes (x and z in, the gated
output out: 3 E 2 B) at HBM's bandwidth. x_proj's FLOPs are left out, so
the share reads the same whether x_proj runs inside the kernels or not.
The residual add and RMSNorm around the mixers (norm_roofline.caduceus)
is bound by bytes: per base and strand, the first norm reads the fp32
residual and writes the bf16 norm (6 D bytes), each of the 15 others reads
the residual and the bf16 mixer output and writes both back (12 D), and
the final one reads the residual and the last output and writes the fp32
norm for the pool (10 D): 196 D = 50,176 bytes at HBM's bandwidth.

Peaks: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet; the
SFU at 16 results a clock per SM, 132 SMs, 1.98 GHz).
"""

D, E, S, R, K = 256, 512, 16, 16, 4
LAYERS, STRANDS, CLASSES = 16, 2, 2
FLOPS_PER_BASE_LAYER = (2 * D * 2 * E + 2 * E * D
                        + 2 * (2 * E * K + 2 * E * (R + 2 * S) + 2 * R * E + 6 * E * S))
FLOPS_PER_BASE = FLOPS_PER_BASE_LAYER * LAYERS * STRANDS
HEAD_FLOPS = STRANDS * 2 * D * CLASSES
SCAN_FLOPS = 2 * (2 * E * K + 2 * R * E + 6 * E * S + E * S) + 8 * E
SCAN_TRANSCENDENTALS = 2 * E * S + 2 * E
SCAN_BYTES = 3 * E * 2
NORM_BYTES = (6 + (LAYERS - 1) * 12 + 10) * D
PEAK_FLOPS = 989e12  # bf16 dense, tensor cores
PEAK_FP32 = 67e12  # fp32, CUDA cores
PEAK_SFU = 16 * 132 * 1.98e9
PEAK_BYTES = 3.35e12


def flops(n_bases, n_reads):
    """The forward FLOPs of n_reads reads holding n_bases bases."""
    return FLOPS_PER_BASE * n_bases + HEAD_FLOPS * n_reads


def scan_bound_seconds(n_bases):
    """The least time the card could take for the scan's work on n_bases
    bases (both strands, every layer)."""
    per = max(SCAN_FLOPS / PEAK_FP32, SCAN_TRANSCENDENTALS / PEAK_SFU,
              SCAN_BYTES / PEAK_BYTES)
    return n_bases * LAYERS * STRANDS * per


def norm_bound_seconds(n_bases):
    """The least time the card could take for the add-norms' bytes on
    n_bases bases (both strands)."""
    return n_bases * STRANDS * NORM_BYTES / PEAK_BYTES
