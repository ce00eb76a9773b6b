"""Device-side glue around the classify step.

Counterpart of ``ribodetector_tpu/ops/dispatch.py``: the unpacking of the
native parser's packed token rows on the device, and the kernel choice.
The choice follows the tensor's device and the model's hidden width: the
hand-written CUDA kernel for a CUDA tensor at the reference width 128, the
plain recurrence (models/bilstm.py) for a CPU tensor or for another width
on the card (as the JAX package runs its scan for widths its Pallas kernel
does not take). ``kernel`` (runtime config key runtime.kernel, CLI
--kernel) is "auto", "cuda" or "plain"; an explicit value that contradicts
the device or the width raises.
"""

import torch

from ribodetector_tpu_torch.models import is_caduceus
from ribodetector_tpu_torch.models.bilstm import HIDDEN, bilstm_logits

KERNELS = ("auto", "cuda", "plain")
PRECISIONS = ("exact", "high", "fast")


def unpack_b5_tokens(packed, max_len):
    """Inverse of native.pack_b5: [B, (T+2)//3] uint8 base-5 packed bytes ->
    [B, max_len] uint8 tokens (3 tokens per byte cross the host->device
    link instead of one)."""
    p = packed.to(torch.int32)
    t0 = p % 5
    t1 = (p // 5) % 5
    # clamp t2 to the pad token: a corrupt byte > 124 would otherwise emit
    # tokens 5..7 -- clamping keeps every kernel on the defined 0..4
    # alphabet even for garbage input
    t2 = torch.clamp(p // 25, max=4)
    return (
        torch.stack([t0, t1, t2], dim=-1)
        .reshape(packed.shape[0], -1)[:, :max_len]
        .to(torch.uint8)
        .contiguous()
    )


def unpack_b2_tokens(packed, max_len):
    """Inverse of native.pack_b2: [B, (T+3)//4] uint8 2-bit packed bytes ->
    [B, max_len] uint8 tokens in 0..3. The 2-bit format carries 4 bases per
    byte but only A/C/G/T(U): the native parser routes a record here only
    when every base is a clean call at full read length."""
    p = packed.to(torch.int32)
    parts = [(p >> s) & 3 for s in (0, 2, 4, 6)]
    return (
        torch.stack(parts, dim=-1)
        .reshape(packed.shape[0], -1)[:, :max_len]
        .to(torch.uint8)
        .contiguous()
    )


def resolve_kernel(kernel, device, hidden=HIDDEN):
    """'auto' -> the kernel the device runs at this hidden width: "cuda" on
    the card at the reference width, "plain" on the CPU and for any other
    width on the card. An explicit choice must agree with both (no silent
    reroute between the card and the CPU, and no plain recurrence on the
    card where the CUDA kernel runs)."""
    on_card = torch.device(device).type == "cuda"
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel: {kernel} (choose from {KERNELS})")
    if kernel == "auto":
        return "cuda" if on_card and hidden == HIDDEN else "plain"
    if kernel == "cuda" and not on_card:
        raise ValueError("kernel='cuda' needs the card; the CPU runs "
                         "kernel='plain'")
    if kernel == "cuda" and hidden != HIDDEN:
        raise ValueError(
            f"the CUDA kernels support the reference hidden width {HIDDEN} "
            f"only (got {hidden}); kernel='auto' runs the plain recurrence "
            "for custom-width checkpoints"
        )
    if kernel == "plain" and on_card and hidden == HIDDEN:
        raise ValueError("kernel='plain' on the card: the port runs the "
                         "hand-written CUDA kernel there (kernel='cuda')")
    return kernel


def kernel_mode(mode, compute_dtype):
    """The CUDA kernel that runs precision `mode` under `compute_dtype`.

    fp32 compute: "exact", "high" and "fast" each have their kernel. bf16
    compute runs the single bf16 pass with bf16 state ("fast_bf16") for
    "high" and "fast", as the JAX package rewrites matmul x3 to x1 under
    bf16; "exact" under bf16 raises, as the Pallas x6 mode does (a bit-exact
    label must not silently run one low-precision pass)."""
    if mode not in PRECISIONS:
        raise ValueError(f"unknown precision mode: {mode} (choose from {PRECISIONS})")
    if compute_dtype == torch.float32:
        return mode
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    if mode == "exact":
        raise ValueError("precision 'exact' requires float32 compute_dtype on "
                         "the card (bfloat16 runs the one-pass 'fast' kernel)")
    return "fast_bf16"


def classify_logits(params, tokens, lengths=None, *, semantics="dense",
                    kernel="auto", mode="high", compute_dtype=torch.float32,
                    bwd_init=None):
    """[B, T] tokens -> [B, 2] logits with the kernel the device runs.

    The one classify call of both models: CaduceusParams go to
    ops/caduceus_cuda.caduceus_classify (lengths required; semantics,
    mode and bwd_init do not apply), BiLSTMParams as below.

    On the card at hidden 128, mode ("exact", "high" or "fast") and
    compute_dtype select the CUDA kernel (kernel_mode). On the CPU, and on
    the card at another width, the plain recurrence runs in compute_dtype
    and mode does not change it, as the JAX package's scan ignores its
    precision mode. bwd_init is the length-bucketing
    backward-carry init (models/bilstm.py zero_prefix_state).
    """
    if is_caduceus(params):
        from ribodetector_tpu_torch.ops.caduceus_cuda import caduceus_classify

        return caduceus_classify(params, tokens, lengths, kernel=kernel,
                                 compute_dtype=compute_dtype)
    if resolve_kernel(kernel, tokens.device, params.w_hh_f.shape[0]) == "cuda":
        from ribodetector_tpu_torch.ops.lstm_cuda import bilstm_logits_cuda

        return bilstm_logits_cuda(params, tokens, lengths, semantics=semantics,
                                  mode=kernel_mode(mode, compute_dtype),
                                  bwd_init=bwd_init)
    kernel_mode(mode, torch.float32)  # the same check of mode as on the card
    return bilstm_logits(params, tokens, lengths, semantics=semantics,
                         bwd_init=bwd_init, compute_dtype=compute_dtype)
