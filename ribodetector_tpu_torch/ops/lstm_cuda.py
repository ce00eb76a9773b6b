"""Fused bidirectional LSTM on the card: wrapper around csrc/bilstm.cu.

``bilstm_logits_cuda`` is the twin of ``ribodetector_tpu``'s
``bilstm_logits_pallas`` with four precision modes, each its own
hand-written Hopper kernel:

  "exact"     fp32 recurrence (fp32 FMA, IEEE sigmoid/tanh). Replaces the
              Pallas ``_kernel`` in its "x6" mode. Plain version:
              models/bilstm.bilstm_logits.
  "high"      2-limb bf16 split of the recurrent product accumulated in
              fp32, tanh-form sigmoid. Replaces the Pallas
              ``_kernel_x3cat``. Plain version: bilstm_logits_high_plain.
  "fast"      one bf16 pass (bf16 operands, fp32 accumulate), fp32 state.
              Replaces ``_kernel`` "x1" under fp32 compute (--precision
              fast). Plain version: bilstm_logits_fast_plain(state_dtype=
              torch.float32).
  "fast_bf16" one bf16 pass, gates and state in bf16. Replaces ``_kernel``
              "x1" under bf16 compute (runtime.compute_dtype = bfloat16).
              Plain version: bilstm_logits_fast_plain(state_dtype=
              torch.bfloat16).

A CUDA tensor goes to the kernel or raises; a CPU tensor takes the plain
version (that is how the CPU tests and the CPU entry point run). The gather
index is computed here, outside the kernel, and the Linear(256->2) head runs
here: in fp32 for exact and high, and for the fast modes as the TPU's
DEFAULT-precision dot does (bf16 operands, fp32 accumulate).
``LAUNCHES`` counts kernel launches per mode.
"""

import ctypes
import functools
import threading

import torch

from ribodetector_tpu_torch.models.bilstm import (
    HIDDEN,
    BiLSTMParams,
    bilstm_last_out,
    bilstm_logits,
    check_contract,
    gather_index,
    head,
    token_table,
)

MODES = ("exact", "high", "fast", "fast_bf16")
LAUNCHES = {mode: 0 for mode in MODES}
_launch_lock = threading.Lock()


def reset_launches():
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def split_bf16(x):
    """(hi, lo) limbs of fp32 x: hi = bf16_rn(x), lo = bf16_rn(x - hi), both
    returned as fp32 tensors whose values are exactly bf16."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    lo = (x - hi).to(torch.bfloat16).to(torch.float32)
    return hi, lo


def bilstm_logits_high_plain(params: BiLSTMParams, tokens, lengths=None, *,
                             semantics="dense", bwd_init=None):
    """Plain torch version of the "high" kernel's arithmetic: per direction
    and step, gates = Whi*hhi + Whi*hlo + Wlo*hhi accumulated in fp32 plus
    the exact fp32 token/bias row, and sigmoid as 0.5*tanh(0.5x)+0.5.

    The sum runs in the kernel's order -- k ascending, three products per k
    -- one rounding per add (each product of two bf16 values is exact in
    fp32, so an add of a product rounds as the kernel's FMA does). A matrix
    product would sum in another order, and the limb split amplifies that
    difference to ~1e-4 in the logits at T=100 (csrc/bilstm.cu). It is
    therefore slow: 3*hidden elementwise ops per step and direction."""
    limbs = [split_bf16(w) for w in (params.w_hh_f, params.w_hh_b)]

    def sig(x):
        return 0.5 * torch.tanh(0.5 * x) + 0.5

    def cell(h, c, gates_x, d):
        hhi, hlo = split_bf16(h)
        whi, wlo = limbs[d]
        acc = torch.zeros_like(gates_x)
        for k in range(whi.shape[0]):
            torch.addcmul(acc, hhi[:, k : k + 1], whi[k], out=acc)
            torch.addcmul(acc, hlo[:, k : k + 1], whi[k], out=acc)
            torch.addcmul(acc, hhi[:, k : k + 1], wlo[k], out=acc)
        gates = acc + gates_x
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = sig(f) * c + sig(i) * torch.tanh(g)
        return sig(o) * torch.tanh(c_new), c_new

    last_out = bilstm_last_out(params, tokens, lengths, semantics=semantics,
                               bwd_init=bwd_init, cell=cell)
    return head(params, last_out)


def bf16_round(x):
    """x rounded to the nearest bf16 value (ties to even), kept in fp32."""
    return x.to(torch.bfloat16).to(torch.float32)


def head_default(params: BiLSTMParams, last_out):
    """Linear(256->2) as the TPU's DEFAULT-precision dot computes it: both
    operands rounded to bf16, the products summed in fp32, + b_out. Each
    product of two bf16 values is exact in fp32."""
    return torch.addmm(params.b_out, bf16_round(last_out),
                       bf16_round(params.w_out))


def gate_product(h, w):
    """sum_k h[:, k] * w[k] in fp32, k ascending, one rounding per add: the
    fast kernels' recurrent product. h [B, K] and w [K, G] hold bf16
    values, so every product is exact in fp32 and an add of a product
    rounds as the kernel's FMA does."""
    acc = torch.zeros((h.shape[0], w.shape[1]), dtype=torch.float32,
                      device=h.device)
    for k in range(w.shape[0]):
        torch.addcmul(acc, h[:, k : k + 1], w[k], out=acc)
    return acc


def bilstm_logits_fast_plain(params: BiLSTMParams, tokens, lengths=None, *,
                             semantics="dense", bwd_init=None,
                             state_dtype=torch.float32):
    """Plain torch version of the two "fast" kernels' arithmetic: the
    Pallas x1 pass, one bf16 product per direction and step.

    Both: gates = sum_k bf16(h)[k] * bf16(W_hh)[k] accumulated in fp32, k
    ascending, + bf16(w_ih[tok] + b); the head is head_default.
    state_dtype=torch.float32 ("fast"): h, c and the cell in fp32, sigmoid
    1/(1+exp(-x)). state_dtype=torch.bfloat16 ("fast_bf16"): the gates,
    every elementwise op, h and c rounded to bf16 (values held in fp32
    tensors), sigmoid 0.5*tanh(0.5x)+0.5, the backward-carry init rounded
    too.

    The sum runs in the kernel's order, one rounding per add (each product
    of two bf16 values is exact in fp32, so an add of a product rounds as
    the kernel's FMA does): rounding h to bf16 every step turns a 1-ulp
    difference in a fp32 sum into a 2^-8-relative jump in h, so two
    summation orders drift apart, and the kernel and this version keep one.
    It is therefore slow: hidden elementwise ops per step and direction."""
    if state_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"state_dtype must be float32 or bfloat16, got {state_dtype}")
    r = bf16_round
    bf16 = state_dtype == torch.bfloat16
    w = (r(params.w_hh_f), r(params.w_hh_b))

    if bf16:
        def sig(x):
            return r(r(0.5 * r(torch.tanh(r(0.5 * x)))) + 0.5)

        def tanh(x):
            return r(torch.tanh(x))
    else:
        def sig(x):
            return torch.reciprocal(1.0 + torch.exp(-x))

        tanh = torch.tanh

    def cell(h, c, gates_x, d):
        gates = gate_product(h if bf16 else r(h), w[d]) + r(gates_x)
        i, f, g, o = (r(gates) if bf16 else gates).chunk(4, dim=-1)
        fc, ig = sig(f) * c, sig(i) * tanh(g)
        c_new = r(r(fc) + r(ig)) if bf16 else fc + ig
        h_new = sig(o) * tanh(c_new)
        return (r(h_new) if bf16 else h_new), c_new

    if bf16 and bwd_init is not None:
        bwd_init = tuple(r(x.to(torch.float32)) for x in bwd_init)
    last_out = bilstm_last_out(params, tokens, lengths, semantics=semantics,
                               bwd_init=bwd_init, cell=cell)
    return head_default(params, last_out)


# each kernel's plain torch version, (params, tokens, lengths, *, semantics,
# bwd_init) -> [B, 2] fp32 logits
PLAIN = {
    "exact": bilstm_logits,
    "high": bilstm_logits_high_plain,
    "fast": functools.partial(bilstm_logits_fast_plain, state_dtype=torch.float32),
    "fast_bf16": functools.partial(bilstm_logits_fast_plain,
                                   state_dtype=torch.bfloat16),
}


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def bilstm_logits_cuda(params: BiLSTMParams, tokens, lengths=None, *,
                       semantics="dense", mode="high", bwd_init=None):
    """[B, T] tokens -> [B, 2] fp32 logits through the selected kernel.

    Same contract as bilstm_logits: hidden must be 128, semantics dense or
    packed, packed needs lengths, bwd_init is dense-only, B = 0 returns
    [0, 2], and packed lengths are clamped to [0, T-1]. On the card the
    tokens must be a contiguous uint8 [B, T] CUDA tensor.
    """
    if params.w_hh_f.shape[0] != HIDDEN:
        raise ValueError(
            f"the CUDA kernels support the reference hidden width {HIDDEN} "
            f"only (got {params.w_hh_f.shape[0]}); use kernel='plain' on "
            "the CPU for custom-width checkpoints"
        )
    packed = check_contract(semantics, lengths, bwd_init)
    if mode not in MODES:
        raise ValueError(f"unknown precision mode: {mode}")
    if tokens.dim() != 2:
        raise ValueError(f"tokens must be [B, T], got shape {tuple(tokens.shape)}")
    B, T = tokens.shape
    dev = tokens.device
    if B == 0:  # empty in, empty out (no kernel)
        return torch.zeros((0, params.w_out.shape[1]), dtype=torch.float32,
                           device=dev)
    if dev.type != "cuda":
        return PLAIN[mode](params, tokens, lengths, semantics=semantics,
                           bwd_init=bwd_init)

    if tokens.dtype != torch.uint8 or not tokens.is_contiguous():
        raise ValueError("tokens must be a contiguous uint8 tensor on the card "
                         f"(got {tokens.dtype}, contiguous={tokens.is_contiguous()})")
    if T == 0:
        raise ValueError("the CUDA kernels need read length T >= 1")
    for name, p in params._asdict().items():
        if p.device != dev or p.dtype != torch.float32:
            raise ValueError(f"params.{name} must be float32 on {dev} "
                             f"(got {p.dtype} on {p.device})")
    if packed:
        if lengths.shape != (B,):
            raise ValueError(f"lengths must be [B={B}], got {tuple(lengths.shape)}")
        lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
    else:
        lengths = torch.zeros(B, dtype=torch.int32, device=dev)
    gather = gather_index(tokens, lengths, packed).contiguous()

    init = torch.zeros((2, HIDDEN), dtype=torch.float32, device=dev)
    if bwd_init is not None:
        init[0] = bwd_init[0].reshape(HIDDEN).to(device=dev, dtype=torch.float32)
        init[1] = bwd_init[1].reshape(HIDDEN).to(device=dev, dtype=torch.float32)
    tokw = torch.stack([token_table(params.w_ih_f, params.b_f),
                        token_table(params.w_ih_b, params.b_b)]).contiguous()
    whh = torch.stack([params.w_hh_f, params.w_hh_b]).contiguous()
    fast = mode in ("fast", "fast_bf16")
    if fast:  # the single pass's operands: bf16 values, stored as fp32
        tokw, whh = bf16_round(tokw), bf16_round(whh)
    out = torch.empty((B, 2 * HIDDEN), dtype=torch.float32, device=dev)

    from ribodetector_tpu_torch.ops.build import kernel_library

    lib = kernel_library()
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        if mode == "high":
            whi, wlo = split_bf16(whh)
            err = lib.rd_bilstm_high(
                _ptr(tokens), _ptr(gather), _ptr(lengths), _ptr(whi),
                _ptr(wlo), _ptr(tokw), _ptr(init), _ptr(out), B, T,
                int(packed), stream,
            )
        else:
            err = getattr(lib, f"rd_bilstm_{mode}")(
                _ptr(tokens), _ptr(gather), _ptr(lengths), _ptr(whh),
                _ptr(tokw), _ptr(init), _ptr(out), B, T, int(packed), stream,
            )
    if err != 0:
        raise RuntimeError(
            f"bilstm {mode} kernel launch failed: "
            f"{lib.rd_cuda_error_string(err).decode()} (cudaError {err})"
        )
    with _launch_lock:
        LAUNCHES[mode] += 1
    return head_default(params, out) if fast else head(params, out)
