"""Fused bidirectional LSTM on the card: wrapper around csrc/bilstm.cu.

``bilstm_logits_cuda`` is the twin of ``ribodetector_tpu``'s
``bilstm_logits_pallas`` with four precision modes, each its own
hand-written Hopper kernel:

  "exact"     fp32 recurrence (fp32 FMA, IEEE sigmoid/tanh). Replaces the
              Pallas ``_kernel`` in its "x6" mode. Plain version:
              models/bilstm.bilstm_logits.
  "high"      2-limb bf16 split of the recurrent product on the tensor
              cores (three bf16 products, fp32 accumulate) + the exact fp32
              token row, tanh-form sigmoid. Replaces the Pallas
              ``_kernel_x3cat``. Plain version: bilstm_logits_high_plain.
  "fast"      one bf16 pass on the tensor cores (bf16 operands, fp32
              accumulate), fp32 state. Replaces ``_kernel`` "x1" under fp32
              compute (--precision fast). Plain version:
              bilstm_logits_fast_plain(state_dtype=torch.float32).
  "fast_bf16" one bf16 pass on the tensor cores, gates and state in bf16.
              Replaces ``_kernel`` "x1" under bf16 compute
              (runtime.compute_dtype = bfloat16). Plain version:
              bilstm_logits_fast_plain(state_dtype=torch.bfloat16).

The three tensor-core kernels (high, fast, fast_bf16) sum each 16-wide k
block of the recurrent product in the tensor cores' order, so they are not
bit-identical to their plain versions (which sum k ascending): high's limb
split, and bf16 rounding of h or of the gates in the fast modes, amplify
the 1-ulp order difference over T. TC_GATE states how close they are held,
and why, and tc_gate applies it; each read's logits still depend only on
its own tokens, bit for bit, whatever batch it sits in.

A CUDA tensor goes to the kernel or raises; a CPU tensor takes the plain
version (that is how the CPU tests and the CPU entry point run). The gather
index is computed here, outside the kernel, and the Linear(256->2) head runs
here: in fp32 for exact and high, and for the fast modes as the TPU's
DEFAULT-precision dot does (bf16 operands, fp32 accumulate).
``LAUNCHES`` counts kernel launches per mode, ``CARD_LAUNCHES`` the same
per card (CUDA device index) for runs over several cards.
"""

import ctypes
import functools
import threading

import numpy as np
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
CARD_LAUNCHES = {}  # CUDA device index -> {mode: launches}
# How close each tensor-core kernel is held to its plain version, on the
# logits, beside the yardstick: the plain version with its product summed in
# 16-wide k blocks (the mma's k-step, k_block=16) on the same reads, i.e.
# what a change of summation order alone does. No term grows with the
# number of reads, so the gate means the same at a check's 16421 reads as
# at a device call's 262144 (numbers: random-token reads at T = 64 and 100,
# an H100, PERF.md):
#   mean_abs          mean |kernel - plain|. fast, fast_bf16: the order alone
#                     gives 4e-4 to 1.2e-3, the kernels 8e-4 to 2.2e-3; one
#                     rounding left out, an unrounded token row or fp32 h in
#                     the product gives 4.6e-3 to 2e-2. high: the order
#                     alone 5.8e-6 to 8.0e-6, the kernel 6.5e-6 to 8.9e-6; a
#                     dropped limb product or a bf16 token row 4.6e-3 to
#                     7.7e-3 (tests/test_torch_kernels.py). A change that
#                     moves each step by about an ulp (high's sigmoid in exp
#                     form, hlo's rounding) reads like an order: bit
#                     identity under zero_product_params shows the first,
#                     no check the second.
#   q999_abs          the 99.9th percentile of |kernel - plain|: about 4x the
#                     order's (0.018-0.028 fast, 0.047-0.071 fast_bf16); high
#                     ~6.5x the kernel's 6.0e-5 to 7.7e-5 (the order's:
#                     5.3e-5 to 6.6e-5), ~70x under the faults' 0.037.
#   max_vs_yardstick  max |kernel - plain| over the yardstick's max on the
#                     same reads: one read's worst deviation grows with the
#                     number of reads (the order alone reaches 0.094 / 0.435
#                     at 262144 reads), so it is held to 4x the order's (the
#                     high kernel reads 0.83-1.26x).
#   flip_margin       no argmax flip where the plain margin is at least this
#                     (high: the startup probe's 5e-3).
TC_GATE = {
    "high": {"mean_abs": 5e-5, "q999_abs": 5e-4, "max_vs_yardstick": 4.0,
             "flip_margin": 5e-3},
    "fast": {"mean_abs": 3e-3, "q999_abs": 0.1, "max_vs_yardstick": 4.0,
             "flip_margin": 0.1},
    "fast_bf16": {"mean_abs": 5e-3, "q999_abs": 0.3, "max_vs_yardstick": 4.0,
                  "flip_margin": 0.5},
}
_launch_lock = threading.Lock()


def tc_gate(mode, got, plain, yardstick):
    """TC_GATE[mode] applied to [B, 2] logits `got` against the plain
    version's `plain`, with the yardstick's logits on the same reads.
    Returns the readings (the yardstick's beside them) and "within_gate"."""
    gate = TC_GATE[mode]
    plain = np.asarray(plain, np.float64)
    margin = np.abs(plain[:, 1] - plain[:, 0])

    def readings(x):
        diff = np.abs(np.asarray(x, np.float64) - plain)
        flipped = x.argmax(1) != plain.argmax(1)
        return {"mean_abs": float(diff.mean()),
                "q999_abs": float(np.quantile(diff, 0.999)),
                "max_abs": float(diff.max()),
                "flips": int(flipped.sum()),
                "flips_at_margin": int(flipped[margin >= gate["flip_margin"]].sum()),
                "max_flip_margin": float(margin[flipped].max(initial=0.0))}

    r, y = readings(np.asarray(got)), readings(np.asarray(yardstick))
    r["max_abs_limit"] = gate["max_vs_yardstick"] * y["max_abs"]
    r["within_gate"] = bool(r["mean_abs"] <= gate["mean_abs"]
                            and r["q999_abs"] <= gate["q999_abs"]
                            and r["max_abs"] <= r["max_abs_limit"]
                            and r["flips_at_margin"] == 0)
    return {**r, "yardstick": y}


def reset_launches():
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        CARD_LAUNCHES.clear()


def split_bf16(x):
    """(hi, lo) limbs of fp32 x: hi = bf16_rn(x), lo = bf16_rn(x - hi), both
    returned as fp32 tensors whose values are exactly bf16."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    lo = (x - hi).to(torch.bfloat16).to(torch.float32)
    return hi, lo


def high_product(hhi, hlo, whi, wlo, k_block=1):
    """Whi*hhi + Whi*hlo + Wlo*hhi summed in fp32: the high kernel's
    recurrent product. The limbs hold bf16 values, so every product is exact
    in fp32. k_block=1 sums k ascending, three products per k, one rounding
    per add; k_block=16 sums each 16-wide block of k as three matrix
    products in that order and adds them in turn, as the kernel's three
    mma.sync per k-step do (the yardstick of TC_GATE["high"])."""
    acc = torch.zeros((hhi.shape[0], whi.shape[1]), dtype=torch.float32,
                      device=hhi.device)
    if k_block == 1:
        for k in range(whi.shape[0]):
            torch.addcmul(acc, hhi[:, k : k + 1], whi[k], out=acc)
            torch.addcmul(acc, hlo[:, k : k + 1], whi[k], out=acc)
            torch.addcmul(acc, hhi[:, k : k + 1], wlo[k], out=acc)
        return acc
    for k0 in range(0, whi.shape[0], k_block):
        k = slice(k0, k0 + k_block)
        acc = acc + hhi[:, k] @ whi[k]
        acc = acc + hlo[:, k] @ whi[k]
        acc = acc + hhi[:, k] @ wlo[k]
    return acc


def bilstm_logits_high_plain(params: BiLSTMParams, tokens, lengths=None, *,
                             semantics="dense", bwd_init=None, k_block=1):
    """Plain torch version of the "high" kernel's arithmetic: per direction
    and step, gates = Whi*hhi + Whi*hlo + Wlo*hhi accumulated in fp32
    (high_product, k ascending unless k_block says otherwise) plus the
    exact fp32 token/bias row, and sigmoid as 0.5*tanh(0.5x)+0.5.

    The kernel sums on the tensor cores, in their order, which no torch op
    reproduces; the limb split amplifies a 1-ulp order difference (a flipped
    rounding of hlo is 2^-16 of h) to ~1e-4 in the logits at T=100, so
    kernel and plain version agree to TC_GATE["high"], not bit for bit. The
    k-ascending sum is slow: 3*hidden elementwise ops per step and
    direction."""
    limbs = [split_bf16(w) for w in (params.w_hh_f, params.w_hh_b)]

    def sig(x):
        return 0.5 * torch.tanh(0.5 * x) + 0.5

    def cell(h, c, gates_x, d):
        hhi, hlo = split_bf16(h)
        gates = high_product(hhi, hlo, *limbs[d], k_block) + gates_x
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


def gate_product(h, w, k_block=1):
    """sum_k h[:, k] * w[k] in fp32: the fast kernels' recurrent product.
    h [B, K] and w [K, G] hold bf16 values, so every product is exact in
    fp32. k_block=1 sums k ascending, one rounding per add; k_block=16 sums
    each 16-wide block of k as one matrix product and adds the blocks in
    order, as a tensor-core mma's k-step does (the yardstick of TC_GATE:
    what a change of summation order alone does to the logits)."""
    acc = torch.zeros((h.shape[0], w.shape[1]), dtype=torch.float32,
                      device=h.device)
    if k_block == 1:
        for k in range(w.shape[0]):
            torch.addcmul(acc, h[:, k : k + 1], w[k], out=acc)
        return acc
    for k0 in range(0, w.shape[0], k_block):
        acc = acc + h[:, k0 : k0 + k_block] @ w[k0 : k0 + k_block]
    return acc


def bilstm_logits_fast_plain(params: BiLSTMParams, tokens, lengths=None, *,
                             semantics="dense", bwd_init=None,
                             state_dtype=torch.float32, k_block=1):
    """Plain torch version of the two "fast" kernels' arithmetic: the
    Pallas x1 pass, one bf16 product per direction and step.

    Both: gates = sum_k bf16(h)[k] * bf16(W_hh)[k] accumulated in fp32
    (gate_product, k ascending unless k_block says otherwise), +
    bf16(w_ih[tok] + b); the head is head_default.
    state_dtype=torch.float32 ("fast"): h, c and the cell in fp32, sigmoid
    1/(1+exp(-x)). state_dtype=torch.bfloat16 ("fast_bf16"): the gates,
    every elementwise op, h and c rounded to bf16 (values held in fp32
    tensors), sigmoid 0.5*tanh(0.5x)+0.5, the backward-carry init rounded
    too.

    The kernels sum in the tensor cores' order, which no torch op
    reproduces, and rounding h to bf16 every step turns a 1-ulp difference
    in a fp32 sum into a 2^-8-relative jump in h: kernel and plain version
    agree to TC_GATE, not bit for bit. The k-ascending sum, one rounding
    per add, is slow: hidden elementwise ops per step and direction."""
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
        gates = gate_product(h if bf16 else r(h), w[d], k_block) + r(gates_x)
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
# each tensor-core kernel's yardstick for TC_GATE: its plain version with
# the recurrent product summed in 16-wide k blocks
YARDSTICK = {
    "high": functools.partial(bilstm_logits_high_plain, k_block=16),
    "fast": functools.partial(PLAIN["fast"], k_block=16),
    "fast_bf16": functools.partial(PLAIN["fast_bf16"], k_block=16),
}


def zero_product_params(params: BiLSTMParams):
    """params with W_hh zero: a kernel's recurrent product is then exactly
    zero, whatever order it sums in, and the kernel must equal its plain
    version bit for bit. This checks the cell, the token rows, hold and
    capture apart from the order, including what TC_GATE cannot see: a
    change that moves each step by about an ulp, as a change of order does
    (the exp form of high's sigmoid). Nonzero W_hh gives no such weights:
    the tensor cores round an inexact sum their own way, which the plain
    version does not reproduce."""
    return params._replace(w_hh_f=torch.zeros_like(params.w_hh_f),
                           w_hh_b=torch.zeros_like(params.w_hh_b))


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
    if fast:
        # the single pass's operands: the token table as bf16 values stored
        # as fp32, W_hh transposed to bf16 [2, G, H] for the tensor cores
        tokw = bf16_round(tokw)
        whh = whh.transpose(1, 2).to(torch.bfloat16).contiguous()
    out = torch.empty((B, 2 * HIDDEN), dtype=torch.float32, device=dev)

    from ribodetector_tpu_torch.ops.build import kernel_library

    lib = kernel_library()
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        if mode == "high":
            # both limbs of W_hh, transposed to bf16 [2, G, H] for the
            # tensor cores (exactly bf16 values: the cast rounds nothing)
            whi, wlo = (w.transpose(1, 2).to(torch.bfloat16).contiguous()
                        for w in split_bf16(whh))
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
        card = CARD_LAUNCHES.setdefault(dev.index, dict.fromkeys(MODES, 0))
        card[mode] += 1
    return head_default(params, out) if fast else head(params, out)
