"""Fused bidirectional LSTM on the card: wrapper around csrc/bilstm.cu.

``bilstm_logits_cuda`` is the twin of ``ribodetector_tpu``'s
``bilstm_logits_pallas`` with four precision modes, each its own
hand-written Hopper kernel:

  "exact"     fp32 recurrence: the recurrent product as six bf16 products
              of 3-limb bf16 splits of h and W_hh on the tensor cores (fp32
              accumulate), + the exact fp32 token row, IEEE sigmoid/tanh.
              Replaces the Pallas ``_kernel`` in its "x6" mode (HIGHEST
              precision, the same six passes on the TPU's matrix unit).
              Plain version: models/bilstm.bilstm_logits (fp32); the limb
              arithmetic itself is bilstm_logits_exact_plain.
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

All four kernels sum each 16-wide k block of the recurrent product in the
tensor cores' order, so they are not bit-identical to their plain versions
(which sum k ascending). exact's three limbs hold all of h and W_hh, so it
stays within 1e-4 of the fp32 recurrence; in the other three, high's
2-limb split and bf16 rounding of h or of the gates in the fast modes
amplify the 1-ulp order difference over T. TC_GATE states how close those
three are held, and why, and tc_gate applies it. Each read's logits still
depend only on its own tokens, bit for bit, whatever batch it sits in, and
with W_hh = 0 (zero_product_params) every kernel equals its plain version
bit for bit.

A CUDA tensor goes to the kernel or raises; a CPU tensor takes the plain
version (that is how the CPU tests and the CPU entry point run). The gather
index is computed here, outside the kernel, and the Linear(256->2) head runs
here: in fp32 for exact and high, and for the fast modes as the TPU's
DEFAULT-precision dot does (bf16 operands, fp32 accumulate).
``LAUNCH_COUNTS`` counts kernel launches per (card, mode, T): the card is
the CUDA device index (runs over several cards), T tells the length buckets
apart; ``launches`` and ``card_launches`` sum it per mode.
"""

import collections
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
    lstm_update,
    token_table,
)

MODES = ("exact", "high", "fast", "fast_bf16")
LAUNCH_COUNTS = collections.Counter()  # (card, mode, T) -> launches
# How close each tensor-core kernel is held to its plain version, on the
# logits: each term is a multiple of the yardstick's reading on the same
# reads, the yardstick being the plain version with its product summed in
# 16-wide k blocks (the mma's k-step, k_block=16), i.e. what a change of
# summation order alone does. What the order does grows with T (fast's
# mean-abs is 8.1e-4 at T = 100 and 3.8e-3 at T = 300 with the 44-step
# init, high's 8.0e-6 and 1.4e-5), and its maximum with the number of
# reads; the mean and the 99.9th percentile do not. So a right kernel
# reads about the same multiples at T = 64 as at T = 300, and at a check's
# 4133 reads as at a device call's 262144; and at T <= 100 each limit is
# at or under the absolute bound it replaced (mean-abs 5e-5 / 3e-3 /
# 5e-3, q999 5e-4 / 0.1 / 0.3, flip margin 5e-3 / 0.1 / 0.5 for high /
# fast / fast_bf16). What the gate can see falls with T (below).
# Numbers: random-token reads on an H100 (PERF.md), the planted faults in
# tests/test_torch_kernels.py:
#   mean_vs_yardstick  mean |kernel - plain| over the yardstick's: the
#                      kernels read 1.09-1.15 (high), 1.40-2.09 (fast),
#                      1.33-2.25 (fast_bf16) at T = 64-300. One rounding
#                      left out, an unrounded token row or fp32 h in the
#                      product reads 6.2-51 at T = 100; at T = 300 the
#                      order grows faster than such a fault, and fast_bf16's
#                      read 4.9-9.7, fast's token row 3.1-3.5 and its fp32 h
#                      2.0-2.1, inside (the T <= 100 settings hold that code).
#                      A dropped limb product or a bf16 token row reads
#                      482 and more at every T. A change that moves each
#                      step by about an ulp (high's sigmoid in exp form,
#                      hlo's rounding) reads like an order (0.7-1.05): bit
#                      identity under zero_product_params shows the first,
#                      no check the second.
#   q999_vs_yardstick  the 99.9th percentile of |kernel - plain| over the
#                      yardstick's: the kernels read 0.90-1.67.
#   max_vs_yardstick   max |kernel - plain| over the yardstick's max: one
#                      read's worst deviation (the order alone reaches
#                      0.094 / 0.435 for fast / fast_bf16 at 262144 reads);
#                      the kernels read 0.73-2.75.
#   flip_vs_q999       no argmax flip where the plain margin is at least
#                      this multiple of the yardstick's 99.9th percentile (a
#                      flip needs the two logits to move apart by the
#                      margin): at T <= 100 1.9e-4 to 2.3e-4 for high,
#                      0.064-0.097 for fast and 0.17-0.25 for fast_bf16; at
#                      T = 300 up to 5.6e-4, 0.27 and 0.58, where
#                      fast_bf16's kernel flips one read at 0.53 and the
#                      order alone moves a logit by 0.32.
TC_GATE = {mode: {"mean_vs_yardstick": 3.0, "q999_vs_yardstick": 2.0,
                  "max_vs_yardstick": 4.0, "flip_vs_q999": 3.5}
           for mode in ("high", "fast", "fast_bf16")}
_launch_lock = threading.Lock()


def tc_gate(mode, got, plain, yardstick):
    """TC_GATE[mode] applied to [B, 2] logits `got` against the plain
    version's `plain`, with the yardstick's logits on the same reads.
    Returns the readings (the yardstick's beside them, and each term's
    limit) and "within_gate"."""
    gate = TC_GATE[mode]
    plain = np.asarray(plain, np.float64)
    margin = np.abs(plain[:, 1] - plain[:, 0])

    def readings(x):
        x = np.asarray(x)
        diff = np.abs(x.astype(np.float64) - plain)
        flipped = x.argmax(1) != plain.argmax(1)
        return {"mean_abs": float(diff.mean()),
                "q999_abs": float(np.quantile(diff, 0.999)),
                "max_abs": float(diff.max()),
                "flips": int(flipped.sum()),
                "max_flip_margin": float(margin[flipped].max(initial=0.0)),
                "flipped": flipped}

    r, y = readings(got), readings(yardstick)
    r["flip_margin"] = gate["flip_vs_q999"] * y["q999_abs"]
    for x in (r, y):
        x["flips_at_margin"] = int(x.pop("flipped")[margin >= r["flip_margin"]].sum())
    for term in ("mean", "q999", "max"):
        r[f"{term}_abs_limit"] = gate[f"{term}_vs_yardstick"] * y[f"{term}_abs"]
    r["within_gate"] = bool(all(r[f"{t}_abs"] <= r[f"{t}_abs_limit"]
                                for t in ("mean", "q999", "max"))
                            and r["flips_at_margin"] == 0)
    return {**r, "yardstick": y}


def launches(card=None, T=None):
    """Launches per mode in LAUNCH_COUNTS, on `card` and at `T` (None:
    any)."""
    out = dict.fromkeys(MODES, 0)
    with _launch_lock:
        for (c, mode, t), n in LAUNCH_COUNTS.items():
            if card in (None, c) and T in (None, t):
                out[mode] += n
    return out


def card_launches():
    """{CUDA device index: launches per mode} for every card launched on."""
    with _launch_lock:
        cards = sorted({c for c, _, _ in LAUNCH_COUNTS})
    return {c: launches(card=c) for c in cards}


def reset_launches():
    with _launch_lock:
        LAUNCH_COUNTS.clear()


def split_bf16(x):
    """(hi, lo) limbs of fp32 x: hi = bf16_rn(x), lo = bf16_rn(x - hi), both
    returned as fp32 tensors whose values are exactly bf16."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    lo = (x - hi).to(torch.bfloat16).to(torch.float32)
    return hi, lo


def split_bf16x3(x):
    """(x1, x2, x3) limbs of fp32 x: x1 = bf16_rn(x), x2 = bf16_rn(x - x1),
    x3 = bf16_rn(x - x1 - x2), each returned as an fp32 tensor whose values
    are exactly bf16. Both subtractions are exact in fp32, and the three
    limbs hold all 24 bits of the significand: x1 + x2 + x3 == x for 0 and
    for |x| from 2^-100 up to bf16's largest finite value (~3.39e38; above
    it x1 is inf)."""
    x1 = bf16_round(x)
    r = x - x1
    x2 = bf16_round(r)
    return x1, x2, bf16_round(r - x2)


# the exact kernel's five smaller limb products, as (h limb, W limb) index
# pairs in the order it sums them: W1*h2, W2*h1, W1*h3, W3*h1, W2*h2 (with
# W1*h1, every product whose limb indices add up to at most 4, as the TPU's
# HIGHEST precision keeps them; the dropped three are ~2^-26 of the product)
EXACT_SMALL_PRODUCTS = ((1, 0), (0, 1), (2, 0), (0, 2), (1, 1))


def exact_product(hl, wl, k_block=1):
    """The exact kernel's recurrent product from the three limbs of h (hl,
    [B, K] each) and of W_hh (wl, [K, G] each): W1*h1 summed in one fp32
    accumulator, the five EXACT_SMALL_PRODUCTS in a second, and the two
    added after the k loop. The limbs hold bf16 values, so every product is
    exact in fp32. k_block=1 sums k ascending, one rounding per add;
    k_block=16 sums each 16-wide block of k as one matrix product per limb
    pair and adds them in turn, as the kernel's six warpgroup products per
    k-step do (exact's order yardstick)."""
    big = torch.zeros((hl[0].shape[0], wl[0].shape[1]), dtype=torch.float32,
                      device=hl[0].device)
    small = torch.zeros_like(big)
    if k_block == 1:
        for k in range(wl[0].shape[0]):
            torch.addcmul(big, hl[0][:, k : k + 1], wl[0][k], out=big)
            for a, b in EXACT_SMALL_PRODUCTS:
                torch.addcmul(small, hl[a][:, k : k + 1], wl[b][k], out=small)
        return big + small
    for k0 in range(0, wl[0].shape[0], k_block):
        k = slice(k0, k0 + k_block)
        big = big + hl[0][:, k] @ wl[0][k]
        for a, b in EXACT_SMALL_PRODUCTS:
            small = small + hl[a][:, k] @ wl[b][k]
    return big + small


def bilstm_logits_exact_plain(params: BiLSTMParams, tokens, lengths=None, *,
                              semantics="dense", bwd_init=None, k_block=1):
    """Plain torch version of the "exact" kernel's arithmetic: per direction
    and step, gates = exact_product of the three limbs of h and of W_hh (k
    ascending unless k_block says otherwise) + the exact fp32 token/bias
    row, then the fp32 cell (torch.sigmoid, as bilstm_logits). It agrees
    with the fp32 recurrence to about an ulp a step; the kernel is held to
    that (PLAIN["exact"], within 1e-4), and this version is its order
    yardstick at k_block=16. The k-ascending sum is slow: 6*hidden
    elementwise ops per step and direction."""
    limbs = [split_bf16x3(w) for w in (params.w_hh_f, params.w_hh_b)]

    def cell(h, c, gates_x, d):
        return lstm_update(exact_product(split_bf16x3(h), limbs[d], k_block)
                           + gates_x, c)

    last_out = bilstm_last_out(params, tokens, lengths, semantics=semantics,
                               bwd_init=bwd_init, cell=cell)
    return head(params, last_out)


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
# each kernel's yardstick: the arithmetic of its plain version with the
# recurrent product summed in 16-wide k blocks (for high and the fast
# modes TC_GATE's; for exact what the order alone moves, beside its gate)
YARDSTICK = {
    "exact": functools.partial(bilstm_logits_exact_plain, k_block=16),
    "high": functools.partial(bilstm_logits_high_plain, k_block=16),
    "fast": functools.partial(PLAIN["fast"], k_block=16),
    "fast_bf16": functools.partial(PLAIN["fast_bf16"], k_block=16),
}


def zero_product_params(params: BiLSTMParams):
    """params with W_hh zero: a kernel's recurrent product is then exactly
    zero, whatever order it sums in, and the kernel must equal its plain
    version (and its yardstick) bit for bit. This checks the cell, the
    token rows, hold and capture apart from the order, including what
    neither TC_GATE nor exact's 1e-4 can see: a change that moves each step
    by about an ulp, as a change of order does (the exp form of high's
    sigmoid, the tanh form of exact's). Nonzero W_hh gives no such weights:
    the tensor cores round an inexact sum their own way, which the plain
    version does not reproduce."""
    return params._replace(w_hh_f=torch.zeros_like(params.w_hh_f),
                           w_hh_b=torch.zeros_like(params.w_hh_b))


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


# each kernel's W_hh: the shapes of its contiguous bf16 tensors (limb,
# direction, gate column, k)
WEIGHT_SHAPES = {
    "exact": [(3, 2, 4 * HIDDEN, HIDDEN)],
    "high": [(2, 4 * HIDDEN, HIDDEN)] * 2,
    "fast": [(2, 4 * HIDDEN, HIDDEN)],
    "fast_bf16": [(2, 4 * HIDDEN, HIDDEN)],
}


def kernel_weights(mode, whh):
    """W_hh per direction ([2, H, G] fp32) in the layout `mode`'s kernel
    takes (WEIGHT_SHAPES), a tuple of contiguous bf16 tensors, each W^T per
    direction ([.., 2, G, H]: gate column, then k): exact one [3, 2, G, H]
    of the three limbs (split_bf16x3); high two [2, G, H], hi and lo
    (split_bf16); the fast modes one [2, G, H], bf16_rn(W). The limbs hold
    bf16 values, so the cast rounds nothing. Checked by check_weight_layout
    before it is returned."""
    def t(w):
        return w.transpose(-1, -2).to(torch.bfloat16).contiguous()

    if mode == "exact":
        weights = (t(torch.stack(split_bf16x3(whh))),)
    elif mode == "high":
        weights = tuple(t(w) for w in split_bf16(whh))
    else:
        weights = (t(whh),)
    check_weight_layout(mode, weights)
    return weights


def check_weight_layout(mode, weights):
    """Raises ValueError unless `weights` is what `mode`'s kernel reads
    (WEIGHT_SHAPES, contiguous bf16): a kernel reads raw device memory and
    cannot tell a wrong shape, type or stride itself."""
    want = WEIGHT_SHAPES[mode]
    got = [(tuple(w.shape), w.dtype, w.is_contiguous()) for w in weights]
    if got != [(s, torch.bfloat16, True) for s in want]:
        raise ValueError(f"the {mode} kernel takes W_hh as contiguous bf16 of "
                         f"shapes {want} (limb, direction, gate, k); got {got}")


def bilstm_logits_cuda(params: BiLSTMParams, tokens, lengths=None, *,
                       semantics="dense", mode="high", bwd_init=None):
    """[B, T] tokens -> [B, 2] fp32 logits through the selected kernel.

    Same contract as bilstm_logits: hidden must be 128, semantics dense or
    packed, packed needs lengths, bwd_init is dense-only, B = 0 returns
    [0, 2], and packed lengths are clamped to [0, T-1]. On the card the
    tokens must be a contiguous uint8 [B, T] CUDA tensor, and W_hh goes to
    the kernel as kernel_weights lays it out (exact: its three bf16 limbs,
    transposed, as one [3, 2, G, H]), checked against WEIGHT_SHAPES.
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
    weights = kernel_weights(mode, torch.stack([params.w_hh_f, params.w_hh_b]))
    fast = mode in ("fast", "fast_bf16")
    if fast:  # the single pass's token table: bf16 values stored as fp32
        tokw = bf16_round(tokw)
    out = torch.empty((B, 2 * HIDDEN), dtype=torch.float32, device=dev)

    from ribodetector_tpu_torch.ops.build import kernel_library

    lib = kernel_library()
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        err = getattr(lib, f"rd_bilstm_{mode}")(
            _ptr(tokens), _ptr(gather), _ptr(lengths), *map(_ptr, weights),
            _ptr(tokw), _ptr(init), _ptr(out), B, T, int(packed), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"bilstm {mode} kernel launch failed: "
            f"{lib.rd_cuda_error_string(err).decode()} (cudaError {err})"
        )
    with _launch_lock:
        LAUNCH_COUNTS[dev.index, mode, T] += 1
    return head_default(params, out) if fast else head(params, out)
