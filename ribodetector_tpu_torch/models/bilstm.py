"""Bidirectional LSTM read classifier: parameters + plain fp32 forward.

Counterpart of ``ribodetector_tpu/models/bilstm.py`` with torch tensors.
Architecture: input 4, hidden 128, one bidirectional layer, Linear(256->2)
head (the reference SeqModel). Weight layout, identical to the JAX package
so parameters carry across unchanged:

  w_ih_{f,b} : [4, 512]   input projection (transposed from torch [512, 4])
  w_hh_{f,b} : [128, 512] recurrent projection
  b_{f,b}    : [512]      b_ih + b_hh merged
  w_out      : [256, 2]   head
  b_out      : [2]

Gate order along the 512 axis is i,f,g,o (4 x 128 blocks).

Two gather semantics, as in the JAX package:

- "dense" (the ONNX / detect_cpu path): both directions run over all T rows
  including padding; the output is gathered at the LAST NON-PAD input row
  (T-1 for an all-pad read).
- "packed" (the cuDNN PackedSequence path): the forward state is taken at
  t=L-1 and the backward direction starts at t=L-1.

``bilstm_logits`` is the plain recurrence: in fp32 the CPU classify path and
the plain version of the exact CUDA kernel (ops/lstm_cuda.py); in bf16
(compute_dtype=torch.bfloat16) the CPU path of the bf16 config, the
counterpart of the JAX scan in bf16.
"""

from typing import NamedTuple

import numpy as np
import torch

HIDDEN = 128
GATES = 4 * HIDDEN
ALPHABET = 4  # A C G T; token 4 = zero row / padding
NUM_CLASSES = 2


class BiLSTMParams(NamedTuple):
    w_ih_f: torch.Tensor  # [4, 512]
    w_hh_f: torch.Tensor  # [128, 512]
    b_f: torch.Tensor  # [512]
    w_ih_b: torch.Tensor  # [4, 512]
    w_hh_b: torch.Tensor  # [128, 512]
    b_b: torch.Tensor  # [512]
    w_out: torch.Tensor  # [256, 2]
    b_out: torch.Tensor  # [2]


def params_from_numpy(arrays, device="cpu") -> BiLSTMParams:
    """{field: array} (e.g. ``{k: np.asarray(v) for k, v in
    jax_params._asdict().items()}``, or an npz) -> fp32 BiLSTMParams on
    `device`."""
    return BiLSTMParams(
        **{
            k: torch.from_numpy(np.array(arrays[k], np.float32)).to(device)
            for k in BiLSTMParams._fields
        }
    )


def load_params(path, device="cpu") -> BiLSTMParams:
    with np.load(path) as z:
        return params_from_numpy({k: z[k] for k in BiLSTMParams._fields}, device)


def dense_gather_index(tokens):
    """Index of the last non-pad input row per read; T-1 if none.

    Matches the reference's T-1-argmax(flip(rowsum)): for a trailing run of
    pad rows argmax(flip) is its length, and for an all-pad input argmax
    returns 0 => index T-1.
    """
    T = tokens.shape[-1]
    if T == 0:
        raise ValueError("dense semantics requires read length T >= 1")
    pos = torch.arange(T, dtype=torch.int32, device=tokens.device)
    last = torch.where(tokens != ALPHABET, pos, -1).amax(dim=-1)
    return torch.where(last < 0, T - 1, last).to(torch.int32)


def check_contract(semantics, lengths, bwd_init):
    """The guards every forward shares; returns True for packed semantics."""
    if semantics not in ("dense", "packed"):
        raise ValueError(f"unknown semantics: {semantics}")
    packed = semantics == "packed"
    if packed and lengths is None:
        raise ValueError("packed semantics requires lengths")
    if packed and bwd_init is not None:
        raise ValueError("bwd_init is a dense-semantics device (packed "
                         "buckets are exact without it)")
    return packed


def gather_index(tokens, lengths, packed):
    """Per-read capture step: the dense rule, or the true last base clamped
    to [0, T-1] (a caller-supplied length > T would otherwise never match a
    capture step and silently return bias-only logits)."""
    if packed:
        T = tokens.shape[1]
        return torch.clamp(lengths.to(torch.int32) - 1, 0, max(T - 1, 0))
    return dense_gather_index(tokens)


def token_table(w_ih, b):
    """[5, G] input projection with the bias folded in: row k<4 = w_ih[k] + b,
    row 4 (pad token, zero input row) = b alone. One gather replaces the
    [B,4]x[4,G] product each step because the input is one-hot."""
    return torch.cat([w_ih + b[None, :], b[None, :]], dim=0)


def _lstm_cell(h, c, gates_x, w_hh):
    """One i,f,g,o LSTM cell step; gates_x holds input projection + bias."""
    gates = gates_x + h @ w_hh
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def zero_prefix_state(params: BiLSTMParams, k: int, compute_dtype=torch.float32):
    """Backward-direction (h, c) after k zero-input steps from zero state,
    in compute_dtype (exact fp32 by default; bfloat16 runs the bf16 scan of
    bilstm_logits).

    The basis of exact length-bucketed batching: under dense semantics the
    backward LSTM absorbs every pad row above a read's last base, and
    zero-input steps depend only on their COUNT (the input projection
    contributes just the bias). So a [B, T_bucket] batch whose backward
    carry starts at zero_prefix_state(params, max_len - T_bucket)
    reproduces the full [B, max_len] recurrence for every read that fits
    the bucket. All-pad reads are the exception (their T-1 gather is
    bucket-dependent); the router sends those to the full bucket.

    Returns (h, c), each [1, HIDDEN] in compute_dtype.
    """
    cd = compute_dtype
    gates_x = params.b_b.to(cd)[None, :]
    w_hh_b = params.w_hh_b.to(cd)
    h = torch.zeros((1, params.w_hh_b.shape[0]), dtype=cd,
                    device=params.b_b.device)
    c = h
    for _ in range(k):
        h, c = _lstm_cell(h, c, gates_x, w_hh_b)
    return h, c


def bilstm_last_out(params, tokens, lengths, *, semantics, bwd_init, cell,
                    dtype=torch.float32):
    """The shared recurrence: [B, T] tokens -> last_out [B, 2*hidden].

    Both directions advance in one loop: step t runs the forward cell at
    position t and the backward cell at T-1-t, and each direction's state is
    captured at the per-read gather position with a masked select.
    cell(h, c, gates_x, d) -> (h, c) is the per-direction cell (d = 0
    forward, 1 backward), so the exact and the split-precision ("high")
    forwards share everything but their arithmetic. dtype is the state's
    type: the token tables, the carries and last_out are held in it.
    """
    packed = check_contract(semantics, lengths, bwd_init)
    B, T = tokens.shape
    tokens = tokens.long()
    hidden = params.w_hh_f.shape[0]
    dev = params.w_hh_f.device
    e = (token_table(params.w_ih_f, params.b_f).to(dtype),
         token_table(params.w_ih_b, params.b_b).to(dtype))
    if packed:
        lengths = lengths.to(device=dev, dtype=torch.int32)
    gather = gather_index(tokens, lengths, packed)

    z = torch.zeros((B, hidden), dtype=dtype, device=dev)
    if bwd_init is not None:
        hb = bwd_init[0].reshape(1, hidden).to(dtype).expand(B, hidden)
        cb = bwd_init[1].reshape(1, hidden).to(dtype).expand(B, hidden)
    else:
        hb, cb = z, z
    hf, cf, cap_f, cap_b = z, z, z, z
    for t in range(T):
        pos_b = T - 1 - t
        hf, cf = cell(hf, cf, e[0][tokens[:, t]], 0)
        hb_new, cb_new = cell(hb, cb, e[1][tokens[:, pos_b]], 1)
        if packed:
            # padding steps (pos >= L) leave the backward carry untouched so
            # the backward direction starts exactly at the true last base
            valid_b = (pos_b < lengths)[:, None]
            hb_new = torch.where(valid_b, hb_new, hb)
            cb_new = torch.where(valid_b, cb_new, cb)
        hb, cb = hb_new, cb_new
        cap_f = torch.where((gather == t)[:, None], hf, cap_f)
        cap_b = torch.where((gather == pos_b)[:, None], hb, cap_b)
    return torch.cat([cap_f, cap_b], dim=-1)


def head(params, last_out):
    """Linear(256->2) in fp32."""
    return torch.addmm(params.b_out, last_out, params.w_out)


def bilstm_logits(params: BiLSTMParams, tokens, lengths=None, *,
                  semantics="dense", bwd_init=None, compute_dtype=torch.float32):
    """Classify a padded batch of token reads (plain recurrence).

    Args:
      params: BiLSTMParams.
      tokens: [B, T] integer tokens in 0..4 (4 = zero row / padding).
      lengths: [B] true lengths; required for semantics="packed".
      semantics: "dense" (ONNX/detect_cpu parity) or "packed" (cuDNN parity).
      bwd_init: optional (h, c) [1, HIDDEN] backward-carry init from
        zero_prefix_state (length-bucketed batching, dense only).
      compute_dtype: torch.float32 (exact fp32, the default) or
        torch.bfloat16: the JAX scan's bf16 arithmetic -- token tables and
        W_hh cast to bf16, h @ W_hh with a bf16 result, every sigmoid,
        tanh and elementwise op on bf16 tensors, the head in bf16.

    Returns: [B, 2] fp32 logits (class 0 = non-rRNA, 1 = rRNA).
    """
    cd = compute_dtype
    w_hh = (params.w_hh_f.to(cd), params.w_hh_b.to(cd))

    def cell(h, c, gates_x, d):
        return _lstm_cell(h, c, gates_x, w_hh[d])

    last_out = bilstm_last_out(params, tokens, lengths, semantics=semantics,
                               bwd_init=bwd_init, cell=cell, dtype=cd)
    if cd == torch.float32:
        return head(params, last_out)
    return (last_out @ params.w_out.to(cd) + params.b_out.to(cd)).to(torch.float32)
