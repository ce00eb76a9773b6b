"""Caduceus-Ph's read classifier, written plainly from its equations.

Source: Schiff et al., "Caduceus: Bi-Directional Equivariant Long-Range DNA
Sequence Modeling", arXiv:2403.03234; the published configuration
https://huggingface.co/kuleshov-group/caduceus-ph_seqlen-131k_d_model-256_n_layer-16
(d_model 256, 16 layers, vocabulary 16, d_state 16, d_conv 4, expand 2,
dt_rank 16, RMSNorm eps 1e-5, bidirectional "add" with the in- and
out-projections tied, no RC equivariance: reverse-complement conjoining
after the fact). What the classifier adds is assumed: mean pooling over the
read's own bases and a bias-free head 256 -> 2.

A read s of L bases (the port's tokens 0..3 = A C G T, anything else = N):

    ids = A 7, C 8, G 9, T 10, N 11;  r = E[ids]
    each layer: u = RMSNorm(r) g;  r = r + M_f(u) + rev(M_r(rev(u)))
    p = mean over the L bases of RMSNorm_f(r);  logits(s) = p W_head
    conjoined = (logits(s) + logits(rc(s))) / 2, rc reversing s and A<->T, C<->G

and one Mamba M (its own conv, x_proj, dt_proj, A_log and D; W_in, W_out
shared by the two directions): [x, z] = u W_in; x' = SiLU(causal depthwise
conv(x) + b); [delta, B, C] = x' W_x; dt = softplus(delta W_dt + b_dt);
A = -exp(A_log); H_t = exp(dt_t A) H_{t-1} + (dt_t x'_t) B_t; y_t = H_t C_t
+ D x'_t; out = (y SiLU(z)) W_out.

The reverse direction runs on rev(x), each read reversed within its own
length by an index (positions past L stay where they are), and is
reversed back. W_in and W_out being tied and acting on each position
alone, rev(u) W_in = rev(u W_in), and the two directions' gated outputs go
through W_out once, summed (``mixer``). Every direction is causal with its
padding at the end, so reads may be batched padded to a block's longest
read; a test holds the padded form to one read at a time, unpadded.

``precision="fp32"``: float32 throughout, TF32 off. ``"bf16"``: the
configuration's statement (the three projections' operands rounded to
bf16, summed in fp32, their outputs rounded to bf16 as the card's bf16
products give them, everything else fp32). ``"bf16_state"`` is the
control, one step below it: that statement with the scan state and its
exp held in bf16 (harness/control_caduceus.py puts its scan, ``selective``,
in the program's place). ``gated``, one layer from its in-projection's
output to its gated scan output, is what the cell's ``scan_gap`` holds
the program's first layer to, at "bf16".

It imports nothing of the program under test nor of the JAX package. The
weights are drawn by ``init`` from a seed, as the published code
initialises them, and written by ``save`` in the port's npz layout (one
float32 array per field, ``_meta_json`` naming the arch).
"""

import json
import math

import numpy as np
import torch

FIELDS = ("embedding", "norm_g", "w_in", "conv_w", "conv_b", "w_x", "w_dt", "b_dt",
          "a_log", "d", "w_out", "norm_f", "w_head")
EPS = 1e-5
PAD = 4  # the port's token for anything but A, C, G, T
PAD_ID = 4  # the tokenizer's [PAD], past a read's end
COMPLEMENT = torch.tensor([3, 2, 1, 0, 4])  # A C G T N -> T G C A N
PRECISIONS = ("fp32", "bf16", "bf16_state")


def strict_fp32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def init(seed, model):
    """{field: float32 array} drawn from `seed`: mamba_ssm's Mamba init
    (A_log = log(1..S); D = 1; dt_proj's weight uniform +-dt_rank^-0.5 and
    its bias the inverse softplus of dt log-uniform in [1e-3, 1e-1], floored
    at 1e-4; in_proj, x_proj, conv as nn.Linear / nn.Conv1d's defaults,
    uniform +-1/sqrt(fan_in)) and Caduceus's _init_weights (embedding
    N(0, 0.02); out_proj uniform +-1/sqrt(fan_in), divided by
    sqrt(n_layer)); norms 1; the head N(0, 0.02)."""
    rng = np.random.default_rng(seed)
    D, n, V = model["d_model"], model["n_layer"], model["vocab_size"]
    S, K, R, C = model["d_state"], model["d_conv"], model["dt_rank"], model["num_classes"]
    E = model["expand"] * D

    def uniform(shape, bound):
        return rng.uniform(-bound, bound, shape)

    dt = np.maximum(np.exp(rng.uniform(0, 1, (n, 2, E)) * (math.log(0.1) - math.log(1e-3))
                           + math.log(1e-3)), 1e-4)
    w = {
        "embedding": rng.normal(0, 0.02, (V, D)),
        "norm_g": np.ones((n, D)),
        "w_in": uniform((n, D, 2 * E), 1 / math.sqrt(D)),
        "conv_w": uniform((n, 2, E, K), 1 / math.sqrt(K)),
        "conv_b": uniform((n, 2, E), 1 / math.sqrt(K)),
        "w_x": uniform((n, 2, E, R + 2 * S), 1 / math.sqrt(E)),
        "w_dt": uniform((n, 2, R, E), R ** -0.5),
        "b_dt": dt + np.log(-np.expm1(-dt)),
        "a_log": np.broadcast_to(np.log(np.arange(1, S + 1)), (n, 2, E, S)),
        "d": np.ones((n, 2, E)),
        "w_out": uniform((n, E, D), 1 / math.sqrt(E)) / math.sqrt(n),
        "norm_f": np.ones(D),
        "w_head": rng.normal(0, 0.02, (D, C)),
    }
    return {k: np.ascontiguousarray(v, np.float32) for k, v in w.items()}


def save(path, w, model):
    arrays = dict(w)
    meta = {"arch": "CaduceusParams", "config": model}
    arrays["_meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **arrays)


def load(path, device="cpu"):
    with np.load(path) as z:
        return {k: torch.from_numpy(np.array(z[k], np.float32)).to(device) for k in FIELDS}


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _mm(a, b, precision):
    """A projection: fp32, or (any other precision) the configuration's
    bf16 operands summed in fp32, the output rounded to bf16."""
    if precision == "fp32":
        return a @ b
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return _bf16(_bf16(a) @ _bf16(b))


def _rms(r, g):
    return r * torch.rsqrt(r.pow(2).mean(-1, keepdim=True) + EPS) * g


def _reverse(x, lengths):
    """Each row's first L positions reversed, the rest in place."""
    T = x.shape[1]
    pos = torch.arange(T, device=x.device)[None, :]
    L = lengths[:, None]
    idx = torch.where(pos < L, L - 1 - pos, pos)
    if x.dim() == 3:
        idx = idx[..., None].expand(-1, -1, x.shape[2])
    return torch.gather(x, 1, idx)


def conv(x, cw, cb):
    """The causal depthwise conv (cw [E, K], cb [E]) and SiLU of x [B, T, E]."""
    T, K = x.shape[1], cw.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, K - 1, 0))
    return torch.nn.functional.silu(cb + sum(cw[:, k] * xp[:, k: k + T] for k in range(K)))


def selective(xc, dbc, w_dt, b_dt, A, d, precision):
    """dt = softplus(delta W_dt + b_dt), the selective scan from zero state
    and the D skip of one direction: xc [B, T, E] (the conv's output), dbc
    [B, T, R + 2S] (x_proj's [delta, B, C]), w_dt [R, E], b_dt and d [E], A
    [E, S] = -exp(A_log), causal -> y [B, T, E]. In "bf16_state" the state
    and its exp are rounded to bf16 at every step."""
    R, S = w_dt.shape[0], A.shape[1]
    delta, Bm, Cm = dbc[..., :R], dbc[..., R: R + S], dbc[..., R + S:]
    dt = torch.nn.functional.softplus(delta @ w_dt + b_dt)
    state = _bf16 if precision == "bf16_state" else (lambda v: v)
    H = torch.zeros(xc.shape[0], xc.shape[2], S, device=xc.device)
    ys = []
    for t in range(xc.shape[1]):
        dA = state(torch.exp(dt[:, t, :, None] * A))
        H = state(dA * H + (dt[:, t] * xc[:, t])[:, :, None] * Bm[:, t, None, :])
        ys.append((H @ Cm[:, t, :, None])[..., 0] + d * xc[:, t])
    return torch.stack(ys, dim=1)


def ssm(w, layer, direction, x, precision):
    """One direction's conv, x_proj, dt, selective scan and D skip over the
    in-projection's x half [B, T, E], causal -> y [B, T, E]."""
    xc = conv(x, w["conv_w"][layer, direction], w["conv_b"][layer, direction])
    dbc = _mm(xc, w["w_x"][layer, direction], precision)
    return selective(xc, dbc, w["w_dt"][layer, direction], w["b_dt"][layer, direction],
                     -torch.exp(w["a_log"][layer, direction]), w["d"][layer, direction],
                     precision)


def gated(w, layer, xz, lengths, precision):
    """One layer's (M_f's y + rev(M_r's y on rev(x))) * SiLU(z) from the
    in-projection's output xz [B, T, 2E] -> [B, T, E], zero past each
    row's length: the part of a layer between its in- and out-projection."""
    E = xz.shape[-1] // 2
    x, z = xz[..., :E], xz[..., E:]
    y = ssm(w, layer, 0, x, precision)
    y = y + _reverse(ssm(w, layer, 1, _reverse(x, lengths), precision), lengths)
    inside = torch.arange(xz.shape[1], device=xz.device)[None, :, None] < lengths[:, None, None]
    return torch.where(inside, y * torch.nn.functional.silu(z), 0.0)


def mixer(w, layer, u, lengths, precision):
    """M_f(u) + rev(M_r(rev(u))) of one layer over [B, T, D] inputs. W_in
    and W_out are tied, and a projection acts on each position alone, so
    the reverse direction's in-projection is rev(u W_in) and the two
    directions' gated outputs pass through W_out once, summed."""
    xz = _mm(u, w["w_in"][layer], precision)
    return _mm(gated(w, layer, xz, lengths, precision), w["w_out"][layer], precision)


def strand_logits(w, ids, lengths, precision="fp32"):
    """[B, T] tokenizer ids (padding past each row's length), [B] lengths
    -> [B, 2] logits of the strand."""
    r = w["embedding"][ids]
    for layer in range(w["w_in"].shape[0]):
        r = r + mixer(w, layer, _rms(r, w["norm_g"][layer]), lengths, precision)
    hid = _rms(r, w["norm_f"])
    T = ids.shape[1]
    inside = (torch.arange(T, device=ids.device)[None, :] < lengths[:, None]).float()
    pooled = (hid * inside[..., None]).sum(1) / lengths.clamp(min=1)[:, None].float()
    return pooled @ w["w_head"]


def to_ids(tokens, lengths):
    T = tokens.shape[1]
    ids = torch.where(tokens < 4, tokens + 7, 11)
    inside = torch.arange(T, device=tokens.device)[None, :] < lengths[:, None]
    return torch.where(inside, ids, PAD_ID)


def forward(w, tokens, lengths, precision="fp32"):
    """[B, T] port tokens, [B] lengths (each at most T), both on w's device
    -> [B, 2] conjoined logits."""
    tokens, lengths = tokens.long(), lengths.long()
    rc = _reverse(COMPLEMENT.to(tokens.device)[tokens], lengths)
    f = strand_logits(w, to_ids(tokens, lengths), lengths, precision)
    b = strand_logits(w, to_ids(rc, lengths), lengths, precision)
    return 0.5 * (f + b)


def one_read(w, tokens, length, precision="fp32"):
    """One read alone, unpadded: [L] tokens -> [2] conjoined logits."""
    tok = torch.as_tensor(tokens[:length], device=w["w_head"].device)[None]
    return forward(w, tok, torch.tensor([length], device=tok.device), precision)[0]


def logits(w, tokens, lengths, precision="fp32", block=4096):
    """[n, T] uint8 tokens and [n] lengths (numpy) -> [n, 2] float32
    conjoined logits (numpy), in blocks of reads sorted by length, each
    padded to its longest read, on w's device."""
    strict_fp32()
    dev = w["w_head"].device
    lengths = np.minimum(np.asarray(lengths, np.int64), tokens.shape[1])
    order = np.argsort(lengths, kind="stable")
    out = np.zeros((len(lengths), 2), np.float32)
    with torch.no_grad():
        for a in range(0, len(order), block):
            rows = order[a: a + block]
            width = max(int(lengths[rows].max()), 1)
            tok = torch.from_numpy(np.ascontiguousarray(tokens[rows, :width])).to(dev)
            ln = torch.from_numpy(lengths[rows]).to(dev)
            out[rows] = forward(w, tok, ln, precision).cpu().numpy()
    return out
