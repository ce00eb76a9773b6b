"""Caduceus-Ph read classifier: parameters, init, npz I/O and the plain
batched forward.

Source: Schiff et al., "Caduceus: Bi-Directional Equivariant Long-Range DNA
Sequence Modeling" (arXiv:2403.03234), published config
kuleshov-group/caduceus-ph_seqlen-131k_d_model-256_n_layer-16: d_model 256,
16 layers, vocabulary 16, each layer a bidirectional Mamba (strategy "add",
in- and out-projection tied across the two directions), d_state 16, d_conv
4, expand 2, dt_rank 16, RMSNorm (eps 1e-5), no RC-equivariance (the "Ph"
variant: reverse-complement conjoining at inference). The classifier adds
a mean pool over the read's own bases and a bias-free head d_model -> 2.

Per read of L bases (L = min(read length, -l)), tokens 0..3 = A C G T and
anything else inside the read (token 4: an N) = N:

    ids  = A 7, C 8, G 9, T 10, N 11 (the Caduceus character tokenizer)
    r    = E[ids]
    for each layer: u = RMSNorm(r) * g;  r = r + M_f(u) + rev(M_r(rev(u)))
    p    = mean over the L bases of RMSNorm_f(r);  logits = p @ W_head
    conjoined logits = (logits(read) + logits(reverse complement)) / 2

rev reverses a read's own L positions. One Mamba M(u), with [x, z] =
u @ W_in (tied), per direction its causal depthwise conv (width 4) and SiLU,
[delta, B, C] = x' @ W_x, dt = softplus(delta @ W_dt + b_dt), A =
-exp(A_log), the selective scan H_t = exp(dt A) H_{t-1} + (dt x'_t) B_t,
y_t = H_t C_t + D x'_t, and out = (y * SiLU(z)) @ W_out (tied). Both
directions share u @ W_in and one product with W_out: the output is
((y_f + rev(y_r)) * SiLU(z)) @ W_out.

In the original coordinates the reverse direction's conv looks ahead:
x'_r[s] = SiLU(b + sum_k w_k x[s + 3 - k]), with x = 0 at and past the
read's end, and its scan runs from the read's last base down to its first.
So both directions run on one [rows, T] layout without moving any data,
and padding past a read's end never reaches its bases.

Layout (stacked over layers; direction 0 forward, 1 reverse):

  embedding [V, D]        norm_g [n, D]        w_in  [n, D, 2E]
  conv_w    [n, 2, E, K]  conv_b [n, 2, E]     w_x   [n, 2, E, R + 2S]
  w_dt      [n, 2, R, E]  b_dt   [n, 2, E]     a_log [n, 2, E, S]
  d         [n, 2, E]     w_out  [n, E, D]     norm_f [D]    w_head [D, 2]

``caduceus_logits`` is the plain forward: in float32 the CPU classify path;
with compute_dtype=torch.bfloat16 the configuration's precision (bf16
operands of the three projections, fp32 accumulation, everything else
fp32), the plain version of the kernel path (ops/caduceus_cuda.py).
"""

import json
import math
from typing import NamedTuple

import numpy as np
import torch

ARCH = "CaduceusParams"
PAD_ID = 4  # the tokenizer's [PAD], at positions past a read's end
N_ID = 11
EPS = 1e-5
# the configuration's published widths (config.json of the Hugging Face
# model), the defaults of init_params
PUBLISHED = {"d_model": 256, "n_layer": 16, "vocab_size": 16, "d_state": 16,
             "d_conv": 4, "expand": 2, "dt_rank": 16, "num_classes": 2}


class CaduceusParams(NamedTuple):
    embedding: torch.Tensor  # [V, D]
    norm_g: torch.Tensor  # [n, D]
    w_in: torch.Tensor  # [n, D, 2E]
    conv_w: torch.Tensor  # [n, 2, E, K]
    conv_b: torch.Tensor  # [n, 2, E]
    w_x: torch.Tensor  # [n, 2, E, R + 2S]
    w_dt: torch.Tensor  # [n, 2, R, E]
    b_dt: torch.Tensor  # [n, 2, E]
    a_log: torch.Tensor  # [n, 2, E, S]
    d: torch.Tensor  # [n, 2, E]
    w_out: torch.Tensor  # [n, E, D]
    norm_f: torch.Tensor  # [D]
    w_head: torch.Tensor  # [D, 2]


def dims(params: CaduceusParams) -> dict:
    """The configuration's widths, read from the parameters' shapes."""
    n, _, E, S = params.a_log.shape
    R = params.w_dt.shape[2]
    return {"d_model": params.embedding.shape[1], "n_layer": n,
            "vocab_size": params.embedding.shape[0], "d_state": S,
            "d_conv": params.conv_w.shape[3], "expand": E // params.embedding.shape[1],
            "dt_rank": R, "num_classes": params.w_head.shape[1]}


def init_params(generator, cfg=None, device="cpu") -> CaduceusParams:
    """Random weights as the published code initialises them, drawn from
    `generator` (a CPU torch.Generator) in field order on the CPU.

    mamba_ssm Mamba.__init__: A_log = log(1..S) on every channel; D = 1;
    dt_proj's weight uniform +-dt_rank^-0.5 and its bias the inverse
    softplus of dt drawn log-uniform in [1e-3, 1e-1] and floored at 1e-4;
    in_proj, x_proj and the conv as nn.Linear / nn.Conv1d's defaults
    (uniform +-1/sqrt(fan_in), the conv's fan-in its width). Caduceus
    _init_weights: the embedding N(0, 0.02); out_proj re-drawn uniform
    +-1/sqrt(fan_in) and divided by sqrt(n_layer). The norms' weights are 1,
    the head N(0, 0.02) (assumed: the published model has no head)."""
    c = dict(PUBLISHED, **(cfg or {}))
    D, n, V, S, K = c["d_model"], c["n_layer"], c["vocab_size"], c["d_state"], c["d_conv"]
    E, R, C = c["expand"] * D, c["dt_rank"], c["num_classes"]
    g = generator

    def uniform(shape, bound):
        return (torch.rand(shape, generator=g, dtype=torch.float64) * 2 - 1) * bound

    def normal(shape, std):
        return torch.randn(shape, generator=g, dtype=torch.float64) * std

    dt = torch.exp(torch.rand((n, 2, E), generator=g, dtype=torch.float64)
                   * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3)).clamp(min=1e-4)
    fields = {
        "embedding": normal((V, D), 0.02),
        "norm_g": torch.ones(n, D, dtype=torch.float64),
        "w_in": uniform((n, D, 2 * E), 1 / math.sqrt(D)),
        "conv_w": uniform((n, 2, E, K), 1 / math.sqrt(K)),
        "conv_b": uniform((n, 2, E), 1 / math.sqrt(K)),
        "w_x": uniform((n, 2, E, R + 2 * S), 1 / math.sqrt(E)),
        "w_dt": uniform((n, 2, R, E), R ** -0.5),
        "b_dt": dt + torch.log(-torch.expm1(-dt)),
        "a_log": torch.log(torch.arange(1, S + 1, dtype=torch.float64)).expand(n, 2, E, S),
        "d": torch.ones(n, 2, E, dtype=torch.float64),
        "w_out": uniform((n, E, D), 1 / math.sqrt(E)) / math.sqrt(n),
        "norm_f": torch.ones(D, dtype=torch.float64),
        "w_head": normal((D, C), 0.02),
    }
    return CaduceusParams(**{k: v.to(torch.float32).contiguous().to(device)
                             for k, v in fields.items()})


def param_count(params: CaduceusParams) -> int:
    return sum(p.numel() for p in params)


def save_params(path, params: CaduceusParams, meta: dict | None = None):
    """The npz artifact: one fp32 array per field and ``_meta_json`` naming
    the arch ("arch": "CaduceusParams") and its widths."""
    arrays = {k: v.detach().cpu().numpy().astype(np.float32)
              for k, v in params._asdict().items()}
    meta = {**(meta or {}), "arch": ARCH, "config": dims(params)}
    arrays["_meta_json"] = np.frombuffer(json.dumps(meta, default=str).encode("utf-8"),
                                         dtype=np.uint8)
    np.savez(path, **arrays)


def load_params(path, device="cpu") -> CaduceusParams:
    with np.load(path) as z:
        return CaduceusParams(**{
            k: torch.from_numpy(np.array(z[k], np.float32)).to(device)
            for k in CaduceusParams._fields})


# ---------------------------------------------------------------- forward


def read_ids(tokens, lengths):
    """[B, T] port tokens (0..3 = A C G T, 4 = anything else), lengths [B]
    -> [B, T] int64 tokenizer ids: 7..10 for the bases, 11 for an N inside
    the read, PAD_ID past its end."""
    T = tokens.shape[1]
    t = tokens.long()
    ids = torch.where(t < 4, t + 7, N_ID)
    inside = torch.arange(T, device=tokens.device)[None, :] < lengths[:, None]
    return torch.where(inside, ids, PAD_ID)


def reverse_complement(tokens, lengths):
    """Each read's reverse complement on its own L positions (A<->T,
    C<->G, token 4 stays 4), padding left past L: made where the tokens
    lie, by one gather."""
    T = tokens.shape[1]
    pos = torch.arange(T, device=tokens.device)[None, :]
    lengths = lengths.long()[:, None]
    src = torch.where(pos < lengths, lengths - 1 - pos, pos)
    t = torch.gather(tokens, 1, src)
    return torch.where(t < 4, 3 - t.long(), t.long()).to(tokens.dtype)


def rms_norm(r, g):
    return r * torch.rsqrt(r.pow(2).mean(-1, keepdim=True) + EPS) * g


def _round(x, dtype):
    """A projection's operand as the configuration computes it: rounded to
    bf16 and summed in fp32 (identity in fp32)."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def conv_plain(xz, lengths, conv_w, conv_b):
    """Both directions' depthwise conv and SiLU of the x half of xz [N, T,
    2E], in the original coordinates (the forward direction causal, the
    reverse one looking ahead), x = 0 before 0 and past each row's length
    -> [2, N, T, E] fp32, zero past the length. The plain version of the
    conv kernel (ops/caduceus_cuda.py)."""
    N, T, E2 = xz.shape
    E = E2 // 2
    K = conv_w.shape[-1]
    inside = (torch.arange(T, device=xz.device)[None, :] < lengths[:, None])[..., None]
    x = torch.where(inside, xz[..., :E].float(), 0.0)
    pad = torch.zeros(N, K - 1, E, dtype=x.dtype, device=x.device)
    xf = torch.cat([pad, x], dim=1)
    xr = torch.cat([x, pad], dim=1)
    f = sum(conv_w[0, :, k] * xf[:, k: k + T] for k in range(K))
    r = sum(conv_w[1, :, k] * xr[:, K - 1 - k: K - 1 - k + T] for k in range(K))
    xc = torch.nn.functional.silu(torch.stack([f, r]) + conv_b[:, None, None, :])
    return torch.where(inside, xc, 0.0)


def scan_plain(xz, dbc, xc, lengths, w_dt, b_dt, a_log, d):
    """Both directions' dt, selective scan and D skip, and the gate, plain:
    xz [N, T, 2E] (z its second half), dbc [2, N, T, R + 2S] (x_proj's
    [delta, B, C]), xc [2, N, T, E] (conv_plain) -> [N, T, E] fp32 =
    (y_f + y_r) * SiLU(z), zero past each row's length. The forward
    direction runs t = 0..L-1, the reverse one t = L-1..0, from zero state.
    The plain version of the scan kernel."""
    N, T, E2 = xz.shape
    E = E2 // 2
    R, S = w_dt.shape[1], a_log.shape[2]
    delta, B, C = dbc.float().split([R, S, S], dim=-1)
    dt = torch.nn.functional.softplus(delta @ w_dt[:, None] + b_dt[:, None, None, :])
    A = -torch.exp(a_log)[:, None]  # [2, 1, E, S]
    H = torch.zeros(2, N, E, S, dtype=torch.float32, device=xz.device)
    y = torch.zeros(2, N, T, E, dtype=torch.float32, device=xz.device)
    rows = torch.arange(N, device=xz.device)
    two = torch.arange(2, device=xz.device)
    for i in range(T):
        t = torch.tensor([i, T - 1 - i], device=xz.device)
        live = (t[:, None] < lengths[None, :])[..., None, None]
        dt_t, x_t = dt[two, :, t], xc[two, :, t]  # [2, N, E]
        Hn = torch.exp(dt_t[..., None] * A) * H + (dt_t * x_t)[..., None] * B[two, :, t][:, :, None]
        H = torch.where(live, Hn, H)
        y_t = (H * C[two, :, t][:, :, None]).sum(-1) + d[:, None] * x_t
        y[0, rows, i] = y_t[0]
        y[1, rows, T - 1 - i] = y_t[1]
    inside = (torch.arange(T, device=xz.device)[None, :] < lengths[:, None])[..., None]
    g = (y[0] + y[1]) * torch.nn.functional.silu(xz[..., E:].float())
    return torch.where(inside, g, 0.0)


def add_norm_plain(r, h, g):
    """The residual add and RMSNorm between the layers, plain: (r + h, or r
    where h is None, and its RMSNorm times g), fp32. The plain version of
    the add-norm kernel."""
    if h is not None:
        r = r + h.float()
    return r, rms_norm(r, g)


def caduceus_hidden(p: CaduceusParams, ids, lengths, compute_dtype=torch.float32):
    """[N, T] ids -> the final RMSNorm's output [N, T, D], plain."""
    r, h = p.embedding[ids], None
    for layer in range(p.w_in.shape[0]):
        r, u = add_norm_plain(r, h, p.norm_g[layer])
        xz = _round(_round(u, compute_dtype) @ _round(p.w_in[layer], compute_dtype),
                    compute_dtype)
        xc = conv_plain(xz, lengths, p.conv_w[layer], p.conv_b[layer])
        dbc = _round(_round(xc, compute_dtype)
                     @ _round(p.w_x[layer], compute_dtype)[:, None], compute_dtype)
        g = scan_plain(xz, dbc, xc, lengths, p.w_dt[layer], p.b_dt[layer],
                       p.a_log[layer], p.d[layer])
        h = _round(_round(g, compute_dtype) @ _round(p.w_out[layer], compute_dtype),
                   compute_dtype)
    return add_norm_plain(r, h, p.norm_f)[1]


def pool_head(p: CaduceusParams, hid, lengths):
    """Mean over each row's own L positions (zero for L = 0), then the
    head: [N, T, D] -> [N, C]."""
    T = hid.shape[1]
    inside = (torch.arange(T, device=hid.device)[None, :] < lengths[:, None])[..., None]
    pooled = torch.where(inside, hid, 0.0).sum(1) / lengths.clamp(min=1)[:, None].float()
    return pooled @ p.w_head


def strands(tokens, lengths):
    """[B, T] tokens -> ([2B, T] ids of the reads then of their reverse
    complements, [2B] lengths)."""
    rc = reverse_complement(tokens, lengths)
    both = torch.cat([tokens, rc])
    lengths2 = torch.cat([lengths, lengths])
    return read_ids(both, lengths2), lengths2


def conjoin(logits):
    """[2B, C] logits of the reads then of their reverse complements ->
    [B, C], Caduceus-Ph's post-hoc conjoining (the mean of the two)."""
    B = logits.shape[0] // 2
    return 0.5 * (logits[:B] + logits[B:])


def clamp_lengths(tokens, lengths):
    T = tokens.shape[1]
    return lengths.to(device=tokens.device, dtype=torch.int64).clamp(0, T)


def caduceus_logits(p: CaduceusParams, tokens, lengths, compute_dtype=torch.float32):
    """[B, T] uint8 tokens, [B] lengths -> [B, C] fp32 conjoined logits,
    plain (see the module's docstring). Rows of no bases (a call's padding
    rows) have zero logits by definition and are not computed, nor are
    the positions past the longest read."""
    lengths = clamp_lengths(tokens, lengths)
    live = lengths > 0
    if not bool(live.all()) or not len(live):
        out = torch.zeros((tokens.shape[0], p.w_head.shape[1]), dtype=torch.float32,
                          device=tokens.device)
        if bool(live.any()):
            out[live] = caduceus_logits(p, tokens[live], lengths[live], compute_dtype)
        return out
    tokens = tokens[:, : int(lengths.max())]
    ids, lengths2 = strands(tokens, lengths)
    hid = caduceus_hidden(p, ids, lengths2, compute_dtype)
    return conjoin(pool_head(p, hid, lengths2))


def bytes_per_token(p: CaduceusParams) -> int:
    """Device bytes one [row, position] of a micro-batch holds at once at
    most in the kernel path: the fp32 residual and a norm's temporary, the
    bf16 norm output, in-projection output, both directions' conv outputs
    and x_proj outputs, the fp32 forward-scan scratch, the bf16 gated output
    and out-projection output."""
    c = dims(p)
    D, E = c["d_model"], c["expand"] * c["d_model"]
    P = c["dt_rank"] + 2 * c["d_state"]
    return 4 * D + 4 * D + 2 * D + 2 * 2 * E + 2 * 2 * E + 2 * 2 * P + 4 * E + 2 * E + 2 * D


ACTIVATION_BYTES = 8 << 30


def micro_rows(p: CaduceusParams, T: int) -> int:
    """Reads a micro-batch of width T holds: its two strands' rows at
    bytes_per_token each position fit ACTIVATION_BYTES (8 GiB: one
    micro-batch's activations at a time on a card). The Predictor's
    classify step asks it at each micro-batch's own width, its longest
    read rounded up (micro_batches), not at the bucket's."""
    return max(1, ACTIVATION_BYTES // (bytes_per_token(p) * 2 * max(T, 1)))


# a micro-batch's width is its longest read rounded up to a multiple of this
WIDTH_STEP = 16


def micro_batches(p: CaduceusParams, lengths, T: int):
    """A call's reads, longest first (lengths [n], each in [1, T]), cut into
    micro-batches [(a, b, W)]: reads [a, b) at width W, the longest one's
    length rounded up to WIDTH_STEP and at most T. A micro-batch holds at
    most micro_rows(p, W) reads and ends before the first read whose own
    rounded width is smaller, so every read runs at its own width."""
    lengths = np.asarray(lengths, np.int64)
    widths = np.minimum(T, -(-lengths // WIDTH_STEP) * WIDTH_STEP)
    cuts, a = [], 0
    while a < len(widths):
        W = int(widths[a])
        end = int(np.searchsorted(-widths, -W, side="right"))
        b = min(end, a + micro_rows(p, W))
        cuts.append((a, b, W))
        a = b
    return cuts
