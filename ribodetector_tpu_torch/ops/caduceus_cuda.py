"""Caduceus-Ph on the card: the kernel path of models/caduceus.py, around
csrc/caduceus_scan.cu.

Per layer of a micro-batch of N rows (reads of one rounded length and
their reverse complements) of width T:

    r  += h; u = RMSNorm(r) * g     [N, T, D] bf16      cad_add_norm_kernel
    xz  = u @ W_in                  [N, T, 2E] bf16     torch.matmul (cuBLAS)
    xc  = conv + SiLU, both dirs    [2, N, T, E] bf16   cad_conv_kernel
    dbc = xc @ W_x per direction    [2, N, T, 48] bf16  torch.matmul (cuBLAS)
    g   = scan, D skip and gate     [N, T, E] bf16      cad_scan_kernel
    h   = g @ W_out                 [N, T, D] bf16      torch.matmul (cuBLAS)

x_proj stays a cuBLAS product between the two kernels; the scan kernel
recomputes the conv in fp32 from the bf16 x and fuses dt's projection and
softplus, the scan, the D skip and the SiLU(z) gate (csrc/caduceus_scan.cu
says what bounds each kernel). h is the previous layer's output (none
before the first); after the last layer the add-norm kernel writes the
final norm in fp32, and the pool, head and conjoining run in torch.

Each kernel has its plain version in models/caduceus.py, imported here:
``conv_plain`` (cad_conv_kernel), ``scan_plain`` (cad_scan_kernel) and
``add_norm_plain`` (cad_add_norm_kernel); the
whole path's is ``caduceus_logits(compute_dtype=torch.bfloat16)``. A CPU
tensor takes the plain version; a CUDA tensor goes to the kernels or
raises. ``LAUNCH_COUNTS`` counts launches per (card, kernel).
"""

import collections
import ctypes
import math
import threading

import torch

from ribodetector_tpu_torch.models.caduceus import (  # noqa: F401 (the plain versions)
    EPS,
    CaduceusParams,
    add_norm_plain,
    caduceus_logits,
    clamp_lengths,
    conjoin,
    conv_plain,
    dims,
    pool_head,
    scan_plain,
    strands,
)
from ribodetector_tpu_torch.runtime.profiling import span

LAUNCH_COUNTS = collections.Counter()  # (card, "norm" | "conv" | "scan") -> launches
_launch_lock = threading.Lock()
LOG2E = 1.0 / math.log(2.0)


def launches(kernel=None):
    return sum(n for (_, k), n in LAUNCH_COUNTS.items() if kernel in (None, k))


def reset_launches():
    with _launch_lock:
        LAUNCH_COUNTS.clear()


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _check(lib, err, what):
    if err != 0:
        raise RuntimeError(f"caduceus {what} kernel launch failed: "
                           f"{lib.rd_cad_error_string(err).decode()} (cudaError {err})")


def _want(**tensors):
    """Each (tensor, dtype) on one CUDA device and contiguous, or raise:
    the kernels take raw pointers."""
    dev = None
    for name, (t, dtype) in tensors.items():
        if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} CUDA tensor "
                             f"(got {t.dtype} on {t.device}, contiguous={t.is_contiguous()})")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
        dev = t.device


def _count(dev, kernel):
    with _launch_lock:
        LAUNCH_COUNTS[dev.index, kernel] += 1


def conv_cuda(xz, lengths, conv_w, conv_b):
    """xz [N, T, 2E] bf16, lengths [N] int32, conv_w [2, E, 4], conv_b [2, E]
    fp32 (CUDA, contiguous) -> [2, N, T, E] bf16."""
    from ribodetector_tpu_torch.ops.build import caduceus_library

    N, T, E2 = xz.shape
    E = E2 // 2
    f32 = torch.float32
    _want(xz=(xz, torch.bfloat16), lengths=(lengths, torch.int32), conv_w=(conv_w, f32),
          conv_b=(conv_b, f32))
    if lengths.shape != (N,) or conv_w.shape != (2, E, 4) or conv_b.shape != (2, E):
        raise ValueError("conv: lengths [N], conv_w [2, E, 4], conv_b [2, E]")
    xc = torch.empty((2, N, T, E), dtype=torch.bfloat16, device=xz.device)
    lib = caduceus_library()
    stream = ctypes.c_void_p(torch.cuda.current_stream(xz.device).cuda_stream)
    _check(lib, lib.rd_cad_conv(_ptr(xz), _ptr(lengths), _ptr(conv_w), _ptr(conv_b),
                                _ptr(xc), N, T, E, stream), "conv")
    _count(xz.device, "conv")
    return xc


def scan_cuda(xz, dbc, lengths, conv_w, conv_b, w_dt, b_dt, a2, d):
    """The scan of both directions with the gate: xz [N, T, 2E] bf16, dbc
    [2, N, T, R + 2S] bf16, lengths [N] int32, conv_w [2, E, 4], conv_b,
    b_dt, d [2, E], w_dt [2, R, E], a2 [2, E, S] (-exp(A_log) log2 e), fp32
    (CUDA, contiguous) -> [N, T, E] bf16."""
    from ribodetector_tpu_torch.ops.build import caduceus_library

    N, T, E2 = xz.shape
    E = E2 // 2
    R, S = w_dt.shape[1], a2.shape[2]
    f32 = torch.float32
    _want(xz=(xz, torch.bfloat16), dbc=(dbc, torch.bfloat16), lengths=(lengths, torch.int32),
          conv_w=(conv_w, f32), conv_b=(conv_b, f32), w_dt=(w_dt, f32), b_dt=(b_dt, f32),
          a2=(a2, f32), d=(d, f32))
    if (dbc.shape != (2, N, T, R + 2 * S) or lengths.shape != (N,) or conv_w.shape != (2, E, 4)
            or w_dt.shape != (2, R, E) or a2.shape != (2, E, S)
            or not conv_b.shape == b_dt.shape == d.shape == (2, E)):
        raise ValueError("scan: dbc [2, N, T, R + 2S], lengths [N], conv_w [2, E, 4], "
                         "w_dt [2, R, E], a2 [2, E, S], conv_b, b_dt, d [2, E]")
    yf = torch.empty((N, T, E), dtype=torch.float32, device=xz.device)
    out = torch.empty((N, T, E), dtype=torch.bfloat16, device=xz.device)
    lib = caduceus_library()
    stream = ctypes.c_void_p(torch.cuda.current_stream(xz.device).cuda_stream)
    _check(lib, lib.rd_cad_scan(
        _ptr(xz), _ptr(dbc), _ptr(lengths), _ptr(conv_w), _ptr(conv_b), _ptr(w_dt),
        _ptr(b_dt), _ptr(a2), _ptr(d), _ptr(yf), _ptr(out), N, T, E, S, R, stream), "scan")
    _count(xz.device, "scan")
    return out


SCAN_INFO = ("registers", "local_bytes", "shared_bytes", "blocks_per_sm", "group", "chunk")


def scan_info():
    """The scan kernel as built (needs the card): registers and local
    (spilled) bytes a thread, static shared bytes a block, resident blocks
    an SM, the step group U (a row's last group runs up to U - 1 identity
    steps) and the staged chunk TC, keyed by SCAN_INFO."""
    from ribodetector_tpu_torch.ops.build import caduceus_library

    lib = caduceus_library()
    info = (ctypes.c_int * len(SCAN_INFO))()
    err = lib.rd_cad_scan_info(info)
    if err != 0:
        raise RuntimeError(f"caduceus scan info: {lib.rd_cad_error_string(err).decode()}")
    return dict(zip(SCAN_INFO, info))


def scan_arith_check():
    """Over every float32 input, how many give other bits from the scan
    kernel's branch-free softplus and SiLU than from the plain
    softplus(v) = v > 20 ? v : log1pf(__expf(v)) and SiLU the conv kernel
    computes: (softplus, silu) counts, both 0 when the scan's are the
    same functions."""
    from ribodetector_tpu_torch.ops.build import caduceus_library

    lib = caduceus_library()
    count = torch.zeros(2, dtype=torch.int64, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream(count.device).cuda_stream)
    _check(lib, lib.rd_cad_scan_check(_ptr(count), stream), "scan check")
    return tuple(count.tolist())


def add_norm_cuda(r, h, g, out_dtype=torch.bfloat16):
    """r [N, T, D] fp32 (r += h in place where h [N, T, D] bf16 is given),
    g [D] fp32 (CUDA, contiguous) -> RMSNorm(r) * g as out_dtype (bf16 or
    fp32)."""
    from ribodetector_tpu_torch.ops.build import caduceus_library

    D = r.shape[-1]
    M = r.numel() // D
    _want(r=(r, torch.float32), g=(g, torch.float32),
          **({} if h is None else {"h": (h, torch.bfloat16)}))
    if g.shape != (D,) or (h is not None and h.shape != r.shape):
        raise ValueError("add-norm: g [D], h as r")
    u = torch.empty(r.shape, dtype=out_dtype, device=r.device)
    lib = caduceus_library()
    stream = ctypes.c_void_p(torch.cuda.current_stream(r.device).cuda_stream)
    _check(lib, lib.rd_cad_add_norm(
        _ptr(r), None if h is None else _ptr(h), _ptr(g), _ptr(u), M, D,
        int(out_dtype == torch.float32), EPS, stream), "add-norm")
    _count(r.device, "norm")
    return u


def check_widths(p: CaduceusParams):
    c = dims(p)
    E = c["expand"] * c["d_model"]
    if (c["d_state"] != 16 or c["dt_rank"] != 16 or c["d_conv"] != 4 or E % 128
            or c["d_model"] != 256):
        raise ValueError(
            "the Caduceus kernels take d_model 256, d_state 16, dt_rank 16, d_conv 4 "
            f"and a multiple of 128 channels (got {c}); other widths run on the CPU")


def caduceus_logits_cuda(p: CaduceusParams, tokens, lengths):
    """[B, T] uint8 tokens and [B] lengths -> [B, 2] fp32 conjoined logits
    through the kernels, in the configuration's precision: bf16 operands
    of the three projections (fp32 accumulation in cuBLAS), fp32 conv,
    dt, scan state, exp and gate, fp32 residual and norms. A CPU tensor
    runs the plain version (caduceus_logits in bf16 precision)."""
    if tokens.dim() != 2:
        raise ValueError(f"tokens must be [B, T], got shape {tuple(tokens.shape)}")
    B, T = tokens.shape
    dev = tokens.device
    if B == 0:
        return torch.zeros((0, p.w_head.shape[1]), dtype=torch.float32, device=dev)
    if dev.type != "cuda":
        return caduceus_logits(p, tokens, lengths, torch.bfloat16)
    check_widths(p)
    for name, t in p._asdict().items():
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"params.{name} must be float32 on {dev} "
                             f"(got {t.dtype} on {t.device})")
    if lengths is None or lengths.shape != (B,):
        raise ValueError(f"the Caduceus needs lengths [B={B}]")
    lengths = clamp_lengths(tokens, lengths)
    ids, lengths2 = strands(tokens, lengths)
    lens32 = lengths2.to(torch.int32).contiguous()
    N = ids.shape[0]
    bf = torch.bfloat16
    r, h = p.embedding[ids], None  # [N, T, D] fp32
    for layer in range(p.w_in.shape[0]):
        u = add_norm_cuda(r, h, p.norm_g[layer])
        xz = torch.matmul(u, p.w_in[layer].to(bf))
        del u
        xc = conv_cuda(xz, lens32, p.conv_w[layer], p.conv_b[layer])
        E = xc.shape[-1]
        dbc = torch.bmm(xc.view(2, N * T, E), p.w_x[layer].to(bf)).view(2, N, T, -1)
        del xc
        a2 = (-torch.exp(p.a_log[layer]) * LOG2E).contiguous()
        with span("cad.scan"):
            g = scan_cuda(xz, dbc, lens32, p.conv_w[layer], p.conv_b[layer],
                          p.w_dt[layer], p.b_dt[layer], a2, p.d[layer])
        del xz, dbc
        h = torch.matmul(g, p.w_out[layer].to(bf))
        del g
    hid = add_norm_cuda(r, h, p.norm_f, torch.float32)
    return conjoin(pool_head(p, hid, lengths2))


def caduceus_classify(p: CaduceusParams, tokens, lengths, *, kernel="auto",
                      compute_dtype=torch.bfloat16):
    """The classify call of a Caduceus (ops.classify_logits routes here):
    on the card the kernel path, which computes in the configuration's
    precision and so takes compute_dtype bfloat16 only; on the CPU the
    plain forward in compute_dtype (float32: fp32 throughout; bfloat16:
    the configuration's precision). kernel is resolved as for the BiLSTM:
    "cuda" needs the card, "plain" the CPU."""
    on_card = tokens.device.type == "cuda"
    if kernel not in ("auto", "cuda", "plain"):
        raise ValueError(f"unknown kernel: {kernel}")
    if kernel == "cuda" and not on_card:
        raise ValueError("kernel='cuda' needs the card; the CPU runs kernel='plain'")
    if kernel == "plain" and on_card:
        raise ValueError("kernel='plain' on the card: a Caduceus runs its kernels there")
    if not on_card:
        return caduceus_logits(p, tokens, lengths, compute_dtype)
    if compute_dtype != torch.bfloat16:
        raise ValueError("a Caduceus on the card computes in its configuration's "
                         "precision: runtime.compute_dtype must be bfloat16 "
                         f"(got {compute_dtype})")
    return caduceus_logits_cuda(p, tokens, lengths)
