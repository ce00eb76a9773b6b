#!/usr/bin/env python3
"""Smoke test of ribodetector_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py            # the whole check (needs one CUDA card)
    python3 chip_smoke.py --quick    # build + kernel checks at a small batch

Phases, one JSON line each; any failure exits non-zero:

  env       torch / CUDA versions and the card's name and power limit
  build     csrc/bilstm.cu (nvcc, sm_90a) and native/fastx.cpp (g++), from
            the checkout's sources, built concurrently into _build/
  kernels   each of the four CUDA kernels (exact, high, fast, fast_bf16)
            against its plain torch version on the card (real weights,
            B = 16384+37, three settings), high against exact under the
            startup probe's gate, the fast kernels' flips against exact
            (information, not a gate), and the fast plain versions' times
  timing    kernel and plain times, the bound, and the cuDNN LSTM yardstick
            (fp32 for exact/high, bf16 for the fast kernels) at B=262144,
            T=100
  main      the CLI main path (paired gz, -l 100, -e both) over 2 x 262144
            reads with a cleared parity-marker cache, its partition checked
            read for read against the plain exact labels on the card, and
            each kernel's launch count in that run (--profile logs the
            stage breakdown on stderr)
  serve     the JSONL job server (serve.main, --precision fast,
            --concurrency 2) over a 2 x 262144-read paired gz job, the same
            job again (memo reuse), a malformed line, a single-end job of
            40-99 bp reads with N calls and an -e norrna job; every job's
            partition checked against the fast kernel called directly
  config    the bf16 config (runtime.compute_dtype=bfloat16, the fast_bf16
            kernel) and the portable runner (runtime.native=false), each a
            CLI run over 2 x 16384 pairs checked against plain exact labels
  trace     the main path again under --trace-dir: the card's busy share of
            the run's wall time, read from the torch.profiler trace

The last line is {"ok": true, "device": {...}}. The script imports nothing
of the JAX package.
"""

import copy
import gzip
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
NPZ = os.path.join(REPO, "ribodetector_tpu_torch", "data", "ribodetector_v1.npz")
KERNEL_SOURCE = "ribodetector_tpu_torch/csrc/bilstm.cu"
REPLACES = {
    "exact": "ribodetector_tpu/ops/lstm_pallas.py:224",  # _kernel ("x6")
    "high": "ribodetector_tpu/ops/lstm_pallas.py:116",  # _kernel_x3cat
    "fast": "ribodetector_tpu/ops/lstm_pallas.py:224",  # _kernel ("x1", fp32)
    "fast_bf16": "ribodetector_tpu/ops/lstm_pallas.py:224",  # _kernel ("x1", bf16)
}
MODES = ("exact", "high", "fast", "fast_bf16")
# published H100 SXM peaks (NVIDIA data sheet, dense, at a 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12
H = 128
G = 4 * H
LIB_CHUNK = 16384  # reads per cuDNN call of the library yardstick


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_time_ms(fn, reps):
    """Mean device time of fn() over reps calls (after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_tokens(rng, B, T):
    """Token rows with pads after a random length, plus all-pad rows."""
    tok = rng.integers(0, 4, (B, T)).astype(np.uint8)
    lengths = rng.integers(1, T + 1, B).astype(np.int32)
    tok[np.arange(T)[None, :] >= lengths[:, None]] = 4
    tok[rng.random((B, T)) < 0.02] = 4  # interior N calls
    allpad = rng.random(B) < 0.01
    tok[allpad] = 4
    lengths[allpad] = 0
    return tok, lengths


def compare(got, ref):
    """max-abs, argmax flips, and flips at reference margins >= 1e-4/5e-3."""
    flipped = got.argmax(1) != ref.argmax(1)
    margin = np.abs(ref[:, 1] - ref[:, 0])
    return {
        "max_abs": float(np.abs(got - ref).max()),
        "flips": int(flipped.sum()),
        "flips_m1e-4": int(flipped[margin >= 1e-4].sum()),
        "flips_m5e-3": int(flipped[margin >= 5e-3].sum()),
    }


def phase_env():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi)
    return smi


def phase_build():
    from ribodetector_tpu_torch.ops import build

    def timed(fn):
        t0 = time.perf_counter()
        path, log = fn()
        return path, log, time.perf_counter() - t0

    # one compiler per source, all started together
    with ThreadPoolExecutor(2) as ex:
        fk = ex.submit(timed, build.build_kernels)
        ff = ex.submit(timed, build.build_fastx)
        kpath, klog, ks = fk.result()
        fpath, _, fs = ff.result()
    ptxas = [l.strip() for l in klog.splitlines()
             if "registers" in l or "spill" in l or "Compiling entry" in l]
    emit("build", kernels=os.path.relpath(kpath, REPO), kernels_s=round(ks, 3),
         fastx=os.path.relpath(fpath, REPO), fastx_s=round(fs, 3), ptxas=ptxas)


def phase_kernels(params, quick):
    import torch

    from ribodetector_tpu_torch.models.bilstm import zero_prefix_state
    from ribodetector_tpu_torch.ops.lstm_cuda import PLAIN, bilstm_logits_cuda

    dev = params.w_hh_f.device
    rng = np.random.default_rng(7)
    B = (4096 if quick else 16384) + 37  # ragged last tile
    # the backward-carry init as the pipeline builds it: the scan in the
    # run's compute dtype (bf16 for the bf16 config's fast_bf16 kernel)
    init36 = zero_prefix_state(params, 36)
    init36_bf16 = zero_prefix_state(params, 36, compute_dtype=torch.bfloat16)
    settings = [("T100_dense", 100, "dense", False),
                ("T64_dense_bwd36", 64, "dense", True),
                ("T100_packed", 100, "packed", False)]
    max_err = {mode: 0.0 for mode in MODES}
    plain_ms = {}
    with torch.no_grad():
        for name, T, sem, with_init in settings:
            tok_np, len_np = random_tokens(rng, B, T)
            tok = torch.from_numpy(tok_np).to(dev)
            lens = torch.from_numpy(len_np).to(dev)
            out = {}
            for mode in MODES:
                bwd = None
                if with_init:
                    bwd = init36_bf16 if mode == "fast_bf16" else init36
                got = bilstm_logits_cuda(params, tok, lens, semantics=sem,
                                         mode=mode, bwd_init=bwd)
                torch.cuda.synchronize()
                ref = PLAIN[mode](params, tok, lens, semantics=sem, bwd_init=bwd)
                got, ref = got.cpu().numpy(), ref.cpu().numpy()
                check(got.shape == (B, 2) and np.isfinite(got).all(),
                      f"{mode} {name}: shape {got.shape} or non-finite logits")
                r = compare(got, ref)
                emit("kernels", kernel=mode, setting=name, B=B, vs="plain", **r)
                check(r["max_abs"] <= 1e-4 and r["flips_m1e-4"] == 0,
                      f"{mode} kernel disagrees with its plain version: {r}")
                max_err[mode] = max(max_err[mode], r["max_abs"])
                out[mode] = got
                if mode.startswith("fast") and name == "T100_dense":
                    # the fast plain versions sum in the kernel's order, one
                    # elementwise op per product: timed once, at this B
                    plain_ms[mode] = cuda_time_ms(
                        lambda: PLAIN[mode](params, tok, semantics="dense"), 1)
            r = compare(out["high"], out["exact"])
            gate = r["flips_m5e-3"] == 0 and r["flips"] <= max(2, 1e-4 * B)
            emit("kernels", kernel="high", setting=name, B=B, vs="exact",
                 probe_gate=gate, **r)
            check(gate, f"high vs exact fails the probe gate: {r}")
            for mode in ("fast", "fast_bf16"):
                # what a user of the fast modes gives up: not a gate
                r = compare(out[mode], out["exact"])
                margin = np.abs(out["exact"][:, 1] - out["exact"][:, 0])
                flipped = out[mode].argmax(1) != out["exact"].argmax(1)
                emit("kernels", kernel=mode, setting=name, B=B, vs="exact",
                     max_flip_margin=float(margin[flipped].max(initial=0.0)), **r)
    return max_err, {"plain_ms": plain_ms, "plain_B": B}


def phase_timing(params, quick, fast_plain):
    """Times at the main path's full device call: 2 x 131072 reads, T=100."""
    import torch

    from ribodetector_tpu_torch.models.bilstm import head
    from ribodetector_tpu_torch.ops.lstm_cuda import PLAIN, bilstm_logits_cuda

    dev = params.w_hh_f.device
    B, T = (16384 if quick else 262144), 100
    rng = np.random.default_rng(11)
    tok_np, _ = random_tokens(rng, B, T)
    tok = torch.from_numpy(tok_np).to(dev)
    res = {}
    with torch.no_grad():
        for mode in MODES:
            res[mode] = {"ms": cuda_time_ms(
                lambda: bilstm_logits_cuda(params, tok, semantics="dense",
                                           mode=mode), 3)}
        for mode in ("exact", "high"):
            # the plain high version sums in the kernel's order, one
            # elementwise op per product: slow by design, timed once
            res[mode]["plain_ms"] = cuda_time_ms(
                lambda: PLAIN[mode](params, tok, semantics="dense"),
                2 if mode == "exact" else 1)
            res[mode]["plain_B"] = B
        for mode in ("fast", "fast_bf16"):
            res[mode]["plain_ms"] = fast_plain["plain_ms"][mode]
            res[mode]["plain_B"] = fast_plain["plain_B"]
        # yardstick: cuDNN's LSTM on the same one-hot batch, plus the dense
        # gather and the head; fp32 (TF32 off) beside exact and high, bf16
        # beside the fast kernels; the port never calls it
        torch.backends.cudnn.allow_tf32 = False
        lstm = torch.nn.LSTM(4, H, 1, batch_first=True, bidirectional=True).to(dev)
        lstm.weight_ih_l0.copy_(params.w_ih_f.T)
        lstm.weight_hh_l0.copy_(params.w_hh_f.T)
        lstm.bias_ih_l0.copy_(params.b_f)
        lstm.bias_hh_l0.zero_()
        lstm.weight_ih_l0_reverse.copy_(params.w_ih_b.T)
        lstm.weight_hh_l0_reverse.copy_(params.w_hh_b.T)
        lstm.bias_ih_l0_reverse.copy_(params.b_b)
        lstm.bias_hh_l0_reverse.zero_()
        lstm_bf16 = copy.deepcopy(lstm).to(torch.bfloat16)
        # one cuDNN call over all B reads asks for ~378 GiB of workspace, so
        # the yardstick runs in calls of at most LIB_CHUNK reads
        onehot = torch.nn.functional.one_hot(tok.long(), 5)[..., :4].float()
        nb = min(B, LIB_CHUNK)
        rows = torch.arange(nb, device=dev)

        def library(net, dtype):
            h0 = torch.zeros((2, nb, H), device=dev, dtype=dtype)
            logits = []
            for i in range(0, B, nb):
                x = onehot[i: i + nb]
                out, _ = net(x.to(dtype), (h0, h0))
                g = T - 1 - x.sum(2).flip(1).argmax(1)
                logits.append(head(params, out[rows, g].float()))
            return torch.cat(logits)

        lib_ms = {"fp32": cuda_time_ms(lambda: library(lstm, torch.float32), 2),
                  "bf16": cuda_time_ms(lambda: library(lstm_bf16, torch.bfloat16), 2)}
        # agreement of each yardstick with the exact kernel (sanity only)
        exact = bilstm_logits_cuda(params, tok, semantics="dense", mode="exact")
        lib_err = {"fp32": float((library(lstm, torch.float32) - exact).abs().max()),
                   "bf16": float((library(lstm_bf16, torch.bfloat16) - exact).abs().max())}
        del onehot, exact
        torch.cuda.empty_cache()
    # least time: bytes each input read once and the output written once
    # (tokens, gather, weights in; last_out [B, 256] fp32 out), against the
    # multiply-adds at the peak rate of their type: fp32 for exact, bf16
    # tensor cores for high's limbs and the fast modes' single pass
    nbytes = B * T + 4 * B + 4 * (2 * H * G + 2 * 5 * G) + 4 * B * 2 * H
    flops = 2.0 * 2 * T * G * H * B
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = {"exact": 1e3 * flops / FP32_FLOPS,
              "high": 1e3 * 3 * flops / BF16_TC_FLOPS,
              "fast": 1e3 * flops / BF16_TC_FLOPS,
              "fast_bf16": 1e3 * flops / BF16_TC_FLOPS}
    for mode in MODES:
        lib = "bf16" if mode.startswith("fast") else "fp32"
        res[mode]["library_ms"] = lib_ms[lib]
        res[mode]["bound_ms"] = max(bytes_ms, ops_ms[mode])
        res[mode]["bound_by"] = "bytes" if bytes_ms >= ops_ms[mode] else "operations"
        emit("timing", kernel=mode, B=B, T=T, library=f"cudnn_{lib}",
             library_err=lib_err[lib], library_calls=-(-B // LIB_CHUNK),
             bytes_ms=bytes_ms, ops_ms=ops_ms[mode],
             fp32_cuda_core_ms=1e3 * flops / FP32_FLOPS, **res[mode])
    return res


def write_pairs(dirname, n, rng, prefix="in"):
    """Paired gz FASTQ: most pairs clean 100 bp (the 2-bit lane), the rest
    40-99 bp (the 64 bucket or the base-5 lane) or with N / lowercase."""
    L = 100
    bases = np.frombuffer(b"ACGT", np.uint8)
    paths, seqs_all = [], []
    for side in (1, 2):
        mat = bases[rng.integers(0, 4, (n, L))]
        kind = rng.random(n)
        lengths = np.full(n, L)
        short = kind < 0.08
        lengths[short] = rng.integers(40, L, short.sum())
        withn = (kind >= 0.08) & (kind < 0.11)
        mat[withn, rng.integers(0, L, withn.sum())] = ord("N")
        lower = (kind >= 0.11) & (kind < 0.13)
        mat[lower, :10] = mat[lower, :10] + 32
        seqs = [mat[i, : lengths[i]].tobytes() for i in range(n)]
        path = os.path.join(dirname, f"{prefix}_{side}.fq.gz")
        with open(path, "wb") as fh:
            fh.write(gzip.compress(fastq(seqs), compresslevel=1))
        paths.append(path)
        seqs_all.append([s.decode() for s in seqs])
    return paths, seqs_all


def write_single(dirname, n, rng):
    """Single-end plain FASTQ of 40-99 bp reads, 10% of them with N calls
    (interior or trailing): the 64 bucket, the 100 bucket and the base-5
    lane, none of it on the 2-bit lane."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    mat = bases[rng.integers(0, 4, (n, 99))]
    lengths = rng.integers(40, 100, n)
    withn = np.flatnonzero(rng.random(n) < 0.1)
    mat[withn, rng.integers(0, 40, withn.size)] = ord("N")
    trailing = withn[: withn.size // 2]
    for i in trailing:
        mat[i, lengths[i] - 5: lengths[i]] = ord("N")
    seqs = [mat[i, : lengths[i]].tobytes() for i in range(n)]
    path = os.path.join(dirname, "single.fq")
    with open(path, "wb") as fh:
        fh.write(fastq(seqs))
    return path, [s.decode() for s in seqs]


def fastq(seqs):
    return b"".join(
        b"@r%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s)) for i, s in enumerate(seqs)
    )


def read_indices(path):
    op = gzip.open if path.endswith("gz") else open
    with op(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    return np.array([int(l[2:]) for l in lines[0::4] if l], np.int64)


def read_partition(files, n):
    """{label: [file per side]} -> [n] label of each read (pair) by its
    index, checking input order, R1/R2 alignment and that every read was
    written exactly once."""
    got = np.full(n, -9, np.int64)
    for label, paths in files.items():
        idx = [read_indices(f) for f in paths]
        for other in idx[1:]:
            check(np.array_equal(idx[0], other), f"R1/R2 outputs out of step in {paths[0]}")
        check(np.all(np.diff(idx[0]) > 0), f"{paths[0]} is not in input order")
        check(np.all(got[idx[0]] == -9), f"reads written twice ({paths[0]})")
        got[idx[0]] = label
    check(np.all(got != -9), "some reads were not written")
    return got


def outputs(dirname, tag, paired, ensure):
    """(argv for -o/-r, {label: files}); norrna outputs gz, rrna plain."""
    sides = (1, 2) if paired else (1,)
    norrna = [os.path.join(dirname, f"{tag}_norrna_{s}.fq.gz") for s in sides]
    rrna = [os.path.join(dirname, f"{tag}_rrna_{s}.fq") for s in sides]
    files = {0: norrna, 1: rrna}
    if paired and ensure == "both":
        files[-1] = [f + ".unclassified.gz" for f in norrna]
    return ["-o", *norrna, "-r", *rrna], files


def side_logits(params, seqs, fn):
    """[n, 2] logits of fn(params, tokens) over reads encoded at T=100 on
    the card, in calls of 65536 reads."""
    import torch

    from ribodetector_tpu_torch.encode import encode_batch

    tok, _ = encode_batch(seqs, 100)
    dev = params.w_hh_f.device
    with torch.no_grad():
        return np.concatenate([
            fn(params, torch.from_numpy(tok[i: i + 65536]).to(dev)).cpu().numpy()
            for i in range(0, len(seqs), 65536)
        ])


def exact_logits(params, tokens):
    from ribodetector_tpu_torch.models.bilstm import bilstm_logits

    return bilstm_logits(params, tokens, semantics="dense")


def fast_logits(params, tokens):
    from ribodetector_tpu_torch.ops.lstm_cuda import bilstm_logits_cuda

    return bilstm_logits_cuda(params, tokens, semantics="dense", mode="fast")


def margin_of(*logits):
    """The smallest logit margin over the given ends."""
    return np.min([np.abs(l[:, 1] - l[:, 0]) for l in logits], axis=0)


def run_cli(argv):
    """cli.main on argv -> (wall seconds, launches per kernel in the run)."""
    import torch

    from ribodetector_tpu_torch.cli import main as cli_main
    from ribodetector_tpu_torch.ops import lstm_cuda

    lstm_cuda.reset_launches()
    t0 = time.perf_counter()
    cli_main(argv)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, dict(lstm_cuda.LAUNCHES)


def phase_main(params, tmp, n=262144):
    from ribodetector_tpu_torch.runtime.ensure import paired_final_labels

    rng = np.random.default_rng(3)
    t0 = time.perf_counter()
    inputs, seqs = write_pairs(tmp, n, rng)
    gen_s = time.perf_counter() - t0

    # reference: plain exact labels on the card over the same reads
    logits = [side_logits(params, side, exact_logits) for side in seqs]
    want = paired_final_labels(logits[0], logits[1], "both")
    margin = margin_of(*logits)

    # a fresh parity-marker cache, so the startup probe really runs
    os.environ["RIBODETECTOR_TPU_TORCH_CACHE"] = os.path.join(tmp, "cache")
    out, files = outputs(tmp, "main", True, "both")
    wall, launches = run_cli(["-l", "100", "-i", *inputs, *out, "-e", "both",
                              "--profile"])
    got = read_partition(files, n)
    bad = got != want
    emit("main", pairs=n, reads=2 * n, wall_s=wall, reads_per_s=2 * n / wall,
         data_gen_s=gen_s, launches=launches, mismatches=int(bad.sum()),
         mismatches_m5e_3=int(bad[margin >= 5e-3].sum()),
         counts={str(k): int((got == k).sum()) for k in (0, 1, -1)})
    check(not bad[margin >= 5e-3].any(),
          "output partition disagrees with plain exact labels at margin >= 5e-3")
    for mode in ("exact", "high"):
        check(launches[mode] > 0, f"the main path never launched the {mode} kernel")
    return launches, inputs, got, wall


def routed_at_full_length(seqs_per_side):
    """True for each read (pair) that the runner classifies at T=100: the
    2-bit lane and the 100 bucket. The rest run the 64 bucket, whose
    backward carry starts at the fp32 scan's zero_prefix_state(36)."""
    from ribodetector_tpu_torch import native
    from ribodetector_tpu_torch.encode import encode_batch
    from ribodetector_tpu_torch.runtime.buckets import choose_buckets, route_records

    buckets = choose_buckets(100, "auto")
    check(buckets == [64, 100], f"unexpected bucket grid {buckets}")
    idx = []
    for seqs in seqs_per_side:
        tok, lengths = encode_batch(seqs, 100)
        idx.append(route_records(lengths, native.pack_b5(tok), buckets, 100))
    return np.max(idx, axis=0) == len(buckets) - 1


def phase_serve(params, tmp):
    """serve.main at --precision fast, --concurrency 2, over five requests."""
    import torch

    from ribodetector_tpu_torch import serve
    from ribodetector_tpu_torch.ops import lstm_cuda
    from ribodetector_tpu_torch.runtime.ensure import paired_final_labels
    from ribodetector_tpu_torch.runtime.pipeline import Predictor

    rng = np.random.default_rng(5)
    t0 = time.perf_counter()
    big, big_seqs = write_pairs(tmp, 262144, rng, prefix="serve")
    single, single_seqs = write_single(tmp, 65536, rng)
    small, small_seqs = write_pairs(tmp, 16384, rng, prefix="serve_norrna")
    gen_s = time.perf_counter() - t0

    # what each job must produce: labels from the fast kernel called
    # directly at T=100 on the same reads
    checks = {}
    logits = [side_logits(params, s, fast_logits) for s in big_seqs]
    checks["pairs"] = (paired_final_labels(*logits, "both"), margin_of(*logits),
                       routed_at_full_length(big_seqs))
    checks["pairs_again"] = checks["pairs"]
    logit = side_logits(params, single_seqs, fast_logits)
    checks["single"] = (logit.argmax(1), margin_of(logit),
                        routed_at_full_length([single_seqs]))
    logits = [side_logits(params, s, fast_logits) for s in small_seqs]
    checks["norrna"] = (paired_final_labels(*logits, "norrna"), margin_of(*logits),
                        routed_at_full_length(small_seqs))

    jobs, files = [], {}
    for rid, inputs, ensure in (("pairs", big, "both"), ("pairs_again", big, "both"),
                                ("single", [single], "none"),
                                ("norrna", small, "norrna")):
        out, files[rid] = outputs(tmp, rid, len(inputs) == 2, ensure)
        jobs.append({"id": rid, "input": inputs, "output": out[1:out.index("-r")],
                     "rrna": out[out.index("-r") + 1:], "ensure": ensure})
    lines = [json.dumps(j) + "\n" for j in jobs]
    lines.insert(2, '{"id": "malformed", "input": [\n')

    # every classify step the server builds; a repeated key would mean the
    # second same-shape job missed the memo
    built = []
    build = Predictor._build_infer_locked
    Predictor._build_infer_locked = (
        lambda self, key: built.append(key) or build(self, key))
    lstm_cuda.reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    serve.main(["-l", "100", "--precision", "fast", "--concurrency", "2"],
               stdin=lines, stdout=out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    Predictor._build_infer_locked = build
    launches = dict(lstm_cuda.LAUNCHES)

    resps = [json.loads(l) for l in out.getvalue().splitlines()]
    check([r.get("id") for r in resps] == ["pairs", "pairs_again", None, "single",
                                           "norrna"],
          f"responses out of request order: {resps}")
    check(resps[2]["status"] == "error" and "JSONDecodeError" in resps[2]["error"],
          f"the malformed line was not answered with an error: {resps[2]}")
    check(len(built) == len(set(built)), f"a classify step was built twice: {built}")
    reads = 0
    for r in resps[:2] + resps[3:]:
        check(r["status"] == "ok", f"job failed: {r}")
        want, margin, full = checks[r["id"]]
        got = read_partition(files[r["id"]], len(want))
        check(r["num_read"] == len(want), f"{r['id']}: num_read {r['num_read']}")
        reads += len(want) * len(files[r["id"]][0])
        bad = got != want
        emit("serve", job=r["id"], num_read=r["num_read"], seconds=r["seconds"],
             counts=r["counts"], at_T100=int(full.sum()),
             mismatches_T100=int(bad[full].sum()),
             mismatches_T64=int(bad[~full].sum()),
             mismatches_T64_m5e_3=int(bad[~full & (margin >= 5e-3)].sum()))
        check(not bad[full].any(),
              f"{r['id']}: reads run at T=100 disagree with the fast kernel")
        check(not bad[~full & (margin >= 5e-3)].any(),
              f"{r['id']}: 64-bucket reads disagree at margin >= 5e-3")
    for f1, f2 in zip(sum(files["pairs"].values(), []),
                      sum(files["pairs_again"].values(), [])):
        op = gzip.open if f1.endswith("gz") else open
        with op(f1, "rb") as a, op(f2, "rb") as b:
            check(a.read() == b.read(), f"the repeated job's output differs: {f2}")
    check(launches["fast"] > 0, "serve never launched the fast kernel")
    emit("serve", requests=len(lines), jobs_ok=4, wall_s=wall,
         jobs_per_s=4 / wall, reads=reads, reads_per_s=reads / wall,
         data_gen_s=gen_s, launches=launches, steps_built=len(built))
    return launches


def phase_config(params, tmp):
    """The bf16 config and the portable runner, one CLI run each over the
    same 2 x 16384 pairs, against plain exact labels."""
    from ribodetector_tpu_torch.config import DEFAULT_CONFIG
    from ribodetector_tpu_torch.runtime.ensure import paired_final_labels

    inputs, seqs = write_pairs(tmp, 16384, np.random.default_rng(9), prefix="cfg")
    n = len(seqs[0])
    logits = [side_logits(params, side, exact_logits) for side in seqs]
    want = paired_final_labels(logits[0], logits[1], "both")
    margin = margin_of(*logits)
    with open(DEFAULT_CONFIG) as fh:
        base = json.load(fh)
    launches = {}
    # flips allowed below: bf16 state moves logits by ~0.1-0.2 against fp32
    # (the fast_bf16 kernel against exact in the kernels phase); the
    # portable runner runs high, under the probe's 5e-3 margin
    for name, runtime, mode, tol in (("bf16", {"compute_dtype": "bfloat16"},
                                      "fast_bf16", 0.5),
                                     ("portable", {"native": False}, "high", 5e-3)):
        cfg = copy.deepcopy(base)
        cfg["runtime"].update(runtime)
        path = os.path.join(tmp, f"config_{name}.json")
        with open(path, "w") as fh:
            json.dump(cfg, fh)
        out, files = outputs(tmp, name, True, "both")
        wall, launches[name] = run_cli(["-c", path, "-l", "100", "-i", *inputs,
                                        *out, "-e", "both"])
        got = read_partition(files, n)
        bad = got != want
        emit("config", run=name, runtime=runtime, pairs=n, wall_s=wall,
             launches=launches[name], flip_margin_allowed=tol,
             mismatches=int(bad.sum()),
             max_mismatch_margin=float(margin[bad].max(initial=0.0)))
        check(not bad[margin >= tol].any(),
              f"{name}: partition disagrees with exact labels at margin >= {tol}")
        check(launches[name][mode] > 0, f"{name}: never launched the {mode} kernel")
    return launches["bf16"]


def phase_trace(tmp, inputs, want, untraced_wall):
    """The main path once more under --trace-dir; the card's busy share is
    the union of its kernel intervals in the trace over the run's wall. The
    profiler's own start and stop lengthen the traced wall, so the share is
    also given over the trace's device window (first kernel start to last
    kernel end) and over the untraced run's wall."""
    trace_dir = os.path.join(tmp, "trace")
    out, files = outputs(tmp, "trace", True, "both")
    wall, launches = run_cli(["-l", "100", "-i", *inputs, *out, "-e", "both",
                              "--trace-dir", trace_dir])
    check(np.array_equal(read_partition(files, len(want)), want),
          "the traced run's partition differs from the untraced one")
    traces = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    check(len(traces) == 1, f"expected one trace file, found {traces}")
    with open(os.path.join(trace_dir, traces[0])) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]

    def union_s(cats):
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("cat") in cats)
        total, end = 0.0, -np.inf
        for a, b in spans:
            if b > end:
                total += b - max(a, end)
                end = b
        return total / 1e6, len(spans)

    kernel_s, n_kernels = union_s({"kernel"})
    busy_s, _ = union_s({"kernel", "gpu_memcpy", "gpu_memset"})
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    window_s = (max(e["ts"] + e["dur"] for e in dev) - min(e["ts"] for e in dev)) / 1e6
    trace_s = (max(e["ts"] + e["dur"] for e in events)
               - min(e["ts"] for e in events)) / 1e6
    by_name = {}
    for e in events:
        if e.get("cat") == "kernel":
            by_name[e["name"][:60]] = by_name.get(e["name"][:60], 0.0) + e["dur"] / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    emit("trace", wall_s=wall, untraced_wall_s=untraced_wall, trace_span_s=trace_s,
         device_window_s=window_s, launches=launches, kernel_events=n_kernels,
         kernel_busy_s=kernel_s, busy_share=kernel_s / wall,
         busy_share_of_device_window=kernel_s / window_s,
         busy_share_of_untraced_wall=kernel_s / untraced_wall,
         busy_with_copies_s=busy_s, busy_share_with_copies=busy_s / wall,
         top_kernels_s=dict(top))
    check(n_kernels > 0, "the trace holds no kernel of the card")


def main(argv):
    quick = "--quick" in argv
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, REPO)
    import ribodetector_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = phase_env()
    phase_build()
    from ribodetector_tpu_torch.models import load_params

    params = load_params(NPZ, "cuda")
    max_err, fast_plain = phase_kernels(params, quick)
    times = phase_timing(params, quick, fast_plain)
    if quick:
        emit("quick", done=True)
        return
    with tempfile.TemporaryDirectory() as tmp:
        # each path's launches are counted from 0 just before it runs
        launches, main_inputs, main_got, main_wall = phase_main(params, tmp)
        launches["fast"] = phase_serve(params, tmp)["fast"]
        launches["fast_bf16"] = phase_config(params, tmp)["fast_bf16"]
        phase_trace(tmp, main_inputs, main_got, main_wall)
    kernels = [
        {
            "name": f"bilstm_{mode}",
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": REPLACES[mode],
            "launches": launches[mode],
            "max_abs_err": max_err[mode],
            **times[mode],
        }
        for mode in MODES
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
