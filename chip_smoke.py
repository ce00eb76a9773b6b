#!/usr/bin/env python3
"""Smoke test of ribodetector_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py            # the whole check (needs one CUDA card)
    python3 chip_smoke.py --quick    # build + kernel checks at a small batch,
                                     # then the card tests
    python3 chip_smoke.py --caduceus # the Caduceus kernels and its detect
                                     # path alone (the caduceus phase)
    python3 chip_smoke.py --cards    # build + the main path, then at -d 0,1
                                     # (detect, serve and --precision exact)
                                     # and training over every card (needs
                                     # two cards)

Phases, one JSON line each; any failure exits non-zero:

  env       torch / CUDA versions and the card's name and power limit
  build     csrc/bilstm.cu (nvcc, sm_90a) and native/fastx.cpp (g++), from
            the checkout's sources, built concurrently into _build/; the
            ptxas register/spill report, and from `cuobjdump -sass` each
            kernel's tensor-core instructions (HMMA/HGMMA; every kernel
            must hold some), the instructions
            of one cell evaluation (from the loop of the mode's one-cell
            micro-kernel, rd_cell_floor_<mode>, never launched) and, as a
            diagnostic, those of each kernel's step loop per cell
  kernels   each of the four CUDA kernels (exact, high, fast, fast_bf16)
            against its plain torch version on the card (real weights,
            six settings: T=100 dense and packed and T=64 with the 36-step
            backward init of -l 100's 64 bucket, B = 16384+37; T=300 dense
            with the 44-step init and packed, B = 4096+37, and T=192 with
            the 108-step init, B = 1024+37, of -l 300's buckets): exact to
            max-abs <= 1e-4, the three tensor-core kernels to TC_GATE
            (lstm_cuda.tc_gate: mean-abs, 99.9th percentile, max-abs
            against the yardstick, no flip above a margin), beside the
            yardstick (the plain version summed in 16-wide k blocks) on
            the same reads (exact beside its own yardstick, the six-limb
            arithmetic summed in 16-wide k blocks, for information), and
            once more at the path's batch (262144 reads, T=100), where the
            tensor-core kernels' plain versions are timed (one call each);
            every kernel's row invariance (shuffled reads, and reads in a
            batch of another size, bit for bit) and its bit identity with
            W_hh = 0 (the product exactly zero in any order); high against
            exact under
            the startup probe's gate, and the fast kernels' flips against
            exact (information, not a gate)
  timing    kernel and plain times, the bound, and the cuDNN LSTM yardstick
            (fp32 for exact/high, bf16 for the fast kernels) at B=262144,
            T=100, and for exact and high at B=65536, T=300 (high's plain
            time there from the kernels phase, at its batch); the bound is
            the larger of the bytes and the compute, the larger of the
            products at the bf16 tensor cores' peak (six products for
            exact, three for high, one for the fast kernels) and the cell
            (its instructions at the CUDA cores' issue rate or its MUFU
            ones at theirs); exact's products at the fp32 CUDA-core rate
            beside it (fp32_cuda_core_ms); the resident clusters of exact
            and high
  caduceus  the Caduceus-Ph kernels (csrc/caduceus_scan.cu, built here on
            first use) at the published widths and the main path's
            micro-batch (models.caduceus.micro_rows at T=300: 1,372 reads,
            2,744 rows with their reverse complements; lengths of the 300
            bucket, 257-300, and four of 0, 1, 299, 300): cad_conv_kernel,
            cad_scan_kernel and cad_add_norm_kernel each against its plain
            version on the same inputs (within bf16's rounding of the
            output; the add exact), timed (kernel: CUDA events, mean of 5;
            plain: one call) beside its bound (the larger of its bytes at
            HBM's rate, its FLOPs at the CUDA cores' and, for the scan, its
            exp and softplus at the MUFU's); the scan kernel again at each
            bucket width of the detect cell (64, 128, 192, 256, 300: a
            micro-batch of the bucket's lengths each), with its identity
            steps' share; the build's ptxas lines, the scan kernel's
            registers, spilled bytes, shared bytes a block, blocks an SM,
            step group and chunk (scan_info), and its SASS's MUFU
            instructions by kind; then one detect CLI call on a
            Caduceus config (2,048 reads of 40-320 bp FASTA at -l 300, five
            buckets), its launches counted from 0 just before it: the scan
            and the conv once per layer and micro-batch, the add-norm 17
            times per 16 scans, and every read in its plain label's file
            where the margin is above the kernels' gap
  card_tests  the jax-free card tests (tests/test_torch_card_*.py) under
            `python3 -m pytest --noconftest` in a child process: fails
            unless pytest exits 0 and every collected test passed (none
            skipped)
  main      the CLI main path (paired gz, -l 100, -e both) over 2 x 262144
            reads with a cleared parity-marker cache, its partition checked
            read for read against the plain exact labels on the card, and
            each kernel's launch count in that run: exact once (the probe's
            reference arm), high on the probe and every batch (--profile
            logs the stage breakdown on stderr)
  configs   the JAX package's other documented configurations through the
            detect CLI, in process, each run's launches counted from 0 and
            its partition checked against plain exact labels on the card
            under its ensure mode (no mismatch at a margin >= 5e-3), with a
            fresh parity-marker cache: configuration 4, 2 x 65536 pairs of
            40-320 bp reads at -l 300 (buckets 64, 128, 192, 256, 300 each
            holding pairs, high launched on each; ~10% clean 300 bp pairs,
            N calls, lowercase, truncated and all-N reads) as plain FASTA
            (base-5 lane only) and as FASTQ.gz (the 2-bit lane); 2-3, the
            main phase's pairs under -e rrna, norrna and none; 1, their
            side 1 single-end at --chunk_size 256; and the main phase's
            pairs at --precision exact (3.3x high's kernel time), with
            its busy share from a --trace-dir rerun
  train     the training CLI on one card (train.__main__._train, hidden 128,
            batch 200, 4 epochs fine-tuning the shipped weights) over
            FASTA files of the port's synthetic_dataset (2 x 8192
            training, 2 x 1024 validation reads, -l 100): the shipped
            weights start at chance there, the train loss falls, best.npz
            reaches val acc > 0.8, and the eval steps launch exact once an
            epoch and no other kernel; the same from a random init
            (init_params, seed 0) at -l 40 over 3 epochs; each CLI run's
            train steps (trainer.step_counts: one capture for its one
            shape, a replay for each optimizer update, epochs x whole
            batches of them, the graph released when fit returned; the
            updates are the optimizer's own device count, as the update
            runs inside the graph); the graphed step (the CLI's: the
            batch's gather, forward, backward and the Adam update in one
            graph) and the eager one side by side from the same weights
            over the same 22 batches: steps/s and reads/s over the last
            20, their per-step losses, params and optimizer state bit for
            bit, and for one step of each (a torch.profiler trace) the
            card's kernels and their summed time, and the host's kernel
            and graph launches (the graphed step: one graph launch, no
            kernel launch); the same two steps over 6 batches packed, in
            bf16 compute, at T = 40 and at hidden 64, bit for bit, one
            capture each; eval reads/s (over the
            validation set in one launch, and over 65536 reads in 16);
            one batch's gradients
            on the card against the CPU (max-abs <= 1e-4 relative);
            best.npz through detect on the card over 2 x 16384 pairs
            (probe + high, against plain exact labels); and --hidden 64 (1
            epoch of 2 x 2048 reads) through detect on the card: kernel
            plain, no probe, no kernel launched, against the plain
            recurrence called on the card
  train_dist  training over several devices, each rank a child process
            running train.__main__.worker (what the CLI's main spawns per
            card) with its steps timed and its launches counted: with two
            cards or more, the worker over every card in an NCCL group at
            --tp 1 and --tp 2 (both captured whole: the dp average and
            tp's collectives inside the graph), the captured rank step
            against the eager one side by side at --tp 2 (SIDE_CHILD:
            losses, params and optimizer state bit for bit on every rank,
            one graph launch and no kernel launch a step), and the
            training CLI itself at --tp 2; with one card, two ranks on it
            over gloo at dp = 2 (forward and backward replayed, the
            average and the update eager after it) and at tp = 2 (eager);
            each run 1 epoch fine-tuning the shipped weights on the train
            phase's files (-l 100, batch 200; the gloo tp = 2 run, at
            ~740 ms an eager step, on its 2 x 2048-read files against a
            one-process run over them): the CLI's mesh lines, the losses
            and best.npz against the one-process run (losses 1e-4
            relative, parameters within lr), exact launched once an epoch
            on every rank and nothing else, every rank's train steps
            (graphed: one capture, a replay for each update; at tp > 1
            over gloo eager), best.npz through detect (probe + high,
            against plain exact labels), and each rank's step time,
            steps/s and train reads/s beside the total
  serve     the JSONL job server (serve.main, --precision fast,
            --concurrency 2) over a 2 x 262144-read paired gz job, the same
            job again (memo reuse), a malformed line, a single-end job of
            40-99 bp reads with N calls and an -e norrna job; every job's
            partition checked against the fast kernel called directly (reads
            run at T=100: every label; 64-bucket reads, whose backward carry
            starts from the scan's state: no flip at a margin >= 5e-3), and
            the stage timer of its jobs (the CLI's --profile), on in-process
  config    the bf16 config (runtime.compute_dtype=bfloat16, the fast_bf16
            kernel), a CLI run over 2 x 16384 pairs checked against plain
            exact labels
  trace     the main path again under --trace-dir: the card's busy share of
            the run's wall time, read from the torch.profiler trace
  resume    the main path with --resume, its wall against plain runs of the
            same command (plain, resume, resume, plain) and the main
            phase's, and at --chunk_size 1 (16 chunks): once in full, then in a
            subprocess killed (SIGKILL) once its manifest counts >= 2
            completed chunks, and relaunched; outputs equal the main
            phase's, the manifest is gone, and the relaunch launches high
            for fewer batches than the full run
  hosts     the main path as two hosts on the one card: a coordinated pair
            (--coordinator, a gloo group; host 0 merges the parts and logs
            the main phase's counts) and an uncoordinated pair (--hosts 2,
            whose .host000/.host001 shards concatenate to the main phase's
            outputs); each host's wall and high launches
  cards     with two cards or more: the main path at -d 0,1, outputs equal
            to the main phase's, high launched on each card; serve over the
            same pairs on one card and at -d 0,1, outputs equal; and
            --precision exact (3.3x high's
            kernel time) on one card and at -d 0,1, outputs equal, both
            walls; with one card a line that says it was skipped

Every path's outputs are compared decompressed, byte for byte. A "walls"
line before the kernels line gives each phase's wall time. The
subprocess phases run the CLI's main through CLI_CHILD, which prints the
run's wall and kernel launches as a JSON line.

The last line is {"ok": true, "device": {...}}. The script imports nothing
of the JAX package.
"""

import collections
import copy
import gzip
import io
import json
import os
import re
import shutil
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
# the CUDA cores issue one instruction per lane and clock (67 TFLOP/s is one
# fp32 FMA, two flops, per lane and clock); the MUFU unit (exp2, reciprocal)
# takes 16 per SM and clock against the fp32 pipe's 128 (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability 9.0)
CUDA_CORE_INSTR_PER_S = FP32_FLOPS / 2
MUFU_PER_S = CUDA_CORE_INSTR_PER_S / 8
# cell evaluations one thread makes per step of each kernel's loop
# (csrc/bilstm.cu: TM reads x 8 units / 32 lanes for the fast kernels; 32
# reads x 8 units / 32 lanes for each of high's warps, 16 for exact's)
CELLS_PER_THREAD_STEP = {"exact": 4, "high": 8, "fast": 16, "fast_bf16": 16}
H = 128
G = 4 * H
LIB_CHUNK = 16384  # reads per cuDNN call of the library yardstick at T = 100


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
    """max-abs, mean-abs, argmax flips, and flips at reference margins >=
    1e-4, 5e-3, 0.1 and 0.5, with the largest flipped margin."""
    flipped = got.argmax(1) != ref.argmax(1)
    margin = np.abs(ref[:, 1] - ref[:, 0])
    diff = np.abs(got - ref)
    r = {"max_abs": float(diff.max()), "mean_abs": float(diff.mean()),
         "flips": int(flipped.sum()),
         "max_flip_margin": float(margin[flipped].max(initial=0.0))}
    for m in ("1e-4", "5e-3", "0.1", "0.5"):
        r[f"flips_m{m}"] = int(flipped[margin >= float(m)].sum())
    return r


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


SASS_FUNCTION = re.compile(r"Function : (\S+)")
SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;")
# the kernels' names: bilstm_tc_kernel<MODE> (fast, fast_bf16), and
# bilstm_exact_kernel, bilstm_high_kernel
SASS_KERNEL = re.compile(r"bilstm_tc_kernelILi(\d)E|bilstm_(exact|high)_kernel")
SASS_CELL = re.compile(r"^rd_cell_floor_(\w+)$")  # the cell's micro-kernels


def opcode(text):
    parts = text.split()
    return parts[1] if parts[0].startswith("@") and len(parts) > 1 else parts[0]


def cuobjdump_sass(lib_path):
    """(`cuobjdump -sass` of a library, None), or (None, why not)."""
    from ribodetector_tpu_torch.ops import build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None, "cuobjdump not found (next to nvcc or on PATH)"
    proc = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True)
    if proc.returncode != 0:
        return None, f"cuobjdump failed: {proc.stderr.strip()[-300:]}"
    return proc.stdout, None


def read_sass(lib_path):
    """({mode or "cell:" + mode: [(address, instruction)]}, None) from
    `cuobjdump -sass` of the kernel library, or (None, why not)."""
    sass, why = cuobjdump_sass(lib_path)
    if sass is None:
        return None, why
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = SASS_FUNCTION.search(line)
        if m:
            k = SASS_KERNEL.search(m.group(1))
            cf = SASS_CELL.match(m.group(1))
            if k:
                cur = MODES[int(k.group(1))] if k.group(1) else k.group(2)
            else:
                cur = "cell:" + cf.group(1) if cf else None
            if cur:
                funcs[cur] = []
            continue
        m = SASS_INSN.search(line)
        if m and cur:
            funcs[cur].append((int(m.group(1), 16), m.group(2).strip()))
    return funcs, None


def branches(ops):
    """(address, target) of every branch with a literal target."""
    out = []
    for a, op, t in ops:
        m = re.search(r"0x([0-9a-f]+)", t) if op.startswith("BRA") else None
        if m:
            out.append((a, int(m.group(1), 16)))
    return out


def sass_stats(mode, insns):
    """Tensor-core instructions of one kernel, and, as a diagnostic, the
    instructions of its step loop (the widest backward branch) that run on
    the CUDA cores per cell evaluation: those outside any loop nested in it
    and other than
    HMMA/HGMMA/LDSM (the tensor-core product) or NOP. That count takes in
    the step's own work (token load, ldmatrix addresses, barrier, hold and
    capture), so it is the kernel's cost per cell, not the bound's."""
    ops = [(a, opcode(t), t) for a, t in insns]
    loops = [(b, a) for a, b in branches(ops) if b <= a]
    r = {"insns": len(ops),
         "hmma": sum(op.startswith("HMMA") for _, op, _ in ops),
         "hgmma": sum(op.startswith("HGMMA") for _, op, _ in ops)}
    if not loops:
        return r
    lo, hi = max(loops, key=lambda l: l[1] - l[0])
    inner = [l for l in loops if l != (lo, hi) and lo <= l[0] and l[1] <= hi]
    body = [op for a, op, _ in ops if lo <= a <= hi]
    core = [op for a, op, _ in ops if lo <= a <= hi
            and not any(x <= a <= y for x, y in inner)
            and not op.startswith(("HMMA", "HGMMA", "LDSM", "NOP"))]
    r.update(step_loop_insns=len(body), nested_loops=len(inner),
             cuda_core_insns=len(core),
             step_loop_insns_per_cell=len(core) / CELLS_PER_THREAD_STEP[mode])
    return r


def cell_stats(insns):
    """The instructions of one cell evaluation, from the loop of the mode's
    micro-kernel (rd_cell_floor_<mode>, one cell per iteration): all but
    the loop's own control (its backward branch, and the counter's add and
    compare) and the IEEE division's slow path (a call that a forward branch
    skips unless an operand is out of range), with the MUFU ones (exp2,
    reciprocal) apart."""
    ops = [(a, opcode(t), t) for a, t in insns]
    back = [(b, a) for a, b in branches(ops) if b < a]  # not the final BRA-to-self
    if len(back) != 1:
        return None
    lo, hi = back[0]
    loop = [(a, op, t) for a, op, t in ops if lo <= a < hi]
    cmp = [(a, t) for a, op, t in loop if op.startswith("ISETP")][-1]
    regs = set(re.findall(r"\bU?R\d+\b", cmp[1]))
    inc = [a for a, op, t in loop if op.startswith(("IADD3", "UIADD3", "VIADD"))
           and re.findall(r"\bU?R\d+\b", t)[0] in regs][-1]
    calls = [a for a, op, _ in ops if op.startswith("CALL")]
    slow = [(a, b) for a, b in branches(ops)
            if lo <= a < b <= hi and any(a < x < b for x in calls)]
    body = [op for a, op, _ in loop if a not in (cmp[0], inc)
            and not any(x < a < y for x, y in slow) and op != "NOP"]
    hist = {}
    for op in body:
        hist[op.split(".")[0]] = hist.get(op.split(".")[0], 0) + 1
    return {"insns": len(body), "mufu": hist.get("MUFU", 0),
            "opcodes": dict(sorted(hist.items()))}


def phase_build():
    """Builds both libraries; returns {mode: SASS stats} (empty without
    cuobjdump)."""
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
    funcs, why = read_sass(kpath)
    if funcs is None:
        emit("build", sass=None, note=why + ": no HMMA count and no cell floor")
        return {}
    stats = {mode: sass_stats(mode, funcs.get(mode, [])) for mode in MODES}
    for mode in MODES:
        stats["cell:" + mode] = cell_stats(funcs.get("cell:" + mode, []))
        check(stats["cell:" + mode] is not None,
              f"no single loop in the {mode} cell's micro-kernel")
    emit("build", sass=stats)
    for mode in MODES:
        check(stats[mode]["hmma"] + stats[mode]["hgmma"] > 0,
              f"the {mode} kernel holds no tensor-core instruction")
    return stats


def row_invariance(params, mode, tok, lens, sem, bwd):
    """Bit for bit: the reads shuffled, and the first 1000 of them after
    333 other reads (a batch of another size), against one call over the
    batch as it is."""
    import torch

    from ribodetector_tpu_torch.ops.lstm_cuda import bilstm_logits_cuda

    B, T = tok.shape
    rng = np.random.default_rng(13)
    dev = tok.device
    perm = torch.from_numpy(rng.permutation(B)).to(dev)
    other_tok, other_len = random_tokens(rng, 333, T)
    n = min(1000, B)
    mixed_tok = torch.cat([torch.from_numpy(other_tok).to(dev), tok[:n]])
    mixed_len = torch.cat([torch.from_numpy(other_len).to(dev), lens[:n]])
    kw = dict(semantics=sem, mode=mode, bwd_init=bwd)
    base = bilstm_logits_cuda(params, tok, lens, **kw)
    shuffled = bilstm_logits_cuda(params, tok[perm].contiguous(), lens[perm], **kw)
    mixed = bilstm_logits_cuda(params, mixed_tok, mixed_len, **kw)[333:]
    return {"shuffled": bool(torch.equal(shuffled, base[perm])),
            "other_batch": bool(torch.equal(mixed, base[:n]))}


def gate_tc(params, mode, tok, lens, sem, bwd, got, setting):
    """A tensor-core kernel's logits against its plain version under
    TC_GATE, beside the yardstick; emits the readings and fails outside the
    gate. Returns (readings, the plain version's time in ms: one call, CUDA
    events)."""
    import torch

    from ribodetector_tpu_torch.ops.lstm_cuda import PLAIN, TC_GATE, YARDSTICK, tc_gate

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ref = PLAIN[mode](params, tok, lens, semantics=sem, bwd_init=bwd)
    end.record()
    torch.cuda.synchronize()
    yard = YARDSTICK[mode](params, tok, lens, semantics=sem, bwd_init=bwd)
    r = tc_gate(mode, got, ref.cpu().numpy(), yard.cpu().numpy())
    emit("kernels", kernel=mode, setting=setting, B=tok.shape[0], vs="plain",
         gate=TC_GATE[mode], **r)
    check(r["within_gate"], f"{mode} kernel is outside its gate against its "
                            f"plain version ({setting}): {r}")
    return r, start.elapsed_time(end)


# exact's mean |kernel - plain fp32| over its yardstick's (the six-limb
# arithmetic summed in 16-wide k blocks): a dropped third-limb product
# (W1*h3, W3*h1, W2*h2) moves the logits by less than the 1e-4 gate, but
# reads 10-21x on the mean (tests/test_torch_exact.py EXACT_FAULTS)
EXACT_MEAN_VS_YARDSTICK = 4.0


def gate_exact(params, tok, lens, sem, bwd, got, setting, yardstick=True):
    """The exact kernel's logits against the plain fp32 recurrence: max-abs
    <= 1e-4 and no flip at a plain margin >= 1e-4; unless yardstick=False,
    also beside its order yardstick against the same, its mean-abs within
    EXACT_MEAN_VS_YARDSTICK of the yardstick's. Emits the readings and
    fails outside either check. Returns the readings."""
    from ribodetector_tpu_torch.ops.lstm_cuda import PLAIN, YARDSTICK

    ref = PLAIN["exact"](params, tok, lens, semantics=sem, bwd_init=bwd).cpu().numpy()
    r = compare(got, ref)
    extra = {}
    if yardstick:
        yard = YARDSTICK["exact"](params, tok, lens, semantics=sem, bwd_init=bwd).cpu().numpy()
        y = compare(yard, ref)
        extra = {"yardstick": {k: y[k] for k in ("max_abs", "mean_abs", "flips")},
                 "vs_yardstick_max_abs": float(np.abs(got - yard).max()),
                 "mean_vs_yardstick": r["mean_abs"] / max(y["mean_abs"], 1e-30)}
    emit("kernels", kernel="exact", setting=setting, B=tok.shape[0], vs="plain", **r,
         **extra)
    check(r["max_abs"] <= 1e-4 and r["flips_m1e-4"] == 0,
          f"exact kernel disagrees with its plain version ({setting}): {r}")
    check(not extra or extra["mean_vs_yardstick"] <= EXACT_MEAN_VS_YARDSTICK,
          f"exact kernel's mean-abs is {extra.get('mean_vs_yardstick')}x its "
          f"yardstick's ({setting})")
    return r


def zero_product(params, mode, tok, lens, sem, bwd, setting):
    """Bit for bit against the plain version with W_hh = 0, where the
    product is exactly zero whatever order the tensor cores sum in. The
    plain version is taken in its blocked form (YARDSTICK): with W_hh = 0
    the two are the same bit for bit (tests/test_torch_kernels.py
    test_zero_product_weights_make_the_order_irrelevant), and the blocked
    one makes 16x fewer launches (plain high's k-ascending sum: 3.2 s a
    call at 4133 reads and T = 300)."""
    import torch

    from ribodetector_tpu_torch.ops.lstm_cuda import (
        YARDSTICK,
        bilstm_logits_cuda,
        zero_product_params,
    )

    p0 = zero_product_params(params)
    got = bilstm_logits_cuda(p0, tok, lens, semantics=sem, mode=mode, bwd_init=bwd)
    ref = YARDSTICK[mode](p0, tok, lens, semantics=sem, bwd_init=bwd)
    same = bool(torch.equal(got, ref))
    emit("kernels", kernel=mode, setting=setting, B=tok.shape[0],
         zero_product_bit_identical=same, max_abs=float((got - ref).abs().max()))
    check(same, f"{mode}: not bit-identical to its plain version with W_hh = 0 "
                f"({setting})")


def phase_kernels(params, quick):
    import torch

    from ribodetector_tpu_torch.models.bilstm import zero_prefix_state
    from ribodetector_tpu_torch.ops.lstm_cuda import TC_GATE, bilstm_logits_cuda

    dev = params.w_hh_f.device
    rng = np.random.default_rng(7)
    B = (4096 if quick else 16384) + 37  # ragged last tile
    # the longer settings at fewer reads: their plain versions take time
    # in proportion to B * T (plain high 3.2 s a call at 4133 reads and
    # T = 300), and no term of the gates grows with B
    B_long = (1024 if quick else 4096) + 37
    # as many reads under --quick: TC_GATE's 99.9th percentile needs them
    B_192 = 1024 + 37
    # (name, T, semantics, backward-carry steps, reads): the -l 100 path's
    # buckets (T = 100 and the 64 bucket's 36-step init), and the -l 300
    # grid's (configuration 4): its full bucket, dense with the 256
    # bucket's 44-step init and packed, and the 192 bucket with its 108
    settings = [("T100_dense", 100, "dense", 0, B),
                ("T64_dense_bwd36", 64, "dense", 36, B),
                ("T100_packed", 100, "packed", 0, B),
                ("T300_dense_bwd44", 300, "dense", 44, B_long),
                ("T192_dense_bwd108", 192, "dense", 108, B_192),
                ("T300_packed", 300, "packed", 0, B_long)]
    max_err = {mode: 0.0 for mode in MODES}
    plain_ms = {}
    t300_plain = {}  # the tensor-core kernels' plain versions at T = 300
    with torch.no_grad():
        for name, T, sem, k, B in settings:
            t_setting = time.perf_counter()
            # the backward-carry init as the pipeline builds it: the scan in
            # the run's compute dtype (bf16 for the bf16 config's fast_bf16)
            init = {"fp32": zero_prefix_state(params, k),
                    "bf16": zero_prefix_state(params, k, compute_dtype=torch.bfloat16)}
            tok_np, len_np = random_tokens(rng, B, T)
            tok = torch.from_numpy(tok_np).to(dev)
            lens = torch.from_numpy(len_np).to(dev)
            out = {}
            for mode in MODES:
                bwd = None
                if k:
                    bwd = init["bf16" if mode == "fast_bf16" else "fp32"]
                got = bilstm_logits_cuda(params, tok, lens, semantics=sem,
                                         mode=mode, bwd_init=bwd)
                got = got.cpu().numpy()
                check(got.shape == (B, 2) and np.isfinite(got).all(),
                      f"{mode} {name}: shape {got.shape} or non-finite logits")
                if mode in TC_GATE:
                    # the tensor cores sum in their own order, amplified:
                    # held to the gate, beside what a change of order alone
                    # does
                    r, ms = gate_tc(params, mode, tok, lens, sem, bwd, got, name)
                    if name == "T300_dense_bwd44":
                        t300_plain[mode] = ms
                else:  # exact: the fp32 recurrence's 1e-4
                    r = gate_exact(params, tok, lens, sem, bwd, got, name)
                inv = row_invariance(params, mode, tok, lens, sem, bwd)
                emit("kernels", kernel=mode, setting=name, B=B, row_invariance=inv)
                check(all(inv.values()),
                      f"{mode}: a read's logits depend on its batch: {inv}")
                zero_product(params, mode, tok, lens, sem, bwd, name)
                max_err[mode] = max(max_err[mode], r["max_abs"])
                out[mode] = got
            r = compare(out["high"], out["exact"])
            gate = r["flips_m5e-3"] == 0 and r["flips"] <= max(2, 1e-4 * B)
            emit("kernels", kernel="high", setting=name, B=B, vs="exact",
                 probe_gate=gate, **r)
            check(gate, f"high vs exact fails the probe gate: {r}")
            for mode in ("fast", "fast_bf16"):
                # what a user of the fast modes gives up: not a gate
                emit("kernels", kernel=mode, setting=name, B=B, vs="exact",
                     **compare(out[mode], out["exact"]))
            emit("kernels", setting=name, B=B, wall_s=time.perf_counter() - t_setting)
        # the gates once more at the batch of one device call of the main
        # path (the timing batch): TC_GATE's terms must not depend on the
        # number of reads, and here the plain versions of the other three
        # kernels are timed (one call each: plain high sums in k order, one
        # elementwise op per product, and takes ~36 s)
        Bp = 16384 if quick else 262144
        tok = torch.from_numpy(random_tokens(np.random.default_rng(11), Bp, 100)[0]).to(dev)
        for mode in MODES:
            got = bilstm_logits_cuda(params, tok, semantics="dense", mode=mode).cpu().numpy()
            if mode in TC_GATE:
                r, plain_ms[mode] = gate_tc(params, mode, tok, None, "dense", None,
                                            got, "T100_dense_path_batch")
            else:
                r = gate_exact(params, tok, None, "dense", None, got,
                               "T100_dense_path_batch", yardstick=False)
            max_err[mode] = max(max_err[mode], r["max_abs"])
    return max_err, {"plain_ms": plain_ms, "plain_B": Bp, "t300_plain_ms": t300_plain,
                     "t300_plain_B": B_long}


CLUSTER_BLOCKS = {"exact": 4, "high": 2}  # blocks per cluster (csrc/bilstm.cu)


def placement(mode):
    """The SMs the exact or the high kernel's clusters leave idle: a
    cluster's blocks take SMs of one GPC, so a GPC whose SM count is not a
    multiple of the cluster's size keeps the rest free
    (cudaOccupancyMaxActiveClusters, one block per SM)."""
    import ctypes

    import torch

    from ribodetector_tpu_torch.ops.build import kernel_library

    lib, n = kernel_library(), ctypes.c_int(0)
    err = lib.rd_max_active_clusters(MODES.index(mode), ctypes.byref(n))
    check(err == 0, f"cudaOccupancyMaxActiveClusters failed: "
                    f"{lib.rd_cuda_error_string(err).decode()}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"sms": sms, "cluster_blocks": CLUSTER_BLOCKS[mode],
            "resident_clusters": n.value,
            "idle_sms": sms - CLUSTER_BLOCKS[mode] * n.value}


def bound(mode, B, T, sass):
    """The least time of one call over B reads of T steps: the largest of
    the bytes, each input read once and the output written once (tokens,
    gather, W_hh in its type -- exact's three bf16 limbs: 6 bytes an
    element, high's two: 4 --, the token table; last_out [B, 256] fp32
    out); the multiply-adds at the bf16 tensor cores' peak, once for each
    limb product (six for exact, as the TPU's HIGHEST precision computes
    the fp32 product; three for high; one for the fast modes); and the
    cell's evaluations (2*T*H a read) on the CUDA cores: the instructions
    of one cell in the mode's micro-kernel (read from the SASS in the build
    phase) at the issue rate, or its MUFU instructions at theirs, whichever
    takes longer. The products on the tensor cores overlap the cell on the
    CUDA cores, so the compute is the larger of the two.
    fp32_cuda_core_ms: the multiply-adds once at the fp32 CUDA-core peak
    (exact's bound before it ran on the tensor cores, with the cell)."""
    w_bytes = {"exact": 6, "high": 4, "fast": 2, "fast_bf16": 2}
    flops = 2.0 * 2 * T * G * H * B
    cells = 2.0 * T * H * B
    products = {"exact": 6, "high": 3, "fast": 1, "fast_bf16": 1}[mode]
    products_ms = 1e3 * products * flops / BF16_TC_FLOPS
    nbytes = (B * T + 4 * B + w_bytes[mode] * 2 * H * G + 4 * 2 * 5 * G
              + 4 * B * 2 * H)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    cell = sass.get("cell:" + mode)
    cell_ms = None if cell is None else 1e3 * cells * max(
        cell["insns"] / CUDA_CORE_INSTR_PER_S, cell["mufu"] / MUFU_PER_S)
    compute_ms = max(products_ms, cell_ms or 0.0)
    return {"bytes_ms": bytes_ms, "products_ms": products_ms, "cell_ms": cell_ms,
            "compute_ms": compute_ms, "compute_rule": "max(products, cell)",
            "cell_insns": cell and cell["insns"], "cell_mufu": cell and cell["mufu"],
            "fp32_cuda_core_ms": 1e3 * flops / FP32_FLOPS,
            "bound_ms": max(bytes_ms, compute_ms),
            "bound_by": "bytes" if bytes_ms >= compute_ms else "operations"}


def lib_chunk(T):
    """Reads per cuDNN call at T steps: its workspace grows with B * T, so
    at most LIB_CHUNK * 100 / T, rounded down to a power of two (each timed
    B is a power of two, so the calls are equal)."""
    return 1 << (LIB_CHUNK * 100 // T).bit_length() - 1


def cudnn_yardstick(params):
    """One-hot tokens [B, T] on the card -> logits from cuDNN's LSTM (fp32,
    TF32 off, and bf16) plus the dense gather and the head, in calls of
    lib_chunk(T) reads (one call over all B reads asks for ~378 GiB of
    workspace at B = 262144, T = 100); the port never calls it."""
    import torch

    from ribodetector_tpu_torch.models.bilstm import head

    dev = params.w_hh_f.device
    torch.backends.cudnn.allow_tf32 = False
    lstm = torch.nn.LSTM(4, H, 1, batch_first=True, bidirectional=True).to(dev)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(params.w_ih_f.T)
        lstm.weight_hh_l0.copy_(params.w_hh_f.T)
        lstm.bias_ih_l0.copy_(params.b_f)
        lstm.bias_hh_l0.zero_()
        lstm.weight_ih_l0_reverse.copy_(params.w_ih_b.T)
        lstm.weight_hh_l0_reverse.copy_(params.w_hh_b.T)
        lstm.bias_ih_l0_reverse.copy_(params.b_b)
        lstm.bias_hh_l0_reverse.zero_()
    nets = {"fp32": (lstm, torch.float32),
            "bf16": (copy.deepcopy(lstm).to(torch.bfloat16), torch.bfloat16)}

    def library(tok, lib):
        net, dtype = nets[lib]
        B, T = tok.shape
        onehot = torch.nn.functional.one_hot(tok.long(), 5)[..., :4].float()
        nb = min(B, lib_chunk(T))
        rows = torch.arange(nb, device=dev)
        h0 = torch.zeros((2, nb, H), device=dev, dtype=dtype)
        logits = []
        for i in range(0, B, nb):
            x = onehot[i: i + nb]
            out, _ = net(x.to(dtype), (h0, h0))
            g = T - 1 - x.sum(2).flip(1).argmax(1)
            logits.append(head(params, out[rows, g].float()))
        return torch.cat(logits)

    return library


def phase_timing(params, quick, tc_plain, sass):
    """Times at the main path's full device call (2 x 131072 reads, T=100),
    of exact at its eval and probe batches (4096 and 16384 reads), and of
    high and exact at -l 300's full bucket (B = 65536, T = 300)."""
    import torch

    from ribodetector_tpu_torch.ops.lstm_cuda import PLAIN, bilstm_logits_cuda

    dev = params.w_hh_f.device
    B, T = (16384 if quick else 262144), 100
    rng = np.random.default_rng(11)
    tok_np, _ = random_tokens(rng, B, T)
    tok = torch.from_numpy(tok_np).to(dev)
    res = {}
    library = cudnn_yardstick(params)
    with torch.no_grad():
        for mode in MODES:
            res[mode] = {"ms": cuda_time_ms(
                lambda: bilstm_logits_cuda(params, tok, semantics="dense",
                                           mode=mode), 3)}
        res["exact"]["plain_ms"] = cuda_time_ms(
            lambda: PLAIN["exact"](params, tok, semantics="dense"), 2)
        res["exact"]["plain_B"] = B
        for mode in ("high", "fast", "fast_bf16"):
            res[mode]["plain_ms"] = tc_plain["plain_ms"][mode]
            res[mode]["plain_B"] = tc_plain["plain_B"]
        # the cuDNN yardstick: fp32 beside exact and high, bf16 beside the
        # fast kernels
        lib_ms = {lib: cuda_time_ms(lambda: library(tok, lib), 2) for lib in ("fp32", "bf16")}
        # agreement of each yardstick with the exact kernel (sanity only)
        exact = bilstm_logits_cuda(params, tok, semantics="dense", mode="exact")
        lib_err = {lib: float((library(tok, lib) - exact).abs().max())
                   for lib in ("fp32", "bf16")}
        del exact
        torch.cuda.empty_cache()
    for mode in MODES:
        lib = "bf16" if mode.startswith("fast") else "fp32"
        b = bound(mode, B, T, sass)
        res[mode].update(library_ms=lib_ms[lib], bound_ms=b["bound_ms"],
                         bound_by=b["bound_by"])
        emit("timing", kernel=mode, B=B, T=T, library=f"cudnn_{lib}",
             **(placement(mode) if mode in CLUSTER_BLOCKS else {}),
             library_err=lib_err[lib], library_calls=-(-B // lib_chunk(T)),
             step_loop_insns_per_cell=sass.get(mode, {}).get("step_loop_insns_per_cell"),
             **{**b, **res[mode]})

    # exact at the batches it runs at on the paths: the training eval
    # step's 4096 reads and the startup probe's 16384 (T = 100), where a
    # call fills few waves of the card
    for Bs, role in ((4096, "eval_batch"), (16384, "probe_batch")):
        tok_s = tok[:Bs].contiguous()
        with torch.no_grad():
            ms = cuda_time_ms(lambda: bilstm_logits_cuda(params, tok_s, semantics="dense",
                                                         mode="exact"), 5)
        emit("timing", kernel="exact", role=role, B=Bs, T=T, ms=ms,
             reads_per_s=1e3 * Bs / ms, bound_ms=bound("exact", Bs, T, sass)["bound_ms"])

    # -l 300's full bucket, the longest rows any kernel reads (one byte a
    # token at a stride of T): high (every bucket of configuration 4) and
    # exact (its probe arm and --precision exact); high's plain version was
    # timed in the kernels phase, at T300_dense_bwd44's batch
    B3, T3 = (4096 if quick else 65536), 300
    tok = torch.from_numpy(random_tokens(np.random.default_rng(12), B3, T3)[0]).to(dev)
    with torch.no_grad():
        lib3 = cuda_time_ms(lambda: library(tok, "fp32"), 2)
        for mode in ("exact", "high"):
            ms = cuda_time_ms(lambda: bilstm_logits_cuda(params, tok, semantics="dense",
                                                         mode=mode), 3)
            if mode == "exact":
                plain_ms, plain_B = cuda_time_ms(
                    lambda: PLAIN["exact"](params, tok, semantics="dense"), 2), B3
            else:
                plain_ms, plain_B = tc_plain["t300_plain_ms"]["high"], tc_plain["t300_plain_B"]
            emit("timing", kernel=mode, B=B3, T=T3, ms=ms, plain_ms=plain_ms, plain_B=plain_B,
                 library="cudnn_fp32", library_ms=lib3,
                 library_calls=-(-B3 // lib_chunk(T3)),
                 **bound(mode, B3, T3, sass))
    torch.cuda.empty_cache()
    return res


CARD_TESTS = os.path.join("tests", "test_torch_card_*.py")


CAD_T = 300


# the detect cell's buckets (benchmark/configs/cad_ph_d256_n16_l300.json)
# and the lengths each holds of lib_fa_long_cad's 40-300 bp reads
CAD_BUCKETS = ((64, 40), (128, 65), (192, 129), (256, 193), (300, 257))


def cad_inputs(params, rng, reads, T=CAD_T, shortest=257):
    """A micro-batch as the Caduceus step hands it to the kernels: token
    rows of a bucket's lengths (shortest..T) and their reverse complements
    -> (ids [2 reads, T], lengths [2 reads], the first layer's residual r)."""
    import torch

    from ribodetector_tpu_torch.models import caduceus as cad

    lengths = rng.integers(shortest, T + 1, reads)
    lengths[:4] = (0, 1, T - 1, T)
    tok = rng.integers(0, 5, (reads, T)).astype(np.uint8)
    tok[np.arange(T)[None, :] >= lengths[:, None]] = 4
    ids, lengths2 = cad.strands(torch.from_numpy(tok).cuda(), torch.from_numpy(lengths).cuda())
    return ids, lengths2, params.embedding[ids]


def identity_share(lengths, group):
    """The scan kernel's identity steps (a row's last group of `group`
    steps run past its end) over all the steps it runs, both directions."""
    L = np.asarray(lengths, dtype=np.int64)
    run = -(-L // group) * group
    return float((run - L).sum() / max(int(run.sum()), 1))


def cad_in_proj(params, r, lens32):
    """The first layer up to the conv from a micro-batch's residual r:
    (xz, the conv kernel's output xc)."""
    import torch

    from ribodetector_tpu_torch.ops import caduceus_cuda as cc

    u = cc.add_norm_cuda(r.clone(), None, params.norm_g[0])
    xz = torch.matmul(u, params.w_in[0].to(torch.bfloat16))
    del u
    return xz, cc.conv_cuda(xz, lens32, params.conv_w[0], params.conv_b[0])


def cad_scan_args(params, xz, xc, lens32):
    """The first layer's scan_cuda arguments, as caduceus_logits_cuda
    hands them over, from its in-projection xz and conv output xc."""
    import torch

    from ribodetector_tpu_torch.ops import caduceus_cuda as cc

    N, T, E = xz.shape[0], xz.shape[1], xc.shape[-1]
    dbc = torch.bmm(xc.view(2, N * T, E), params.w_x[0].to(torch.bfloat16)).view(2, N, T, -1)
    a2 = (-torch.exp(params.a_log[0]) * cc.LOG2E).contiguous()
    return (xz, dbc, lens32, params.conv_w[0], params.conv_b[0], params.w_dt[0],
            params.b_dt[0], a2, params.d[0])


def cad_scan_bound_s(params, bases):
    """The scan's bound for `bases` bases (both directions): its exps and
    softplus at the MUFU's rate, above its FLOPs and bytes (csrc note)."""
    E = params.w_in.shape[2] // 2
    S = params.a_log.shape[3]
    return 2 * (E * S + E) * bases / MUFU_PER_S


def cad_scan_sass(lib_path):
    """From `cuobjdump -sass`: cad_scan_kernel's static instruction count
    and its MUFU instructions by kind ({} without cuobjdump). Its step
    groups hold nearly all the MUFU ones, so those over the groups' steps
    are about a channel-step's."""
    sass, _ = cuobjdump_sass(lib_path)
    counts, cur = collections.Counter(), False
    for line in (sass or "").splitlines():
        m = SASS_FUNCTION.search(line)
        if m:
            cur = "cad_scan_kernel" in m.group(1)
            continue
        m = SASS_INSN.search(line)
        if m and cur:
            op = opcode(m.group(2))
            counts["instructions"] += 1
            if op.startswith("MUFU"):
                counts[op] += 1
    return dict(counts)


def cad_gate(name, got, want, rel, floor):
    """Every element of got within rel * |want| + floor of want."""
    import torch

    err = (got.float() - want.float()).abs()
    bad = int((err > rel * want.float().abs() + floor).sum())
    check(bad == 0, f"caduceus: {name} against its plain version: {bad} elements "
                    f"outside {rel:g} relative + {floor:g} (max-abs {float(err.max()):.3g})")
    return float(err.max())


def one_call_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def caduceus_kernels(params):
    """Each kernel against its plain version and timed at the main path's
    micro-batch -> the kernels line's rows."""
    import torch

    from ribodetector_tpu_torch.models import caduceus as cad
    from ribodetector_tpu_torch.ops import caduceus_cuda as cc

    reads = cad.micro_rows(params, CAD_T)
    ids, lengths, r = cad_inputs(params, np.random.default_rng(17), reads)
    N, D = r.shape[0], r.shape[2]
    E = params.w_in.shape[2] // 2
    P = params.w_x.shape[3]
    bases = int(lengths.sum())
    lens32 = lengths.int().contiguous()
    bf16 = torch.bfloat16
    # bf16 rounding of a kernel's output: half an ulp (2^-9 relative) each
    # way, beside the fp32 arithmetic's other order and ex2.approx
    rel = 2.0 ** -8
    rows = []

    def row(name, plain_name, kernel_ms, plain_ms, bound_ms, bound_by, max_abs):
        rows.append({"name": name, "route": "cuda", "source": "ribodetector_tpu_torch/csrc/"
                     "caduceus_scan.cu", "replaces": None, "plain": plain_name,
                     "B": N, "T": CAD_T, "bases": bases, "kernel_ms": kernel_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "plain_ms": plain_ms,
                     "max_abs_err": max_abs})

    # add-norm: r += h and RMSNorm(r) g, bf16 out: reads r and h, writes r and u
    h = (0.1 * torch.randn(r.shape, device=r.device)).to(bf16)
    g = params.norm_g[1].contiguous()
    want_r, want_u = cad.add_norm_plain(r, h, g)
    r2 = r.clone()
    got_u = cc.add_norm_cuda(r2, h, g)
    check(torch.equal(r2, want_r), "caduceus: the add-norm kernel's fp32 add is not exact")
    err = cad_gate("cad_add_norm_kernel", got_u, want_u, rel, 1e-6)
    r2 = r.clone()
    k_ms = cuda_time_ms(lambda: cc.add_norm_cuda(r2, h, g), 5)
    p_ms = one_call_ms(lambda: cad.add_norm_plain(r, h, g))
    nbytes = N * CAD_T * D * (4 + 2 + 4 + 2)
    row("cad_add_norm_kernel", "add_norm_plain", k_ms, p_ms, 1e3 * nbytes / HBM_BYTES_PER_S,
        f"bytes: {nbytes / 1e9:.3f} GB", err)
    del r2, want_r, want_u, got_u, h

    # conv: reads x (bf16), writes both directions' outputs (bf16)
    xz, got = cad_in_proj(params, r, lens32)
    want = cad.conv_plain(xz, lengths, params.conv_w[0], params.conv_b[0])
    err = cad_gate("cad_conv_kernel", got, want, rel, 1e-6)
    del want
    k_ms = cuda_time_ms(lambda: cc.conv_cuda(xz, lens32, params.conv_w[0], params.conv_b[0]), 5)
    p_ms = one_call_ms(lambda: cad.conv_plain(xz, lengths, params.conv_w[0], params.conv_b[0]))
    nbytes = 3 * N * CAD_T * E * 2
    row("cad_conv_kernel", "conv_plain", k_ms, p_ms, 1e3 * nbytes / HBM_BYTES_PER_S,
        f"bytes: {nbytes / 1e9:.3f} GB", err)

    # scan: per base and direction E*S exp and E softplus (MUFU), 159,744
    # FLOPs for both directions (conv, dt, scan, D, gate), and xz, dbc in
    # and the gated output out
    args = cad_scan_args(params, xz, got, lens32)
    dbc = args[1]
    del got
    got = cc.scan_cuda(*args)
    t0 = time.perf_counter()
    want = cad.scan_plain(xz, dbc, cad.conv_plain(xz, lengths, params.conv_w[0],
                                                  params.conv_b[0]),
                          lengths, params.w_dt[0], params.b_dt[0], params.a_log[0], params.d[0])
    torch.cuda.synchronize()
    p_ms = 1e3 * (time.perf_counter() - t0)
    err = cad_gate("cad_scan_kernel", got, want, rel, 1e-5 * float(want.abs().max()))
    del want, got
    k_ms = cuda_time_ms(lambda: cc.scan_cuda(*args), 5)
    flops = 159_744 * bases / FP32_FLOPS
    nbytes = N * CAD_T * (2 * E * 2 + 2 * P * 2 + E * 2)
    sfu = cad_scan_bound_s(params, bases)
    bound = max(sfu, flops, nbytes / HBM_BYTES_PER_S)
    row("cad_scan_kernel", "scan_plain (with conv_plain)", k_ms, p_ms, 1e3 * bound,
        "MUFU: exp and softplus" if bound == sfu else "other", err)
    info = cc.scan_info()
    rows[-1].update(info, identity_share=identity_share(lengths.cpu(), info["group"]))
    del args, xz, dbc
    torch.cuda.empty_cache()
    rows.extend(caduceus_scan_buckets(params, rel, info["group"]))
    return rows


def caduceus_scan_buckets(params, rel, group):
    """The scan kernel at each bucket width of the detect cell, a
    micro-batch of that width (models.caduceus.micro_rows) of its bucket's
    lengths, against its plain version and timed -> rows."""
    import torch

    from ribodetector_tpu_torch.models import caduceus as cad
    from ribodetector_tpu_torch.ops import caduceus_cuda as cc

    rows = []
    for T, shortest in CAD_BUCKETS:
        ids, lengths, r = cad_inputs(params, np.random.default_rng(19 + T),
                                     cad.micro_rows(params, T), T, shortest)
        lens32 = lengths.int().contiguous()
        xz, xc = cad_in_proj(params, r, lens32)
        args = cad_scan_args(params, xz, xc, lens32)
        dbc = args[1]
        del r, xc
        got = cc.scan_cuda(*args)
        want = cad.scan_plain(xz, dbc, cad.conv_plain(xz, lengths, params.conv_w[0],
                                                      params.conv_b[0]),
                              lengths, params.w_dt[0], params.b_dt[0], params.a_log[0],
                              params.d[0])
        err = cad_gate(f"cad_scan_kernel at T {T}", got, want, rel,
                       1e-5 * float(want.abs().max()))
        del want, got
        k_ms = cuda_time_ms(lambda: cc.scan_cuda(*args), 5)
        bases = int(lengths.sum())
        bound_ms = 1e3 * cad_scan_bound_s(params, bases)
        rows.append({"name": "cad_scan_kernel", "bucket": T, "lengths": [shortest, T],
                     "B": ids.shape[0], "T": T, "bases": bases, "kernel_ms": k_ms,
                     "bound_ms": bound_ms, "bound_by": "MUFU: exp and softplus",
                     "share": bound_ms / k_ms, "max_abs_err": err,
                     "identity_share": identity_share(lengths.cpu(), group)})
        del args, xz, dbc, ids, lengths
        torch.cuda.empty_cache()
    return rows


def caduceus_detect(params, tmp, n=2048):
    """One detect CLI call on a Caduceus config, launches counted from 0
    just before it, its partition against the plain forward's labels."""
    import torch

    from ribodetector_tpu_torch.cli import main as cli_main
    from ribodetector_tpu_torch.encode import encode_batch
    from ribodetector_tpu_torch.models import caduceus as cad
    from ribodetector_tpu_torch.ops import caduceus_cuda as cc

    rng = np.random.default_rng(18)
    reads = ["".join(rng.choice(list("ACGTN"), int(k), p=[0.24, 0.24, 0.24, 0.24, 0.04]))
             for k in rng.integers(40, 321, n)]
    src = os.path.join(tmp, "cad_in.fa")
    with open(src, "w") as fh:
        fh.writelines(f">r{i}\n{s}\n" for i, s in enumerate(reads))
    npz = os.path.join(tmp, "cad.npz")
    cad.save_params(npz, params)
    cfg = os.path.join(tmp, "cad_cfg.json")
    with open(cfg, "w") as fh:
        json.dump({"name": "cad", "arch": {"type": "CaduceusParams", "args": cad.dims(params)},
                   "state_file": {"mcc": npz, "recall": npz},
                   "runtime": {"semantics": "packed", "compute_dtype": "bfloat16",
                               "kernel": "auto"}}, fh)
    out, rr = os.path.join(tmp, "cad_o.fa"), os.path.join(tmp, "cad_r.fa")
    cc.reset_launches()
    t0 = time.perf_counter()
    cli_main(["-c", cfg, "-l", str(CAD_T), "-i", src, "-o", out, "-r", rr,
              "--buckets", "64,128,192,256,300"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: cc.launches(k) for k in ("conv", "scan", "norm")}
    n_layer = params.w_in.shape[0]
    check(launches["scan"] > 0 and launches["scan"] % n_layer == 0
          and launches["conv"] == launches["scan"]
          and launches["norm"] == (n_layer + 1) * launches["scan"] // n_layer,
          f"caduceus: the detect call launched {launches}")
    tokens, lengths = encode_batch(reads, CAD_T)
    with torch.no_grad():
        want = torch.cat([cad.caduceus_logits(params, torch.from_numpy(tokens[a: a + 512]).cuda(),
                                              torch.from_numpy(lengths[a: a + 512]).cuda(),
                                              torch.bfloat16)
                          for a in range(0, len(reads), 512)]).cpu().numpy()
    label = want.argmax(1)
    margin = np.abs(want[:, 1] - want[:, 0])
    got = {}
    for path, lab in ((out, 0), (rr, 1)):
        with open(path) as fh:
            ids = [int(line[2:]) for line in fh if line.startswith(">")]
        check(ids == sorted(ids), f"caduceus: {path} out of order")
        got.update({i: lab for i in ids})
    check(sorted(got) == list(range(len(reads))), "caduceus: reads lost or doubled")
    sure = np.flatnonzero(margin > 0.02 * np.abs(want).max())
    wrong = sum(got[i] != label[i] for i in sure)
    check(wrong == 0, f"caduceus: {wrong} reads in the other file at a margin above the gap")
    emit("caduceus", run="detect", reads=len(reads), wall_s=wall, launches=launches,
         checked=len(sure))
    return launches


def phase_caduceus(tmp, n=2048):
    """The Caduceus kernels and its detect call -> the kernels line's rows,
    each with its launches in the detect call."""
    import torch

    from ribodetector_tpu_torch.models import caduceus as cad
    from ribodetector_tpu_torch.ops import build

    from ribodetector_tpu_torch.ops import caduceus_cuda as cc

    t0 = time.perf_counter()
    build.caduceus_library()
    path, log = build.build_shared(build.CADUCEUS_SRC, build.nvcc_path(), build.NVCC_FLAGS,
                                   "caduceus_scan")
    ptxas = [l.strip() for l in log.splitlines()
             if "registers" in l or "spill" in l or "Compiling entry" in l]
    emit("caduceus", build_s=time.perf_counter() - t0, key=build.caduceus_library_key(),
         ptxas=ptxas, scan_info=cc.scan_info(), scan_sass=cad_scan_sass(path))
    params = cad.init_params(torch.Generator().manual_seed(3), device="cuda")
    rows = caduceus_kernels(params)
    torch.cuda.empty_cache()
    launches = caduceus_detect(params, tmp, n)
    for r in rows:
        r["launches"] = launches[{"cad_conv_kernel": "conv", "cad_scan_kernel": "scan",
                                  "cad_add_norm_kernel": "norm"}[r["name"]]]
    emit("caduceus", kernels=rows)
    return rows


def phase_card_tests():
    """The jax-free card tests under pytest in a child process, without the
    repo's conftest (it imports jax, which this machine need not have).
    Fails unless pytest exits 0 and every collected test passed, none
    skipped; emits the counts."""
    import glob
    import xml.etree.ElementTree as ET

    files = sorted(os.path.relpath(f, REPO) for f in glob.glob(os.path.join(REPO, CARD_TESTS)))
    check(files, f"no {CARD_TESTS} in the checkout")
    with tempfile.TemporaryDirectory() as tmp:
        report = os.path.join(tmp, "card_tests.xml")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "-q", "-p", "no:cacheprovider",
             f"--junitxml={report}", *files],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        tail = (proc.stdout + proc.stderr)[-3000:]
        check(os.path.exists(report), f"the card tests wrote no report (exit "
                                      f"{proc.returncode}):\n{tail}")
        root = ET.parse(report).getroot()
    suite = root if root.tag == "testsuite" else root.find("testsuite")
    n = {k: int(suite.get(k, 0)) for k in ("tests", "failures", "errors", "skipped")}
    passed = n["tests"] - n["failures"] - n["errors"] - n["skipped"]
    slowest = sorted(((float(c.get("time", 0)), c.get("name")) for c in suite.iter("testcase")),
                     reverse=True)[:5]
    emit("card_tests", files=files, rc=proc.returncode, collected=n["tests"],
         passed=passed, skipped=n["skipped"], failed=n["failures"], errors=n["errors"],
         wall_s=wall, tests_s=float(suite.get("time", 0)),
         slowest=[{"test": name, "s": t} for t, name in slowest])
    check(proc.returncode == 0, f"the card tests exited {proc.returncode}:\n{tail}")
    check(n["skipped"] == 0, f"{n['skipped']} card tests skipped on the card:\n{tail}")
    check(n["tests"] > 0 and passed == n["tests"],
          f"{passed} of {n['tests']} card tests passed:\n{tail}")


def write_pairs(dirname, n, rng, prefix="in", motif=None):
    """Paired gz FASTQ: most pairs clean 100 bp (the 2-bit lane), the rest
    40-99 bp (the 64 bucket or the base-5 lane) or with N / lowercase.
    With `motif`, it is also planted at a random place in one read of
    three on each side (the train phase's models detect it)."""
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
        if motif is not None:
            m = np.frombuffer(motif.encode(), np.uint8)
            rows = np.flatnonzero(rng.random(n) < 1 / 3)
            at = rng.integers(0, lengths[rows] - len(m) + 1)
            mat[rows[:, None], at[:, None] + np.arange(len(m))] = m
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
    """The index of every record in a FASTQ file (4 lines a record, "@r<i>")
    or in a FASTA file as the CLI writes it (2 lines a record, ">r<i>")."""
    op = gzip.open if path.endswith("gz") else open
    with op(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    step = 2 if lines[0].startswith(b">") else 4
    return np.array([int(l[2:]) for l in lines[0::step] if l], np.int64)


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


def outputs(dirname, tag, paired, ensure, ext=".fq"):
    """(argv for -o/-r, {label: files}); norrna outputs gz, rrna plain."""
    sides = (1, 2) if paired else (1,)
    norrna = [os.path.join(dirname, f"{tag}_norrna_{s}{ext}.gz") for s in sides]
    rrna = [os.path.join(dirname, f"{tag}_rrna_{s}{ext}") for s in sides]
    files = {0: norrna, 1: rrna}
    if paired and ensure == "both":
        files[-1] = [f + ".unclassified.gz" for f in norrna]
    return ["-o", *norrna, "-r", *rrna], files


def side_logits(params, seqs, fn, T=100):
    """[n, 2] logits of fn(params, tokens) over reads encoded at T (-l) on
    the card, in calls of 65536 reads."""
    import torch

    from ribodetector_tpu_torch.encode import encode_batch

    tok, _ = encode_batch(seqs, T)
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
    return time.perf_counter() - t0, lstm_cuda.launches()


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
    got = held("main", files, want, margin, wall, 2 * n, pairs=n, data_gen_s=gen_s,
               launches=launches)
    # the probe runs exact once (its reference arm) and high once; a probe
    # that fell back to exact would run every batch on exact instead
    check(launches["exact"] == 1 and launches["high"] >= 2,
          f"the main path's batches did not run on high: {launches}")
    return launches, inputs, got, wall, logits


CONFIG4_LEN = 300
CONFIG4_BUCKETS = [64, 128, 192, 256, 300]  # choose_buckets(300, "auto")


def config4_reads(rng, n, full):
    """n reads of 40-320 bp for configuration 4 (-l 300), as str: lengths
    uniform over 40-300 bp, ~3% of them 301-320 bp (truncated to 300 by
    the parsers), ~3% with three N calls, ~2% with ten lowercase bases,
    and reads 5 and n // 2 all N (on both ends of those pairs: the router
    pins them to the full bucket). The reads where `full` is set are clean
    and exactly 300 bp (a pair takes the FASTQ 2-bit lane when both its
    ends are). tests/test_torch_configs.py makes its reads here too."""
    L = CONFIG4_LEN
    bases = np.frombuffer(b"ACGT", np.uint8)
    lengths = rng.integers(40, L + 1, n)
    kind = rng.random(n)
    over = (kind < 0.03) & ~full
    lengths[over] = rng.integers(L + 1, 321, over.sum())
    lengths[full] = L
    seqs = []
    for i in range(n):
        s = bases[rng.integers(0, 4, lengths[i])].copy()
        if not full[i] and 0.03 <= kind[i] < 0.06:
            s[rng.integers(0, lengths[i], 3)] = ord("N")
        elif not full[i] and 0.06 <= kind[i] < 0.08:
            s[:10] += 32  # lowercase
        seqs.append(s.tobytes().decode())
    seqs[5] = "N" * 120
    seqs[n // 2] = "N" * L
    return seqs


def config4_pairs(n, rng):
    """Configuration 4's pairs: (each side's reads as bytes, `full`, the
    ~10% of pairs clean and exactly 300 bp on both ends)."""
    full = rng.random(n) < 0.10
    full[[5, n // 2]] = False
    return [[s.encode() for s in config4_reads(rng, n, full)] for _ in (1, 2)], full


def fasta(seqs, width=80):
    """FASTA records ">r<i>", the sequence wrapped at `width` bases a line."""
    return b"".join(
        b">r%d\n%s\n" % (i, b"\n".join(s[j: j + width] for j in range(0, len(s), width)))
        for i, s in enumerate(seqs))


def pair_buckets(seqs_per_side, buckets, max_len):
    """Each pair's bucket index as the runner routes it (the larger of its
    ends'), from the reads as the parser encodes them."""
    from ribodetector_tpu_torch import native
    from ribodetector_tpu_torch.encode import encode_batch
    from ribodetector_tpu_torch.runtime.buckets import route_records

    idx = []
    for seqs in seqs_per_side:
        tok, lengths = encode_batch(seqs, max_len)
        idx.append(route_records(lengths, native.pack_b5(tok), buckets, max_len))
    return np.max(idx, axis=0)


def mode_margin(logits, ensure):
    """The margin under which a pair's label may flip: the summed logits'
    under ensure none (the label is their argmax), else the smaller end's."""
    if ensure == "none":
        total = logits[0] + logits[1]
        return np.abs(total[:, 1] - total[:, 0])
    return margin_of(*logits)


def held(phase, files, want, margin, wall, reads, **kw):
    """Reads a CLI run's partition, emits the phase's line (wall and
    reads/s on it) and fails on a mismatch with the plain exact labels
    `want` at a margin >= 5e-3. Returns the partition."""
    got = read_partition(files, len(want))
    bad = got != want
    emit(phase, wall_s=wall, reads=reads, reads_per_s=reads / wall,
         mismatches=int(bad.sum()), mismatches_m5e_3=int(bad[margin >= 5e-3].sum()),
         max_mismatch_margin=float(margin[bad].max(initial=0.0)),
         counts={str(k): int((got == k).sum()) for k in (0, 1, -1)}, **kw)
    check(not bad[margin >= 5e-3].any(),
          f"{kw.get('run', phase)}: partition disagrees with plain exact labels "
          f"at margin >= 5e-3")
    return got


def phase_configs(params, tmp, main_inputs, main_logits, main_wall, n=65536):
    """The JAX package's other documented configurations through the
    detect CLI on the card, each against plain exact labels on the same
    reads under the run's ensure mode: configuration 4 (-l 300, five
    buckets, FASTA and FASTQ.gz), 2-3 (the main phase's pairs under -e
    rrna, norrna and none), 1 (side 1 of them single-end, --chunk_size
    256), and the main phase's pairs at --precision exact (3.3x high's
    kernel time: wall and busy share). Returns each kernel's launches
    summed over the runs (each run counted from 0)."""
    from ribodetector_tpu_torch.ops import dispatch, lstm_cuda
    from ribodetector_tpu_torch.runtime.buckets import choose_buckets
    from ribodetector_tpu_torch.runtime.ensure import paired_final_labels

    t_phase = time.perf_counter()
    total = dict.fromkeys(MODES, 0)

    def cli(argv):
        wall, launches = run_cli(argv)
        for mode, k in launches.items():
            total[mode] += k
        return wall, launches

    L = CONFIG4_LEN
    check(choose_buckets(L, "auto") == CONFIG4_BUCKETS,
          f"unexpected bucket grid at -l {L}: {choose_buckets(L, 'auto')}")
    t0 = time.perf_counter()
    seqs, full = config4_pairs(n, np.random.default_rng(31))
    inputs = {"fasta": [os.path.join(tmp, f"config4_{s}.fa") for s in (1, 2)],
              "fastq_gz": [os.path.join(tmp, f"config4_{s}.fq.gz") for s in (1, 2)]}
    for side, fa, fq in zip(seqs, inputs["fasta"], inputs["fastq_gz"]):
        with open(fa, "wb") as fh:
            fh.write(fasta(side))
        with open(fq, "wb") as fh:
            fh.write(gzip.compress(fastq(side), compresslevel=1))
    gen_s = time.perf_counter() - t0
    # the FASTA parser uppercases (reference quirk #1), the FASTQ one does
    # not: the reads with lowercase bases get their own FASTQ reference
    upper = [[x.upper().decode() for x in side] for side in seqs]
    ref = {"fasta": [side_logits(params, side, exact_logits, T=L) for side in upper]}
    ref["fastq_gz"] = []
    for side, logits in zip(seqs, ref["fasta"]):
        lower = [i for i, x in enumerate(side) if x != x.upper()]
        logits = logits.copy()
        logits[lower] = side_logits(params, [side[i].decode() for i in lower],
                                    exact_logits, T=L)
        ref["fastq_gz"].append(logits)
    routed = pair_buckets(upper, CONFIG4_BUCKETS, L)
    per_bucket = np.bincount(routed, minlength=len(CONFIG4_BUCKETS))
    check((per_bucket > 0).all(), f"a bucket holds no pair: {per_bucket}")

    # a fresh parity-marker cache: the first run at each -l probes
    os.environ["RIBODETECTOR_TPU_TORCH_CACHE"] = os.path.join(tmp, "cache_configs")
    b2_calls = []
    unpack_b2 = dispatch.unpack_b2_tokens

    def counted_b2(packed, max_len):
        b2_calls.append(packed.shape[0])
        return unpack_b2(packed, max_len)

    dispatch.unpack_b2_tokens = counted_b2  # the steps import it when built
    try:
        for fmt in ("fasta", "fastq_gz"):
            logits = ref[fmt]
            want = paired_final_labels(*logits, "both")
            b2_calls.clear()
            out, files = outputs(tmp, f"config4_{fmt}", True, "both",
                                 ext=".fa" if fmt == "fasta" else ".fq")
            wall, launches = cli(["-l", str(L), "-i", *inputs[fmt], *out, "-e", "both"])
            by_t = {t: lstm_cuda.launches(T=t)["high"] for t in CONFIG4_BUCKETS}
            lanes = per_bucket.copy()
            if fmt == "fastq_gz":  # clean 300 bp pairs leave the 300 bucket
                lanes[-1] -= int(full.sum())
            held("configs", files, want, margin_of(*logits), wall, 2 * n,
                 run=f"config4_{fmt}", max_len=L, bucket_pairs=dict(zip(CONFIG4_BUCKETS, lanes.tolist())),
                 b2_lane_pairs=int(full.sum()) if fmt == "fastq_gz" else 0,
                 b2_unpack_calls=len(b2_calls), high_launches_by_T=by_t,
                 launches=launches, data_gen_s=gen_s)
            # every bucket launched high (the 300 one also as the probe's arm
            # in the first run, or beside the 2-bit lane's launch after it)
            check(all(by_t.get(t, 0) >= 1 for t in CONFIG4_BUCKETS) and by_t[L] >= 2,
                  f"config4 {fmt}: high was not launched on every bucket: {by_t}")
            check(launches["exact"] <= 1 and launches["fast"] == launches["fast_bf16"] == 0,
                  f"config4 {fmt}: launched {launches}")
            check(bool(b2_calls) == (fmt == "fastq_gz"),
                  f"config4 {fmt}: {len(b2_calls)} batches on the 2-bit lane")
    finally:
        dispatch.unpack_b2_tokens = unpack_b2

    # configurations 2-3: the main phase's pairs under the other ensure modes
    main_n = len(main_logits[0])
    discordant = int((main_logits[0].argmax(1) != main_logits[1].argmax(1)).sum())
    for ensure in ("rrna", "norrna", "none"):
        out, files = outputs(tmp, f"ensure_{ensure}", True, ensure)
        wall, launches = cli(["-l", "100", "-i", *main_inputs, *out, "-e", ensure])
        held("configs", files, paired_final_labels(*main_logits, ensure),
             mode_margin(main_logits, ensure), wall, 2 * main_n, run=f"ensure_{ensure}",
             discordant_pairs=discordant, launches=launches)
        check(launches["high"] >= 1 and launches["exact"] <= 1,
              f"-e {ensure}: the batches did not run on high: {launches}")

    # configuration 1: side 1 single-end, chunked
    out, files = outputs(tmp, "single_chunked", False, "none")
    wall, launches = cli(["-l", "100", "-i", main_inputs[0], *out, "--chunk_size", "256"])
    held("configs", files, main_logits[0].argmax(1), margin_of(main_logits[0]), wall,
         main_n, run="single_end_chunk_size_256", launches=launches)
    check(launches["high"] >= 1, f"single-end: the batches did not run on high: {launches}")

    # the main phase's pairs at --precision exact (3.3x high's kernel
    # time), and its busy share from a traced rerun (the high run's: the
    # trace phase)
    want = paired_final_labels(*main_logits, "both")
    out, files = outputs(tmp, "exact", True, "both")
    wall, launches = cli(["-l", "100", "-i", *main_inputs, *out, "-e", "both",
                              "--precision", "exact"])
    got = held("configs", files, want, margin_of(*main_logits), wall, 2 * main_n,
               run="precision_exact", launches=launches, high_wall_s=main_wall)
    check(launches["exact"] >= 2 and launches["high"] == 0,
          f"--precision exact launched {launches}")
    busy = traced_run(tmp, "exact_trace", main_inputs, ["--precision", "exact"], got, wall)
    emit("configs", run="precision_exact_trace", high_untraced_wall_s=main_wall, **busy)
    emit("configs", run="phase", wall_s=time.perf_counter() - t_phase, launches=total)
    return total


TRAIN_READS = 8192  # per class: 2 x 8192 training reads
VAL_READS = 1024  # per class
SMALL_READS = 2048  # per class: the custom width's and gloo tp = 2's training reads
EVAL_READS = 65536  # the eval rate's set: the validation set repeated, 16 launches
TRAIN_EPOCHS = 4
RANDOM_INIT_EPOCHS = 3  # the -l 40 run from a random init
TRAIN_BATCH = 200  # the reference checkpoint's batch
TRAIN_LR = 5e-3
MOTIF = "GGAACCTTGGAACC"  # synthetic_dataset's planted motif
# From a random init the motif task at -l 100 sits at ln 2 for many
# epochs, in the JAX package's trainer as in the port's (the two step
# alike until the loss starts to move; experiments/train_witness.py). So
# the -l 100 run fine-tunes the shipped weights (--init), which start at
# chance on the task (checked) and learn it in one epoch, and a run from
# a random init at -l 40, where the task is learned in an epoch, checks
# that training from init_params learns. The hidden-64 run trains from a
# random init too.


def write_fasta(path, tokens, lengths):
    letters = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "wb") as fh:
        fh.write(b"".join(b">t%d\n%s\n" % (i, letters[tokens[i, :lengths[i]]].tobytes())
                          for i in range(len(lengths))))


def labeled_fasta(tmp, rng, max_len=100):
    """FASTA files of the port's synthetic_dataset (label 1 iff the motif
    was planted) at -l max_len: {name: path} for 2 x TRAIN_READS training and
    2 x VAL_READS validation reads, and 2 x SMALL_READS training reads for the
    custom width; plus the training and validation sets' arrays (the
    gradient check and the step timing)."""
    from ribodetector_tpu_torch.train.trainer import synthetic_dataset

    need = TRAIN_READS + VAL_READS
    tok, lengths, labels = synthetic_dataset(rng, 2 * need + 2048, max_len=max_len)
    by_label = {y: np.flatnonzero(labels == y) for y in (0, 1)}
    check(min(len(v) for v in by_label.values()) >= need,
          f"too few reads of one class: {[len(v) for v in by_label.values()]}")
    paths = {}
    for y, name in ((1, "rrna"), (0, "norrna")):
        idx = by_label[y]
        for split, sl in (("train", slice(0, TRAIN_READS)), ("val", slice(TRAIN_READS, need)),
                          ("small", slice(0, SMALL_READS))):
            paths[f"{split}_{name}"] = os.path.join(tmp, f"{split}_{name}_l{max_len}.fa")
            write_fasta(paths[f"{split}_{name}"], tok[idx[sl]], lengths[idx[sl]])
    sets = []
    for sl in (slice(0, TRAIN_READS), slice(TRAIN_READS, need)):
        idx = rng.permutation(np.concatenate([by_label[1][sl], by_label[0][sl]]))
        sets.append((tok[idx], lengths[idx], labels[idx]))
    return paths, sets[0], sets[1]


def counting_optimizers():
    """trainer.make_optimizer wrapped to keep every optimizer it makes ->
    (that list, a function that unwraps it). A run's updates are their
    device step counts (optim.Adam.steps): the update runs inside the
    replayed graph, where no host hook sees it."""
    from ribodetector_tpu_torch.train import trainer

    made, make = [], trainer.make_optimizer

    def spy(*args, **kw):
        made.append(make(*args, **kw))
        return made[-1]

    trainer.make_optimizer = spy
    return made, lambda: setattr(trainer, "make_optimizer", make)


def train_cli(paths, out, extra, max_len=100):
    """The training CLI on the current card (main's path with one card
    visible; with several, main spawns a worker per card, which the
    train_dist phase drives) -> (wall s, launches per kernel, train steps:
    trainer.step_counts() with the optimizer's updates and the bytes the
    run left allocated on the card)."""
    import torch

    from ribodetector_tpu_torch.ops import lstm_cuda
    from ribodetector_tpu_torch.train import trainer
    from ribodetector_tpu_torch.train.__main__ import _train

    lstm_cuda.reset_launches()
    trainer.reset_step_counts()
    made, unwrap = counting_optimizers()
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    try:
        _train(["--rrna", paths["rrna"], "--norrna", paths["norrna"], "-l", str(max_len),
                "--batch", str(TRAIN_BATCH), "--lr", str(TRAIN_LR), "--out", out, *extra],
               "cuda")
        torch.cuda.synchronize()
    finally:
        unwrap()
    wall = time.perf_counter() - t0
    steps = {**trainer.step_counts(), "updates": sum(o.steps() for o in made),
             "left_allocated_bytes": torch.cuda.memory_allocated() - allocated}
    return wall, lstm_cuda.launches(), steps


def check_steps(tag, steps, want, graphed=True):
    """A run's train steps: graphed, one capture (its one shape), a replay
    for each of the `want` updates and the graph released when fit
    returned; or eager, a step for each update and no capture."""
    if graphed:
        ok = (steps["captures"] == 1 and steps["replays"] == steps["updates"] == want
              and steps["eager"] == 0 and steps["released"] == 1)
    else:
        ok = (steps["captures"] == steps["replays"] == 0
              and steps["eager"] == steps["updates"] == want)
    check(ok, f"{tag}: train steps {steps}, not {'one capture and' if graphed else 'eager,'} "
              f"{want} updates")


def profile_step(step):
    """One train step under torch.profiler: the card's kernels (count and
    summed device ms), the host's kernel launches (the runtime's launch
    calls) and its graph launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type == cuda]
    host = [e.name for e in events if e.device_type != cuda]
    return {"device_kernels": len(kernels),
            "device_kernel_ms": sum(e.device_time for e in kernels) / 1e3,
            "host_kernel_launches": sum(n.startswith(("cudaLaunchKernel", "cuLaunchKernel"))
                                        for n in host),
            "host_graph_launches": host.count("cudaGraphLaunch")}


def side_by_side(tag, init, cfg, batch, steps, profile=False):
    """The eager train step and the graphed one (the CLI's), each from its
    own copy of `init` over the same `steps` batches (rows i * TRAIN_BATCH
    onward of the device tensors `batch`), the steps after the first 2
    timed (host clock around work that ends in a synchronize); with
    profile, one more step of each under torch.profiler. Checks their
    per-step losses, params and optimizer state bit for bit, and that the
    graphed step captured once and replayed every step, one update each
    -> {kind: {"step_ms", "steps" (trainer.step_counts() with the
    optimizer's updates), and profile_step's keys}}."""
    import torch

    from ribodetector_tpu_torch.models.bilstm import BiLSTM
    from ribodetector_tpu_torch.train import trainer

    dev = init.w_hh_f.device
    rows = [torch.arange(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH, device=dev)
            for i in range(steps + 1)]
    out, runs = {}, {}
    for kind, graph in (("eager", False), ("graphed", None)):
        model = BiLSTM(init)
        opt = trainer.make_optimizer(cfg, model.parameters())
        step = trainer.make_train_step(cfg, opt, graph=graph)
        trainer.reset_step_counts()

        def one(i):
            return step(model.params(), *batch, rows[i])

        losses = [one(i) for i in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [one(i) for i in range(2, steps)]
        torch.cuda.synchronize()
        out[kind] = {"step_ms": 1e3 * (time.perf_counter() - t0) / (steps - 2),
                     "steps": {**trainer.step_counts(), "updates": opt.steps()}}
        runs[kind] = (torch.stack(losses).cpu(),
                      [p.detach().cpu() for p in (*model.params(), opt.mu, opt.nu)])
        if profile:
            out[kind].update(profile_step(lambda: one(steps)))
        step.release()
    (el, ep), (gl, gp) = runs["eager"], runs["graphed"]
    check(torch.equal(gl, el) and all(torch.equal(a, b) for a, b in zip(gp, ep)),
          f"{tag}: the graphed and the eager step differ: losses {gl.tolist()} against "
          f"{el.tolist()}, params max-abs "
          f"{max(float((a - b).abs().max()) for a, b in zip(gp, ep))}")
    check(out["graphed"]["steps"] == {"captures": 1, "replays": steps, "eager": 0,
                                      "released": 0, "updates": steps}
          and out["eager"]["steps"]["eager"] == out["eager"]["steps"]["updates"] == steps,
          f"{tag}: the side-by-side steps ran as {out}")
    return out


STEP_BATCHES = 22  # 2 warm-up steps (the graph's first captures) + 20 timed
# the graphed step before its update went into the graph (forward and
# backward replayed, then torch.optim's eager Adam), as PERF.md records
# it on an NVIDIA H100 80GB HBM3 at 700 W; emitted beside this run's
GRAPHED_BEFORE_UPDATE = {"step_ms": [25.09, 26.03], "device_kernels_per_step": 8828,
                         "device_busy_share": [0.881, 0.919],
                         "host_kernel_launches_per_step": 10}


def step_rates(params, data, val):
    """The graphed train step (the CLI's) and the eager one side by side at
    batch TRAIN_BATCH over STEP_BATCHES batches (side_by_side: bit for
    bit; steps/s and reads/s over the last 20; the card's kernels and
    their summed time, and the host's kernel and graph launches, in one
    more step of each). Then eval reads/s over the validation set (2 x
    VAL_READS: one launch of exact, latency-bound) and over it repeated to
    EVAL_READS (a user's validation set: EVAL_READS / 4096 launches)."""
    import torch

    from ribodetector_tpu_torch.train.trainer import TrainConfig, evaluate, make_eval_step

    cfg = TrainConfig(learning_rate=TRAIN_LR)
    dev = params.w_hh_f.device
    tok, lengths, labels = (torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in data)
    runs = side_by_side("batch 200, T = 100", params, cfg, (tok, lengths, labels.long()),
                        STEP_BATCHES, profile=True)
    rates = {}
    for kind, prefix in (("graphed", ""), ("eager", "eager_")):
        r = runs[kind]
        check(r["device_kernels"] > 0,
              f"the profiler recorded no kernel on the card in a {kind} train step")
        rates.update({f"{prefix}train_step_ms": r["step_ms"],
                      f"{prefix}train_steps_per_s": 1e3 / r["step_ms"],
                      f"{prefix}train_reads_per_s": 1e3 * TRAIN_BATCH / r["step_ms"],
                      f"{prefix}device_kernels_per_step": r["device_kernels"],
                      f"{prefix}device_kernel_ms_per_step": r["device_kernel_ms"],
                      f"{prefix}device_busy_share": r["device_kernel_ms"] / r["step_ms"],
                      f"{prefix}host_kernel_launches_per_step": r["host_kernel_launches"],
                      f"{prefix}host_graph_launches_per_step": r["host_graph_launches"],
                      f"{kind}_step_counts": r["steps"]})
    check(rates["host_graph_launches_per_step"] == 1
          and rates["host_kernel_launches_per_step"] == 0,
          f"the graphed step did not go out as one graph launch alone: {rates}")
    eval_step = make_eval_step(cfg)
    big = tuple(np.tile(x, (EVAL_READS // len(val[2]),) + (1,) * (x.ndim - 1)) for x in val)
    for name, reads in (("eval_reads_per_s_one_launch", val), ("eval_reads_per_s", big)):
        evaluate(eval_step, params, reads)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate(eval_step, params, reads)
        torch.cuda.synchronize()
        rates[name] = len(reads[2]) / (time.perf_counter() - t0)
    rates["eval_reads"] = len(big[2])
    return rates


# the graphed step's other shapes and settings, against the eager step:
# (name, TrainConfig fields, T, hidden: None for the given weights)
GRAPH_SETTINGS = (("packed", {"semantics": "packed"}, 100, None),
                  ("bfloat16", {"compute_dtype": "bfloat16"}, 100, None),
                  ("T40", {}, 40, None),
                  ("hidden64_random_init", {}, 100, 64))


def graph_settings(params, data, steps=6):
    """side_by_side for each GRAPH_SETTINGS entry over `steps` batches of
    `data` cut to T (tokens past T dropped, lengths clamped) -> {name:
    each step's ms (the last steps - 2)}."""
    import torch

    from ribodetector_tpu_torch.models.bilstm import init_params
    from ribodetector_tpu_torch.train.trainer import TrainConfig

    dev = params.w_hh_f.device
    tok, lengths, labels = (torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in data)
    out = {}
    for name, fields, T, hidden in GRAPH_SETTINGS:
        init = params if hidden is None else init_params(
            torch.Generator().manual_seed(0), hidden=hidden, device=dev)
        batch = (tok[:, :T].contiguous(), lengths.clamp(max=T), labels.long())
        runs = side_by_side(name, init, TrainConfig(learning_rate=TRAIN_LR, **fields), batch,
                            steps)
        out[name] = {f"{kind}_step_ms": runs[kind]["step_ms"] for kind in runs}
    return out


def grad_gap(params, data):
    """max over leaves of max-abs(card - CPU) / max(1, max|g|) of one
    batch's gradients at hidden 128."""
    import torch

    from ribodetector_tpu_torch.models.bilstm import BiLSTMParams
    from ribodetector_tpu_torch.train.trainer import _loss_fn

    grads, losses = [], []
    for dev in (params.w_hh_f.device, "cpu"):
        leaves = BiLSTMParams(*(p.detach().to(dev).requires_grad_(True) for p in params))
        batch = [torch.from_numpy(np.ascontiguousarray(x[:TRAIN_BATCH])).to(dev) for x in data]
        loss, _ = _loss_fn(leaves, *batch, "dense", torch.float32)
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append([p.grad.cpu() for p in leaves])
    worst = {name: float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
             for name, a, b in zip(BiLSTMParams._fields, *grads)}
    return max(worst.values()), worst, losses


def epoch_losses(out, epochs):
    from ribodetector_tpu_torch.models.bilstm import load_params_meta

    return [load_params_meta(os.path.join(out, f"epoch{e:03d}.npz"))["metrics"]["train_loss"]
            for e in range(epochs)]


def detect_with(tmp, npz, tag, inputs):
    """The detect CLI's engine on the card (cli._detect's three calls) with
    `npz` as its weights -> (Predictor, wall s, launches, {label: files})."""
    import torch

    from ribodetector_tpu_torch.cli import build_arg_parser
    from ribodetector_tpu_torch.config import DEFAULT_CONFIG, ConfigParser
    from ribodetector_tpu_torch.ops import lstm_cuda
    from ribodetector_tpu_torch.runtime import Predictor

    with open(DEFAULT_CONFIG) as fh:
        cfg = json.load(fh)
    cfg["state_file"] = {"mcc": npz, "recall": npz}
    out, files = outputs(tmp, tag, True, "both")
    args = build_arg_parser().parse_args(["-l", "100", "-i", *inputs, *out, "-e", "both"])
    lstm_cuda.reset_launches()
    t0 = time.perf_counter()
    pred = Predictor(ConfigParser(cfg), args, device="cuda")
    pred.load_model()
    pred.detect()
    torch.cuda.synchronize()
    return pred, time.perf_counter() - t0, lstm_cuda.launches(), files


def phase_train(tmp):
    """Train on the card through the training CLI, check one step's
    gradients against the CPU, and run what was trained through detect on
    the card: at hidden 128 (exact in every eval step, high in detect) and
    at hidden 64 (the plain recurrence, no kernel). Returns what the
    train_dist phase holds its runs against (dist_reference's keys)."""
    from ribodetector_tpu_torch.models.bilstm import load_params, load_params_meta
    from ribodetector_tpu_torch.runtime.ensure import paired_final_labels
    from ribodetector_tpu_torch.runtime.native_pipeline import resolved_kernel
    from ribodetector_tpu_torch.train.trainer import TrainConfig, evaluate, make_eval_step

    rng = np.random.default_rng(17)
    t0 = time.perf_counter()
    paths, data, val = labeled_fasta(tmp, rng)
    gen_s = time.perf_counter() - t0

    # (a) hidden 128 through the CLI, with a validation set, fine-tuning
    # the shipped weights onto the motif task
    init_acc = evaluate(make_eval_step(TrainConfig()), load_params(NPZ, "cuda"), val)["acc"]
    out = os.path.join(tmp, "train128")
    wall, launches, steps = train_cli(
        {"rrna": paths["train_rrna"], "norrna": paths["train_norrna"]}, out,
        ["--val-rrna", paths["val_rrna"], "--val-norrna", paths["val_norrna"],
         "--epochs", str(TRAIN_EPOCHS), "--init", NPZ])
    losses = epoch_losses(out, TRAIN_EPOCHS)
    best_npz = os.path.join(out, "best.npz")
    best = load_params_meta(best_npz)
    params = load_params(best_npz, "cuda")
    rates = step_rates(params, data, val)
    rates["graph_settings"] = graph_settings(params, data)
    emit("train", run="hidden128", reads=2 * TRAIN_READS, val_reads=2 * VAL_READS,
         epochs=TRAIN_EPOCHS, batch=TRAIN_BATCH, lr=TRAIN_LR, init="shipped weights",
         val_acc_before=init_acc, wall_s=wall, data_gen_s=gen_s,
         epoch_train_loss=losses, best_epoch=best["epoch"],
         best_metrics=best["metrics"], launches=launches, steps=steps, **rates,
         graphed_before_update=GRAPHED_BEFORE_UPDATE)
    check_steps("-l 100", steps, TRAIN_EPOCHS * (2 * TRAIN_READS // TRAIN_BATCH))
    check(init_acc < 0.6, f"the shipped weights already reach val acc {init_acc}")
    check(losses[-1] < losses[0], f"the train loss did not fall: {losses}")
    check(best["metrics"]["acc"] > 0.8, f"best.npz val acc {best['metrics']['acc']} <= 0.8")
    want_exact = TRAIN_EPOCHS * -(-2 * VAL_READS // 4096)  # eval batches of 4096
    check(launches == {**dict.fromkeys(launches, 0), "exact": want_exact},
          f"the eval steps launched {launches}, not exact {want_exact} times alone")

    # (a') hidden 128 from a random init (the CLI's seed 0) at -l 40, where
    # the task is learned within a few epochs
    paths40, _, _ = labeled_fasta(tmp, np.random.default_rng(17), 40)
    out40 = os.path.join(tmp, "train128_l40")
    wall40, launches40, steps40 = train_cli(
        {"rrna": paths40["train_rrna"], "norrna": paths40["train_norrna"]}, out40,
        ["--val-rrna", paths40["val_rrna"], "--val-norrna", paths40["val_norrna"],
         "--epochs", str(RANDOM_INIT_EPOCHS)], max_len=40)
    losses40 = epoch_losses(out40, RANDOM_INIT_EPOCHS)
    best40 = load_params_meta(os.path.join(out40, "best.npz"))
    emit("train", run="hidden128_random_init_l40", reads=2 * TRAIN_READS,
         val_reads=2 * VAL_READS, epochs=RANDOM_INIT_EPOCHS, batch=TRAIN_BATCH, lr=TRAIN_LR,
         init="init_params, seed 0", wall_s=wall40, epoch_train_loss=losses40,
         best_epoch=best40["epoch"], best_metrics=best40["metrics"], launches=launches40,
         steps=steps40)
    check_steps("-l 40", steps40, RANDOM_INIT_EPOCHS * (2 * TRAIN_READS // TRAIN_BATCH))
    check(losses40[-1] < losses40[0], f"-l 40: the train loss did not fall: {losses40}")
    check(best40["metrics"]["acc"] > 0.8,
          f"-l 40 from a random init: best.npz val acc {best40['metrics']['acc']} <= 0.8")
    check(launches40 == {**dict.fromkeys(launches40, 0), "exact": RANDOM_INIT_EPOCHS},
          f"-l 40: the eval steps launched {launches40}, not exact once an epoch alone")

    # (b) one batch's gradients, card against CPU
    gap, per_leaf, batch_losses = grad_gap(params, data)
    emit("train", run="gradients", batch=TRAIN_BATCH, worst_rel_gap=gap,
         per_leaf=per_leaf, loss_card_cpu=batch_losses)
    check(gap <= 1e-4, f"card and CPU gradients differ by {gap} (relative)")

    # (c) best.npz through detect on the card (the main phase's arguments
    # on 2 x 16384 pairs): probe + high
    inputs, seqs = write_pairs(tmp, 16384, np.random.default_rng(23), prefix="trained",
                               motif=MOTIF)
    n = len(seqs[0])
    logits = [side_logits(params, side, exact_logits) for side in seqs]
    want = paired_final_labels(logits[0], logits[1], "both")
    margin = margin_of(*logits)
    pred, dwall, dl, files = detect_with(tmp, best_npz, "trained128", inputs)
    got = read_partition(files, n)
    bad = got != want
    emit("train", run="detect128", pairs=n, wall_s=dwall, launches=dl,
         kernel=resolved_kernel(pred)["kernel"], mismatches=int(bad.sum()),
         mismatches_m5e_3=int(bad[margin >= 5e-3].sum()),
         counts={str(k): int((got == k).sum()) for k in (0, 1, -1)})
    check(dl["exact"] == 1 and dl["high"] >= 2,
          f"detect with best.npz did not run the probe and high: {dl}")
    check(not bad[margin >= 5e-3].any(),
          "best.npz: partition disagrees with plain exact labels at margin >= 5e-3")

    # (d) a custom width: --hidden 64, one epoch of 2 x 2048 reads, then
    # detect on the card with the plain recurrence
    out64 = os.path.join(tmp, "train64")
    wall64, launches64, steps64 = train_cli(
        {"rrna": paths["small_rrna"], "norrna": paths["small_norrna"]}, out64,
        ["--hidden", "64", "--epochs", "1"])
    npz64 = os.path.join(out64, "best.npz")
    params64 = load_params(npz64, "cuda")
    check(tuple(params64.w_hh_f.shape) == (64, 256), "--hidden 64 wrote another width")
    logits = [side_logits(params64, side, exact_logits) for side in seqs]
    want = paired_final_labels(logits[0], logits[1], "both")
    margin = margin_of(*logits)
    marker_dir = os.environ["RIBODETECTOR_TPU_TORCH_CACHE"]
    markers = set(os.listdir(marker_dir)) if os.path.isdir(marker_dir) else set()
    pred, dwall, dl, files = detect_with(tmp, npz64, "trained64", inputs)
    got = read_partition(files, n)
    bad = got != want
    kernel = resolved_kernel(pred)["kernel"]
    new_markers = (set(os.listdir(marker_dir)) if os.path.isdir(marker_dir) else set()) - markers
    emit("train", run="hidden64", reads=2 * SMALL_READS, epochs=1, wall_s=wall64,
         launches=launches64, steps=steps64, detect_wall_s=dwall, detect_launches=dl,
         kernel=kernel, pairs=n, mismatches=int(bad.sum()),
         mismatches_m5e_3=int(bad[margin >= 5e-3].sum()),
         counts={str(k): int((got == k).sum()) for k in (0, 1, -1)})
    check_steps("--hidden 64", steps64, 2 * SMALL_READS // TRAIN_BATCH)
    check(not any(launches64.values()) and not any(dl.values()),
          f"a kernel ran at hidden 64: train {launches64}, detect {dl}")
    check(kernel == "plain" and pred.kernel == "plain", f"hidden 64 resolved to {kernel}")
    check(not new_markers, f"the parity probe ran at hidden 64: {new_markers}")
    check(not bad[margin >= 5e-3].any(),
          "hidden 64: partition disagrees with the plain recurrence at margin >= 5e-3")
    emit("train", run="phase", wall_s=time.perf_counter() - t0)
    return {"paths": paths, "out": out, "inputs": inputs, "seqs": seqs,
            "step_ms": rates["train_step_ms"], "rrna": paths["train_rrna"],
            "norrna": paths["train_norrna"], "reads": 2 * TRAIN_READS}


DIST_EPOCHS = 1  # epochs of each train_dist run (epoch 0 of the train phase's run)
# one rank of a multi-device training run: train.__main__.worker (what the
# CLI's main spawns on each card), with each train step timed (synchronized
# before and after), the rank's kernel launches, train steps and optimizer
# updates (the optimizers' device counts) counted; its last stdout line is
# a JSON object with those and the lines the CLI printed
RANK_CHILD = """
import contextlib, io, json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from ribodetector_tpu_torch.ops import lstm_cuda
from ribodetector_tpu_torch.train import trainer
from ribodetector_tpu_torch.train.__main__ import worker
a, rank = json.loads(sys.argv[2]), int(sys.argv[3])
steps, made = [], []
make, make_optimizer = trainer.make_train_step, trainer.make_optimizer


class Timed:
    def __init__(self, step):
        self.step = step

    def __call__(self, *x):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = self.step(*x)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        return loss

    def release(self):
        self.step.release()


def counted(*args, **kw):
    made.append(make_optimizer(*args, **kw))
    return made[-1]


trainer.make_train_step = lambda *args, **kw: Timed(make(*args, **kw))
trainer.make_optimizer = counted
printed = io.StringIO()
t0 = time.perf_counter()
with contextlib.redirect_stdout(printed):
    worker(rank, a["world"], a["tp"], a["backend"], a["device"], a["argv"], a["init_method"])
print(json.dumps({"rank": rank, "wall_s": time.perf_counter() - t0, "step_s": steps,
                  "launches": lstm_cuda.launches(),
                  "steps": {**trainer.step_counts(),
                            "updates": sum(o.steps() for o in made)},
                  "stdout": printed.getvalue().splitlines()}), flush=True)
"""


def dist_argv(ref, out, tp):
    paths = ref["paths"]
    return ["--rrna", ref["rrna"], "--norrna", ref["norrna"],
            "--val-rrna", paths["val_rrna"], "--val-norrna", paths["val_norrna"],
            "-l", "100", "--batch", str(TRAIN_BATCH), "--lr", str(TRAIN_LR),
            "--epochs", str(DIST_EPOCHS), "--init", NPZ, "--out", out, "--tp", str(tp)]


def dist_reference(tmp):
    """Without the train phase (--cards): its files, and a one-process run
    of the training CLI over them for DIST_EPOCHS on the current card."""
    rng = np.random.default_rng(17)
    paths, _, _ = labeled_fasta(tmp, rng)
    out = os.path.join(tmp, "train128")
    wall, _, steps = train_cli(
        {"rrna": paths["train_rrna"], "norrna": paths["train_norrna"]}, out,
        ["--val-rrna", paths["val_rrna"], "--val-norrna", paths["val_norrna"],
         "--epochs", str(DIST_EPOCHS), "--init", NPZ])
    inputs, seqs = write_pairs(tmp, 16384, np.random.default_rng(23), prefix="trained",
                               motif=MOTIF)
    emit("train_dist", run="one_process_reference", epochs=DIST_EPOCHS, wall_s=wall,
         steps=steps)
    check_steps("one process", steps, DIST_EPOCHS * (2 * TRAIN_READS // TRAIN_BATCH))
    return {"paths": paths, "out": out, "inputs": inputs, "seqs": seqs, "step_ms": None,
            "rrna": paths["train_rrna"], "norrna": paths["train_norrna"],
            "reads": 2 * TRAIN_READS}


def small_reference(tmp, ref):
    """The one-process run of the training CLI for DIST_EPOCHS on the
    current card over the train phase's 2 x SMALL_READS files: the
    reference of the dist runs that take them."""
    paths = ref["paths"]
    out = os.path.join(tmp, "train128_small")
    wall, _, steps = train_cli(
        {"rrna": paths["small_rrna"], "norrna": paths["small_norrna"]}, out,
        ["--val-rrna", paths["val_rrna"], "--val-norrna", paths["val_norrna"],
         "--epochs", str(DIST_EPOCHS), "--init", NPZ])
    emit("train_dist", run="one_process_reference_small", epochs=DIST_EPOCHS,
         reads=2 * SMALL_READS, wall_s=wall, steps=steps)
    check_steps("one process, small files", steps,
                DIST_EPOCHS * (2 * SMALL_READS // TRAIN_BATCH))
    return {**ref, "out": out, "step_ms": None, "rrna": paths["small_rrna"],
            "norrna": paths["small_norrna"], "reads": 2 * SMALL_READS}


def check_dist_run(tag, out, ref, world, mesh, stdout):
    """The run's printed lines, per-epoch losses and best.npz against the
    one-process run (the CPU tests' tolerances), and best.npz through detect
    on the card (probe + high) against plain exact labels."""
    from ribodetector_tpu_torch.models.bilstm import load_params, load_params_meta
    from ribodetector_tpu_torch.runtime.ensure import paired_final_labels

    want_lines = [f"training on {world} devices, mesh {mesh}"]
    if TRAIN_BATCH % mesh["dp"]:
        want_lines.insert(0, f"--batch rounded to {TRAIN_BATCH - TRAIN_BATCH % mesh['dp']} "
                             f"(divisible by dp={mesh['dp']})")
    check(all(line in stdout for line in want_lines),
          f"{tag}: the CLI did not print {want_lines}: {stdout}")
    losses, want = epoch_losses(out, DIST_EPOCHS), epoch_losses(ref["out"], DIST_EPOCHS)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    best = load_params_meta(os.path.join(out, "best.npz"))
    params = load_params(os.path.join(out, "best.npz"), "cuda")
    one = load_params(os.path.join(ref["out"], f"epoch{best['epoch']:03d}.npz"), "cuda")
    param_gap = max(float((a - b).abs().max()) for a, b in zip(params, one))
    n = len(ref["seqs"][0])
    logits = [side_logits(params, side, exact_logits) for side in ref["seqs"]]
    want_labels = paired_final_labels(logits[0], logits[1], "both")
    margin = margin_of(*logits)
    # no parity marker from an earlier run (a run whose best.npz is the same
    # file would find one), so the startup probe runs
    shutil.rmtree(os.environ["RIBODETECTOR_TPU_TORCH_CACHE"], ignore_errors=True)
    _, dwall, dl, files = detect_with(os.path.dirname(out), os.path.join(out, "best.npz"),
                                      f"dist_{tag}", ref["inputs"])
    bad = read_partition(files, n) != want_labels
    result = {"epoch_train_loss": losses, "one_process_loss": want, "loss_rel_gap": loss_gap,
              "best_epoch": best["epoch"], "best_metrics": best["metrics"],
              "param_max_abs_gap": param_gap, "detect_wall_s": dwall,
              "detect_launches": dl, "detect_mismatches": int(bad.sum()),
              "detect_mismatches_m5e_3": int(bad[margin >= 5e-3].sum())}
    check(loss_gap <= 1e-4, f"{tag}: losses {losses} against one process's {want}")
    check(param_gap <= TRAIN_LR, f"{tag}: best.npz differs from one process's by {param_gap}")
    check(best["metrics"]["acc"] > 0.8, f"{tag}: best.npz val acc {best['metrics']['acc']}")
    check(dl["exact"] == 1 and dl["high"] >= 2,
          f"{tag}: detect with best.npz did not run the probe and high: {dl}")
    check(not bad[margin >= 5e-3].any(),
          f"{tag}: best.npz's partition disagrees with plain exact labels at margin >= 5e-3")
    return result


def dist_run(tmp, ref, tag, world, tp, backend, device, smi):
    """One multi-device training run through the worker, one rank child each."""
    from ribodetector_tpu_torch.parallel.mesh import make_dp_tp_mesh

    mesh = make_dp_tp_mesh(tp=tp, devices=range(world)).shape
    out = os.path.join(tmp, f"dist_{tag}", "ck")
    spec = {"world": world, "tp": tp, "backend": backend, "device": device,
            "argv": dist_argv(ref, out, tp), "init_method": f"tcp://127.0.0.1:{free_port()}"}
    t0 = time.perf_counter()
    procs = []
    for rank in range(world):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_CHILD, REPO, json.dumps(spec), str(rank)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        CHILDREN.append(procs[-1])
    reports = [finish(p, f"train_dist {tag} rank {r}", timeout=900)[0]
               for r, p in enumerate(procs)]
    wall = time.perf_counter() - t0
    batch = TRAIN_BATCH - TRAIN_BATCH % mesh["dp"]
    want_exact = DIST_EPOCHS * -(-2 * VAL_READS // 4096)  # eval batches of 4096
    ranks = []
    for r in reports:
        step_s = float(np.median(r["step_s"][1:]))
        ranks.append({"rank": r["rank"], "wall_s": r["wall_s"], "steps": len(r["step_s"]),
                      "step_ms": 1e3 * step_s, "steps_per_s": 1 / step_s,
                      "first_step_ms": 1e3 * r["step_s"][0],
                      "train_reads_per_s": batch // mesh["dp"] / step_s,
                      "launches": r["launches"], "train_steps": r["steps"]})
        # graphed over NCCL (the whole step) and at tp = 1 over gloo (the
        # dp average and the update after the replay), eager at tp > 1 over gloo
        check_steps(f"{tag} rank {r['rank']}", r["steps"],
                    DIST_EPOCHS * (ref["reads"] // batch),
                    graphed=backend == "nccl" or mesh["tp"] == 1)
        check(r["launches"] == {**dict.fromkeys(r["launches"], 0), "exact": want_exact},
              f"{tag} rank {r['rank']}: the eval steps launched {r['launches']}, "
              f"not exact {want_exact} times alone")
    slowest = max(x["step_ms"] for x in ranks) / 1e3
    result = check_dist_run(tag, out, ref, world, mesh, reports[0]["stdout"])
    emit("train_dist", run=tag, backend=backend, device=device, world=world, mesh=mesh,
         card=smi, batch=batch, epochs=DIST_EPOCHS, wall_s=wall, ranks=ranks,
         total_train_reads_per_s=batch / slowest, total_steps_per_s=1 / slowest,
         one_process_step_ms=ref["step_ms"], **result)
    check(not any(r["stdout"] for r in reports[1:]), f"{tag}: a rank other than 0 printed")
    return out


SIDE_STEPS = 10  # batches of the side-by-side check over NCCL; the first 2 untimed
# one rank of the side-by-side check over NCCL (one rank a card): the eager
# rank step and the captured one, each from this rank's shard of the
# shipped weights over the same SIDE_STEPS batches (this rank's dp rows of
# synthetic_dataset reads), each step timed, then one more step of each
# under torch.profiler; its last stdout line is a JSON object
SIDE_CHILD = """
import json, sys, time
from datetime import timedelta
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile
from ribodetector_tpu_torch.models.bilstm import BiLSTM, load_params
from ribodetector_tpu_torch.parallel.mesh import batch_sharded, make_grid
from ribodetector_tpu_torch.train import trainer
a, rank = json.loads(sys.argv[2]), int(sys.argv[3])
torch.cuda.set_device(rank)
dist.init_process_group("nccl", init_method=a["init_method"], world_size=a["world"],
                        rank=rank, timeout=timedelta(seconds=300))
grid = make_grid(a["tp"])
n, B = a["steps"] + 1, a["batch"]
tok, lengths, labels = (torch.from_numpy(x).cuda() for x in trainer.synthetic_dataset(
    np.random.default_rng(a["seed"]), n * B, max_len=100))
labels = labels.long()
rows = [batch_sharded(grid.mesh, "dp")(torch.arange(i * B, (i + 1) * B, device="cuda"),
                                       grid.dp_index) for i in range(n)]
cfg = trainer.TrainConfig(learning_rate=a["lr"])
report, state = {"rank": rank, "at": [grid.dp_index, grid.tp_index]}, {}
for kind, graph in (("eager", False), ("graphed", None)):
    model = BiLSTM(trainer.shard_params(load_params(a["npz"], "cuda"), grid))
    opt = trainer.make_optimizer(cfg, model.parameters())
    step = trainer.make_train_step(cfg, opt, grid, graph=graph)
    trainer.reset_step_counts()
    losses, times = [], []
    for i in range(a["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(model.params(), tok, lengths, labels, rows[i]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    state[kind] = [torch.stack(losses).cpu()] + [
        p.detach().cpu() for p in (*model.params(), opt.mu, opt.nu)]
    steps = {**trainer.step_counts(), "updates": opt.steps()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(model.params(), tok, lengths, labels, rows[-1])
        torch.cuda.synchronize()
    step.release()
    host = [e.name for e in prof.events() if e.device_type != torch.autograd.DeviceType.CUDA]
    report[kind] = {
        "step_ms": 1e3 * float(np.median(times[2:])), "first_step_ms": 1e3 * times[0],
        "steps": steps,
        "host_kernel_launches": sum(x.startswith(("cudaLaunchKernel", "cuLaunchKernel"))
                                    for x in host),
        "host_graph_launches": host.count("cudaGraphLaunch")}
report["bit_for_bit"] = all(torch.equal(x, y) for x, y in zip(state["eager"], state["graphed"]))
report["losses_max_rel_gap"] = float(((state["graphed"][0] - state["eager"][0]).abs()
                                      / state["eager"][0].abs()).max())
report["params_max_abs_gap"] = max(float((x - y).abs().max())
                                   for x, y in zip(state["eager"][1:], state["graphed"][1:]))
print(json.dumps(report), flush=True)
dist.destroy_process_group()
"""


def dist_side_by_side(smi, world, tp):
    """SIDE_CHILD on every card over NCCL at tp: the captured rank step
    (the dp average and tp's collectives inside the graph) against the
    eager one, bit for bit on every rank (losses, params, Adam's state),
    one capture, a replay and an update a step, and a captured step going
    out as one graph launch with no kernel launch."""
    from ribodetector_tpu_torch.parallel.mesh import make_dp_tp_mesh

    mesh = make_dp_tp_mesh(tp=tp, devices=range(world)).shape
    spec = {"world": world, "tp": tp, "steps": SIDE_STEPS, "batch": TRAIN_BATCH,
            "lr": TRAIN_LR, "npz": NPZ, "seed": 29,
            "init_method": f"tcp://127.0.0.1:{free_port()}"}
    t0 = time.perf_counter()
    procs = []
    for rank in range(world):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", SIDE_CHILD, REPO, json.dumps(spec), str(rank)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        CHILDREN.append(procs[-1])
    reports = [finish(p, f"train_dist side by side rank {r}", timeout=600)[0]
               for r, p in enumerate(procs)]
    emit("train_dist", run=f"nccl_side_by_side_tp{tp}", world=world, mesh=mesh, card=smi,
         batch=TRAIN_BATCH, steps=SIDE_STEPS, wall_s=time.perf_counter() - t0, ranks=reports)
    for r in reports:
        tag = f"side by side at tp = {tp}, rank {r['rank']}"
        check(r["bit_for_bit"], f"{tag}: the captured and the eager rank step differ: {r}")
        check(r["graphed"]["steps"] == {"captures": 1, "replays": SIDE_STEPS, "eager": 0,
                                        "released": 0, "updates": SIDE_STEPS}
              and r["eager"]["steps"]["eager"] == r["eager"]["steps"]["updates"] == SIDE_STEPS,
              f"{tag}: the steps ran as {r}")
        check(r["graphed"]["host_graph_launches"] == 1
              and r["graphed"]["host_kernel_launches"] == 0,
              f"{tag}: a captured step did not go out as one graph launch alone: {r}")


def phase_train_dist(tmp, ref, smi):
    """Training over several devices. With two cards or more: the worker
    over every card in an NCCL group at --tp 1 and --tp 2, the captured
    rank step against the eager one at --tp 2, then the training CLI itself
    (main, which spawns the workers) at --tp 2. With one card: the worker
    as two ranks on that card over gloo, at dp = 2 and tp = 2."""
    import torch

    from ribodetector_tpu_torch.models.bilstm import load_params

    n = torch.cuda.device_count()
    if n >= 2:
        dist_run(tmp, ref, f"nccl_dp{n}", n, 1, "nccl", "cuda", smi)
        want = dist_run(tmp, ref, "nccl_tp2", n, 2, "nccl", "cuda", smi)
        dist_side_by_side(smi, n, 2)
        out = os.path.join(tmp, "dist_cli", "ck")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "ribodetector_tpu_torch.train",
                               *dist_argv(ref, out, 2)], cwd=REPO, capture_output=True,
                              text=True, timeout=900)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"the training CLI on {n} cards exited "
                                    f"{proc.returncode}: {proc.stderr[-3000:]}")
        mesh = {"dp": n // 2, "tp": 2} if n % 2 == 0 else {"dp": n, "tp": 1}
        result = check_dist_run("cli_tp2", out, ref, n, mesh, proc.stdout.splitlines())
        gap = max(float((a - b).abs().max()) for a, b in zip(
            load_params(os.path.join(out, "best.npz")), load_params(os.path.join(want, "best.npz"))))
        emit("train_dist", run="cli_tp2", cards=n, card=smi, wall_s=wall,
             best_gap_to_worker_run=gap, **result)
        check(gap <= TRAIN_LR, f"the CLI's best.npz differs from the worker run's by {gap}")
    else:
        dist_run(tmp, ref, "gloo_dp2_one_card", 2, 1, "gloo", "cuda:0", smi)
        # the eager tp step over gloo takes ~740 ms: 20 of them, not 81
        dist_run(tmp, small_reference(tmp, ref), "gloo_tp2_one_card", 2, 2, "gloo",
                 "cuda:0", smi)


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

    # every classify step the server builds (a repeated key would mean the
    # second same-shape job missed the memo), and the stage timer that the
    # jobs of one weight file share, turned on as the CLI's --profile does
    built, timers = [], []
    build, load = Predictor._build_infer_locked, Predictor.load_model

    def load_timed(self):
        self.timer.enabled = True
        timers.append(self.timer)
        return load(self)

    Predictor._build_infer_locked = lambda self, key: built.append(key) or build(self, key)
    Predictor.load_model = load_timed
    lstm_cuda.reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    serve.main(["-l", "100", "--precision", "fast", "--concurrency", "2"],
               stdin=lines, stdout=out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    Predictor._build_infer_locked, Predictor.load_model = build, load
    launches = lstm_cuda.launches()

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
    # the stage breakdown, seconds per thread role and stage summed over the
    # threads (the jobs run on rd-job threads, two at once)
    for timer in timers:
        emit("serve", profile={**{k: round(v, 4) for k, v in timer.totals.items()},
                               **timer.worker_seconds()})
    return launches


def phase_config(params, tmp):
    """The bf16 config, one CLI run over 2 x 16384 pairs, against plain
    exact labels."""
    from ribodetector_tpu_torch.config import DEFAULT_CONFIG
    from ribodetector_tpu_torch.runtime.ensure import paired_final_labels

    inputs, seqs = write_pairs(tmp, 16384, np.random.default_rng(9), prefix="cfg")
    n = len(seqs[0])
    logits = [side_logits(params, side, exact_logits) for side in seqs]
    want = paired_final_labels(logits[0], logits[1], "both")
    margin = margin_of(*logits)
    with open(DEFAULT_CONFIG) as fh:
        cfg = json.load(fh)
    cfg["runtime"]["compute_dtype"] = "bfloat16"
    path = os.path.join(tmp, "config_bf16.json")
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    out, files = outputs(tmp, "bf16", True, "both")
    wall, launches = run_cli(["-c", path, "-l", "100", "-i", *inputs, *out, "-e", "both"])
    bad = read_partition(files, n) != want
    # flips allowed below 0.5: bf16 state moves logits by ~0.1-0.2 against
    # fp32 (the fast_bf16 kernel against exact in the kernels phase)
    emit("config", run="bf16", runtime=cfg["runtime"], pairs=n, wall_s=wall,
         launches=launches, flip_margin_allowed=0.5, mismatches=int(bad.sum()),
         max_mismatch_margin=float(margin[bad].max(initial=0.0)))
    check(not bad[margin >= 0.5].any(),
          "bf16: partition disagrees with exact labels at margin >= 0.5")
    check(launches["fast_bf16"] > 0, "bf16: never launched the fast_bf16 kernel")
    return launches


def phase_trace(tmp, inputs, want, untraced_wall):
    """The main path once more under --trace-dir (trace_busy)."""
    emit("trace", **traced_run(tmp, "trace", inputs, [], want, untraced_wall))


def traced_run(tmp, tag, inputs, extra, want, untraced_wall):
    """The main path's command (with `extra` flags) once more under
    --trace-dir, its partition equal to `want`; the card's busy share is
    the union of its kernel intervals in the trace over the run's wall. The
    profiler's own start and stop lengthen the traced wall, so the share is
    also given over the trace's device window (first kernel start to last
    kernel end) and over the untraced run's wall."""
    trace_dir = os.path.join(tmp, tag)
    out, files = outputs(tmp, tag, True, "both")
    wall, launches = run_cli(["-l", "100", "-i", *inputs, *out, "-e", "both",
                              "--trace-dir", trace_dir, *extra])
    check(np.array_equal(read_partition(files, len(want)), want),
          f"the traced run's partition differs from the untraced one ({tag})")
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
    check(n_kernels > 0, f"the trace holds no kernel of the card ({tag})")
    return dict(wall_s=wall, untraced_wall_s=untraced_wall, trace_span_s=trace_s,
                device_window_s=window_s, launches=launches, kernel_events=n_kernels,
                kernel_busy_s=kernel_s, busy_share=kernel_s / wall,
                busy_share_of_device_window=kernel_s / window_s,
                busy_share_of_untraced_wall=kernel_s / untraced_wall,
                busy_with_copies_s=busy_s, busy_share_with_copies=busy_s / wall,
                top_kernels_s=dict(top))


# the CLI's main in a process of its own; its last stdout line is a JSON
# object with the run's wall (from main's call to the card's last kernel)
# and the kernel launches, in all and per card
CLI_CHILD = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from ribodetector_tpu_torch.cli import main
from ribodetector_tpu_torch.ops import lstm_cuda
t0 = time.perf_counter()
main(sys.argv[2:])
torch.cuda.synchronize()
print(json.dumps({"wall_s": time.perf_counter() - t0,
                  "launches": lstm_cuda.launches(),
                  "card_launches": {str(k): v for k, v in lstm_cuda.card_launches().items()}}),
      flush=True)
"""
CHILDREN = []  # every process started, killed at exit if still running


def spawn(argv):
    """The CLI in a child process (stdout and stderr piped)."""
    proc = subprocess.Popen([sys.executable, "-c", CLI_CHILD, REPO, *argv],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    CHILDREN.append(proc)
    return proc


def finish(proc, what, timeout=600):
    """Wait for a child; fail unless it exited 0. Returns (its JSON line,
    its stderr)."""
    out, err = proc.communicate(timeout=timeout)
    check(proc.returncode == 0, f"{what} exited {proc.returncode}: {err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1]), err


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def decompressed(path):
    op = gzip.open if path.endswith("gz") else open
    with op(path, "rb") as fh:
        return fh.read()


def same_outputs(files, want, what):
    """{label: [file per side]} against the main phase's, decompressed."""
    for label, paths in want.items():
        for got, ref in zip(files[label], paths):
            check(decompressed(got) == decompressed(ref),
                  f"{what}: {os.path.basename(got)} differs from the main phase's output")


def main_argv(tmp, tag, inputs):
    """The main phase's command line, writing to outputs tagged `tag`."""
    out, files = outputs(tmp, tag, True, "both")
    return ["-l", "100", "-i", *inputs, *out, "-e", "both"], files


def phase_resume(tmp, inputs, main_got, main_wall):
    """--resume on the main path: in full (overhead against the main
    phase), and at --chunk_size 1 in full, then killed after >= 2 chunks
    and relaunched."""
    import signal

    _, want = outputs(tmp, "main", True, "both")
    # plain, resume, resume, plain: the manifest's cost against adjacent
    # runs of the same command without it (the main phase's wall also
    # holds the startup probe and the stage timer)
    walls = {"plain": [], "resume": []}
    for kind in ("plain", "resume", "resume", "plain"):
        argv, files = main_argv(tmp, f"resume_{kind}", inputs)
        wall, launches = run_cli(argv + (["--resume"] if kind == "resume" else []))
        same_outputs(files, want, f"resume ({kind} run)")
        walls[kind].append(wall)
        manifest = files[0][0] + ".progress.json"
        check(not os.path.exists(manifest), "the manifest outlived a complete run")
    mean = {k: sum(v) / len(v) for k, v in walls.items()}
    emit("resume", run="full", walls_s=walls, main_wall_s=main_wall,
         overhead=mean["resume"] / mean["plain"] - 1,
         overhead_vs_main=mean["resume"] / main_wall - 1, launches=launches)

    argv, files = main_argv(tmp, "resume_c1", inputs)
    argv += ["--resume", "--chunk_size", "1"]
    c1_wall, c1_launches = run_cli(argv)
    same_outputs(files, want, "resume (--chunk_size 1)")
    emit("resume", run="chunk_size_1", wall_s=c1_wall, launches=c1_launches)

    argv, files = main_argv(tmp, "resume_kill", inputs)
    argv += ["--resume", "--chunk_size", "1"]
    manifest = files[0][0] + ".progress.json"
    proc = spawn(argv)
    done, deadline = 0, time.monotonic() + 300
    while done < 2:
        if proc.poll() is not None:
            fail(f"the run ended (exit {proc.returncode}) before 2 chunks were "
                 f"recorded, so it could not be interrupted: "
                 f"{proc.stderr.read()[-2000:]}")
        check(time.monotonic() < deadline, "no 2 completed chunks within 300 s")
        if os.path.exists(manifest):
            with open(manifest) as fh:
                done = json.load(fh)["chunks_done"]
        time.sleep(0.005)
    proc.send_signal(signal.SIGKILL)
    proc.communicate()
    with open(manifest) as fh:
        killed_at = json.load(fh)
    check(killed_at["records_done"] < len(main_got),
          f"the killed run had finished: {killed_at}")
    res, _ = finish(spawn(argv), "the relaunched --resume run")
    same_outputs(files, want, "resume (killed, relaunched)")
    check(not os.path.exists(manifest), "the manifest outlived the relaunched run")
    emit("resume", run="killed_relaunched", killed_after_chunks=killed_at["chunks_done"],
         killed_after_records=killed_at["records_done"], relaunch_wall_s=res["wall_s"],
         relaunch_launches=res["launches"], full_run_high=c1_launches["high"])
    check(0 < res["launches"]["high"] < c1_launches["high"],
          f"the relaunch launched high {res['launches']['high']} times, a full "
          f"run {c1_launches['high']}")


def logged_summary(err, after):
    """The summary counts logged after the line holding `after`."""
    text = re.sub(r"\x1b\[[0-9;]*m", "", err.split(after, 1)[1])
    grab = {"num_read": r"Processed (\d+) sequences", "norrna": r"Detected (\d+) non-rRNA",
            "rrna": r"Detected (\d+) rRNA", "unclf": r"Discarded (\d+) unclassified"}
    return {k: int(re.search(v, text).group(1)) for k, v in grab.items()}


def phase_hosts(tmp, inputs, main_got):
    """Two hosts on the one card over the main path: coordinated (a gloo
    group; host 0 merges) and uncoordinated (per-host shards)."""
    _, want = outputs(tmp, "main", True, "both")
    want_counts = {"num_read": len(main_got), "norrna": int((main_got == 0).sum()),
                   "rrna": int((main_got == 1).sum()), "unclf": int((main_got == -1).sum())}

    argv, files = main_argv(tmp, "hosts_coord", inputs)
    port = free_port()
    t0 = time.perf_counter()
    procs = [spawn(argv + ["--hosts", "2", "--host-id", str(h), "--coordinator",
                           f"127.0.0.1:{port}", "--num-hosts", "2"]) for h in (0, 1)]
    res = [finish(p, f"coordinated host {h}") for h, p in enumerate(procs)]
    pair_wall = time.perf_counter() - t0
    same_outputs(files, want, "hosts (coordinated)")
    counts = logged_summary(res[0][1], "Merged outputs from 2 hosts")
    emit("hosts", run="coordinated", pair_wall_s=pair_wall,
         hosts=[{"host": h, "wall_s": r["wall_s"], "high": r["launches"]["high"]}
                for h, (r, _) in enumerate(res)], merged_counts=counts)
    check(counts == want_counts, f"host 0's summary {counts} is not the main "
                                 f"phase's {want_counts}")
    check(all(r["launches"]["high"] > 0 for r, _ in res), "a host never launched high")
    leftovers = [f for f in os.listdir(tmp) if ".parts" in f]
    check(not leftovers, f"parts left behind: {leftovers}")

    argv, files = main_argv(tmp, "hosts_shards", inputs)
    t0 = time.perf_counter()
    procs = [spawn(argv + ["--hosts", "2", "--host-id", str(h)]) for h in (0, 1)]
    res = [finish(p, f"uncoordinated host {h}") for h, p in enumerate(procs)]
    pair_wall = time.perf_counter() - t0

    def shard(path, h):
        k = f"host{h:03d}"
        return path[: -len("gz")] + k + ".gz" if path.endswith("gz") else path + "." + k

    norrna = files[0]
    for label, paths in files.items():
        for path in paths:
            if label == -1:  # <output>.unclassified.gz of each host's output
                side = [p + ".unclassified.gz" for p in norrna].index(path)
                parts = [shard(norrna[side], h) + ".unclassified.gz" for h in (0, 1)]
            else:
                parts = [shard(path, h) for h in (0, 1)]
            with open(path, "wb") as dst:
                for part in parts:
                    with open(part, "rb") as src:
                        shutil.copyfileobj(src, dst)
    same_outputs(files, want, "hosts (uncoordinated shards, concatenated)")
    emit("hosts", run="uncoordinated", pair_wall_s=pair_wall,
         hosts=[{"host": h, "wall_s": r["wall_s"], "high": r["launches"]["high"]}
                for h, (r, _) in enumerate(res)])
    check(all(r["launches"]["high"] > 0 for r, _ in res), "a host never launched high")


def phase_cards(tmp, inputs):
    """The main path split over two cards (-d 0,1), where there are two."""
    import torch

    from ribodetector_tpu_torch.ops import lstm_cuda

    n = torch.cuda.device_count()
    if n < 2:
        emit("cards", skipped=f"{n} CUDA device visible")
        return
    _, want = outputs(tmp, "main", True, "both")
    argv, files = main_argv(tmp, "cards", inputs)
    wall, launches = run_cli(argv + ["-d", "0,1"])
    per_card = lstm_cuda.card_launches()
    same_outputs(files, want, "cards (-d 0,1)")
    emit("cards", cards=2, wall_s=wall, launches=launches, card_launches=per_card)
    check(all(per_card.get(k, {}).get("high", 0) > 0 for k in (0, 1)),
          f"high was not launched on both cards: {per_card}")
    serve_cards(tmp, inputs)

    # --precision exact (3.3x high's kernel time) on one card and at -d 0,1
    walls, files = {}, {}
    for tag, extra in (("exact_one_card", []), ("exact_cards", ["-d", "0,1"])):
        argv, files[tag] = main_argv(tmp, tag, inputs)
        walls[tag], launches = run_cli(argv + ["--precision", "exact", *extra])
        check(launches["exact"] >= 2 and launches["high"] == 0,
              f"--precision exact {extra} launched {launches}")
    per_card = lstm_cuda.card_launches()
    same_outputs(files["exact_cards"], files["exact_one_card"], "cards (--precision exact)")
    emit("cards", run="precision_exact", cards=2, wall_s=walls["exact_cards"],
         one_card_wall_s=walls["exact_one_card"], reads=2 * len(read_indices(inputs[0])),
         card_launches=per_card)
    check(all(per_card.get(k, {}).get("exact", 0) > 0 for k in (0, 1)),
          f"--precision exact -d 0,1 did not launch exact on both cards: {per_card}")


def serve_cards(tmp, inputs):
    """serve.main over the main phase's pairs on one card and at -d 0,1:
    the same partitions, byte for byte, and high launched on both cards."""
    import torch

    from ribodetector_tpu_torch import serve
    from ribodetector_tpu_torch.ops import lstm_cuda

    files, walls = {}, {}
    for tag, extra in (("serve_one_card", []), ("serve_cards", ["-d", "0,1"])):
        out, files[tag] = outputs(tmp, tag, True, "both")
        job = {"id": tag, "input": inputs, "output": out[1:out.index("-r")],
               "rrna": out[out.index("-r") + 1:], "ensure": "both"}
        lstm_cuda.reset_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        serve.main(["-l", "100", *extra], stdin=[json.dumps(job) + "\n"], stdout=buf)
        torch.cuda.synchronize()
        walls[tag] = time.perf_counter() - t0
        resp = json.loads(buf.getvalue().splitlines()[0])
        check(resp["status"] == "ok", f"serve {extra}: {resp}")
    per_card = lstm_cuda.card_launches()
    same_outputs(files["serve_cards"], files["serve_one_card"], "serve -d 0,1")
    emit("cards", run="serve", cards=2, wall_s=walls["serve_cards"],
         one_card_wall_s=walls["serve_one_card"], card_launches=per_card)
    check(all(per_card.get(k, {}).get("high", 0) > 0 for k in (0, 1)),
          f"serve -d 0,1 did not launch high on both cards: {per_card}")


def main(argv):
    quick = "--quick" in argv
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, REPO)
    import ribodetector_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = phase_env()
    if "--caduceus" in argv:
        with tempfile.TemporaryDirectory() as tmp:
            rows = phase_caduceus(tmp)
        print(json.dumps({"kernels": rows}), flush=True)
        print(smi, flush=True)
        emit("caduceus_only", done=True)
        return
    sass = phase_build()
    from ribodetector_tpu_torch.models import load_params

    params = load_params(NPZ, "cuda")
    walls = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        return out

    if "--cards" in argv:
        check(torch.cuda.device_count() >= 2, "--cards needs two CUDA cards")
        with tempfile.TemporaryDirectory() as tmp:
            _, main_inputs, _, _, _ = timed("main", phase_main, params, tmp)
            timed("cards", phase_cards, tmp, main_inputs)
            # the training runs' launch counts are each rank child's own
            timed("train_dist", lambda: phase_train_dist(tmp, dist_reference(tmp), smi))
        emit("walls", **walls)
        return
    max_err, tc_plain = timed("kernels", phase_kernels, params, quick)
    times = timed("timing", phase_timing, params, quick, tc_plain, sass)
    with tempfile.TemporaryDirectory() as tmp:
        cad_rows = timed("caduceus", phase_caduceus, tmp)
    timed("card_tests", phase_card_tests)
    if quick:
        emit("walls", **walls)
        emit("quick", done=True)
        return
    with tempfile.TemporaryDirectory() as tmp:
        # each path's launches are counted from 0 just before it runs
        launches, main_inputs, main_got, main_wall, main_logits = timed(
            "main", phase_main, params, tmp)
        # every run's launches are counted from 0; their sums join main's
        for mode, n in timed("configs", phase_configs, params, tmp, main_inputs,
                             main_logits, main_wall).items():
            launches[mode] += n
        train_ref = timed("train", phase_train, tmp)
        # each rank child counts its own launches, from 0
        timed("train_dist", phase_train_dist, tmp, train_ref, smi)
        launches["fast"] = timed("serve", phase_serve, params, tmp)["fast"]
        launches["fast_bf16"] = timed("config", phase_config, params, tmp)["fast_bf16"]
        timed("trace", phase_trace, tmp, main_inputs, main_got, main_wall)
        timed("resume", phase_resume, tmp, main_inputs, main_got, main_wall)
        timed("hosts", phase_hosts, tmp, main_inputs, main_got)
        timed("cards", phase_cards, tmp, main_inputs)
    emit("walls", **walls)
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
    ] + cad_rows
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    try:
        main(sys.argv[1:])
    finally:
        for child in CHILDREN:
            if child.poll() is None:
                child.kill()
                child.wait()
