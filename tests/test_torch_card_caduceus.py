"""The Caduceus kernels on the card (csrc/caduceus_scan.cu through
ops/caduceus_cuda.py) at the published widths, against their plain
versions, and the detect CLI through them. Needs a CUDA card and skips
without one; imports neither jax nor the JAX package, and needs none of
tests/conftest.py:

    python3 -m pytest --noconftest -q tests/test_torch_card_caduceus.py
"""

import json
import os

import numpy as np
import pytest
import torch

from ribodetector_tpu_torch.models import caduceus as cad

pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")]

T = 300
# bf16 rounding of a kernel's output: half an ulp (2^-9 relative) each way,
# and the fp32 arithmetic's other order and ex2.approx (~1e-6 relative)
BF16_REL = 2.0 ** -8


@pytest.fixture(scope="module")
def params():
    return cad.init_params(torch.Generator().manual_seed(3), device="cuda")


def lengths_of(n, rng):
    lengths = rng.integers(1, T + 1, n)
    lengths[:4] = (0, 1, T, T - 1)
    return torch.from_numpy(lengths).cuda()


def in_proj(params, n, rng):
    """A bf16 in-projection output [n, T, 2E] of random tokens."""
    tok = torch.from_numpy(rng.integers(0, 5, (n, T)).astype(np.uint8)).cuda()
    u = cad.rms_norm(params.embedding[cad.read_ids(tok, torch.full((n,), T).cuda())],
                     params.norm_g[0])
    return torch.matmul(u.bfloat16(), params.w_in[0].bfloat16())


def test_conv_kernel_against_plain(params):
    from ribodetector_tpu_torch.ops import caduceus_cuda as cc

    rng = np.random.default_rng(0)
    xz = in_proj(params, 96, rng)
    lengths = lengths_of(96, rng)
    got = cc.conv_cuda(xz, lengths.int(), params.conv_w[0], params.conv_b[0]).float()
    want = cad.conv_plain(xz, lengths, params.conv_w[0], params.conv_b[0])
    assert torch.all((got - want).abs() <= BF16_REL * want.abs() + 1e-6)


def scan_args(params, lengths, rng):
    """scan_cuda's arguments for rows of these lengths at width T (the
    first layer's, from random tokens), and the conv's plain output."""
    from ribodetector_tpu_torch.ops import caduceus_cuda as cc

    xz = in_proj(params, len(lengths), rng)
    xc = cad.conv_plain(xz, lengths, params.conv_w[0], params.conv_b[0])
    dbc = (xc.bfloat16() @ params.w_x[0].bfloat16()[:, None]).contiguous()
    a2 = (-torch.exp(params.a_log[0]) * cc.LOG2E).contiguous()
    return (xz, dbc, lengths.int(), params.conv_w[0], params.conv_b[0], params.w_dt[0],
            params.b_dt[0], a2, params.d[0]), xc


def assert_scan_matches_plain(params, lengths, rng):
    """The scan kernel within bf16's rounding of scan_plain on [0, L) and
    exactly 0 past each row's length."""
    from ribodetector_tpu_torch.ops import caduceus_cuda as cc

    args, xc = scan_args(params, lengths, rng)
    got = cc.scan_cuda(*args).float()
    want = cad.scan_plain(args[0], args[1], xc, lengths, params.w_dt[0], params.b_dt[0],
                          params.a_log[0], params.d[0])
    scale = want.abs().max()
    assert torch.all((got - want).abs() <= BF16_REL * want.abs() + 1e-5 * scale)
    past = torch.arange(T, device="cuda")[None, :] >= lengths[:, None]
    assert torch.all(got[past] == 0)


def test_scan_kernel_against_plain(params):
    rng = np.random.default_rng(1)
    assert_scan_matches_plain(params, lengths_of(64, rng), rng)


def test_scan_softplus_and_silu_are_the_plain_ones():
    """The scan kernel's branch-free softplus and SiLU give the bits of
    v > 20 ? v : log1pf(__expf(v)) and of the conv kernel's SiLU for every
    float32 input."""
    from ribodetector_tpu_torch.ops import caduceus_cuda as cc

    assert cc.scan_arith_check() == (0, 0)


def boundary_lengths():
    """Every boundary of the scan kernel's schedule: its step group U and
    staged chunk TC (as built), and the batch's width T."""
    from ribodetector_tpu_torch.ops import caduceus_cuda as cc

    info = cc.scan_info()
    U, C = info["group"], info["chunk"]
    return sorted({0, 1, U - 1, U, U + 1, C - 1, C, C + 1, 2 * C + U - 1, T - 1, T})


def test_scan_kernel_at_boundary_lengths(params):
    """Rows whose lengths sit on the group's, the chunk's and the batch's
    edges, each three times, against scan_plain."""
    lengths = torch.tensor(boundary_lengths() * 3, device="cuda")
    assert_scan_matches_plain(params, lengths, np.random.default_rng(6))


def test_scan_kernel_rows_independent_of_padding(params):
    """A row's output on [0, L) is the same bits whether it is computed in
    a T-wide batch beside other rows or alone at width L, and two
    launches give the same bits."""
    from ribodetector_tpu_torch.ops import caduceus_cuda as cc

    rng = np.random.default_rng(7)
    lengths = torch.tensor([L for L in boundary_lengths() if L > 0]
                           + rng.integers(1, T + 1, 6).tolist(), device="cuda")
    args, _ = scan_args(params, lengths, rng)
    got = cc.scan_cuda(*args)
    assert torch.equal(got, cc.scan_cuda(*args))
    xz, dbc = args[0], args[1]
    for i, L in enumerate(lengths.tolist()):
        alone = cc.scan_cuda(xz[i:i + 1, :L].contiguous(), dbc[:, i:i + 1, :L].contiguous(),
                             lengths[i:i + 1].int(), *args[3:])
        assert torch.equal(alone[0], got[i, :L]), f"row {i} (L = {L})"


def test_kernel_path_against_plain(params):
    """The whole forward: the kernel path against its plain version in
    the configuration's precision, on 48 reads; the same reads padded with
    rows of no bases and 64 more columns give the same logits to cuBLAS's
    order (the products' shapes change), and rows of no bases read 0."""
    from ribodetector_tpu_torch.ops import caduceus_cuda as cc

    rng = np.random.default_rng(2)
    n = 48
    lengths = lengths_of(n, rng)
    tok = torch.from_numpy(rng.integers(0, 5, (n, T)).astype(np.uint8)).cuda()
    tok[torch.arange(T, device="cuda")[None, :] >= lengths[:, None]] = 4
    got = cc.caduceus_logits_cuda(params, tok, lengths)
    want = cad.caduceus_logits(params, tok, lengths, torch.bfloat16)
    scale = want.abs().max()
    assert (got - want).abs().max() <= 0.02 * scale
    wide = torch.full((n + 16, T + 64), 4, dtype=torch.uint8, device="cuda")
    wide[:n, :T] = tok
    wl = torch.cat([lengths, torch.zeros(16, dtype=lengths.dtype, device="cuda")])
    got_wide = cc.caduceus_logits_cuda(params, wide, wl)
    assert (got_wide[:n] - got).abs().max() <= 0.02 * scale
    assert torch.all(got_wide[n:] == 0)
    assert torch.all(got[0] == 0)  # length 0


def test_detect_cli_runs_the_kernels(tmp_path, params):
    """cli.main on a Caduceus config: every read in its reference label's
    file (the plain forward in the configuration's precision, margins
    above the kernels' gap), and the kernels launched."""
    from ribodetector_tpu_torch import cli
    from ribodetector_tpu_torch.encode import encode_batch
    from ribodetector_tpu_torch.ops import caduceus_cuda as cc

    npz = str(tmp_path / "cad.npz")
    cad.save_params(npz, params)
    rng = np.random.default_rng(4)
    reads = ["".join(rng.choice(list("ACGTN"), int(k))) for k in rng.integers(40, 321, 300)]
    with open(tmp_path / "in.fa", "w") as fh:
        fh.writelines(f">r{i}\n{s}\n" for i, s in enumerate(reads))
    cfg = {"name": "cad", "arch": {"type": "CaduceusParams", "args": cad.dims(params)},
           "state_file": {"mcc": npz, "recall": npz},
           "runtime": {"semantics": "packed", "compute_dtype": "bfloat16", "kernel": "auto"}}
    with open(tmp_path / "cfg.json", "w") as fh:
        json.dump(cfg, fh)
    cc.reset_launches()
    out, rr = str(tmp_path / "o.fa"), str(tmp_path / "r.fa")
    cli.main(["-c", str(tmp_path / "cfg.json"), "-l", str(T), "-i", str(tmp_path / "in.fa"),
              "-o", out, "-r", rr, "--buckets", "64,128,192,256,300"])
    assert cc.launches("scan") > 0 and cc.launches("conv") == cc.launches("scan")
    assert cc.launches("norm") == 17 * cc.launches("scan") // 16
    tokens, lengths = encode_batch(reads, T)
    with torch.no_grad():
        want = cad.caduceus_logits(params, torch.from_numpy(tokens).cuda(),
                                   torch.from_numpy(lengths).cuda(), torch.bfloat16).cpu().numpy()
    label = want.argmax(1)
    margin = np.abs(want[:, 1] - want[:, 0])
    got = {}
    for path, lab in ((out, 0), (rr, 1)):
        with open(path) as fh:
            ids = [int(line[2:]) for line in fh if line.startswith(">")]
        assert ids == sorted(ids)
        got.update({i: lab for i in ids})
    assert sorted(got) == list(range(len(reads)))
    sure = margin > 0.02 * np.abs(want).max()
    assert all(got[i] == label[i] for i in np.flatnonzero(sure))
    assert os.path.getsize(out) + os.path.getsize(rr) > 0


def test_step_of_sorted_trimmed_micro_batches(tmp_path, params, monkeypatch):
    """The Predictor's step on the card over a call like the benchmark's
    (40-300 bp, a tenth at 300, rows of no bases), its micro-batches cut by
    read length (several a width: the activation budget shrunk), against
    one untrimmed caduceus_logits_cuda call at width T over the same rows:
    the same labels, logits to cuBLAS's order (test_kernel_path_against_plain's
    tolerance), rows of no bases 0."""
    from ribodetector_tpu_torch import cli
    from ribodetector_tpu_torch.config import ConfigParser
    from ribodetector_tpu_torch.ops import caduceus_cuda as cc
    from ribodetector_tpu_torch.runtime import Predictor

    rng = np.random.default_rng(8)
    n = 600
    lengths = rng.integers(40, T + 1, n)
    lengths[rng.random(n) < 0.1] = T
    lengths[rng.choice(n, 8, replace=False)] = 0
    lengths = torch.from_numpy(lengths).cuda()
    tok = torch.from_numpy(rng.integers(0, 5, (n, T)).astype(np.uint8)).cuda()
    tok[torch.arange(T, device="cuda")[None, :] >= lengths[:, None]] = 4
    npz = str(tmp_path / "cad.npz")
    cad.save_params(npz, params)
    cfg = {"name": "cad", "arch": {"type": "CaduceusParams", "args": cad.dims(params)},
           "state_file": {"mcc": npz, "recall": npz},
           "runtime": {"semantics": "packed", "compute_dtype": "bfloat16", "kernel": "auto"}}
    args = cli.build_arg_parser().parse_args(["-l", str(T), "-i", "x.fa", "-o", "y.fa"])
    pred = Predictor(ConfigParser(cfg), args, device="cuda")
    pred.load_model()
    pred.timer.enabled = True
    monkeypatch.setattr(cad, "ACTIVATION_BYTES", 64 * cad.bytes_per_token(params) * 2 * T)
    cc.reset_launches()
    got = pred._build_infer(emit="logits")(tok, lengths)
    cuts = pred.timer.counters["cad.micro_batches"]
    assert cuts > (T - 40) // cad.WIDTH_STEP and cc.launches("scan") == 16 * cuts
    want = cc.caduceus_logits_cuda(params, tok, lengths)
    scale = want.abs().max()
    print(f"\nsorted, trimmed step vs one untrimmed call: {cuts} micro-batches, "
          f"bit for bit {torch.equal(got, want)}, max gap {float((got - want).abs().max()):.3g} "
          f"of logits up to {float(scale):.3g}")
    assert (got - want).abs().max() <= 0.02 * scale
    assert torch.equal(got.argmax(1), want.argmax(1))
    assert torch.all(got[lengths == 0] == 0)


def test_add_norm_kernel_against_plain(params):
    from ribodetector_tpu_torch.ops import caduceus_cuda as cc

    g = torch.Generator(device="cuda").manual_seed(5)
    r = torch.randn(3, 100, 256, device="cuda", generator=g)
    h = torch.randn(3, 100, 256, device="cuda", generator=g).bfloat16()
    want_r, want_u = cad.add_norm_plain(r, h, params.norm_g[1] * 1.5)
    r2 = r.clone()
    got = cc.add_norm_cuda(r2, h, params.norm_g[1] * 1.5)
    assert torch.equal(r2, want_r)  # one fp32 add, the same on both sides
    assert torch.all((got.float() - want_u).abs() <= BF16_REL * want_u.abs() + 1e-6)
    first = cc.add_norm_cuda(r.clone(), None, params.norm_f, torch.float32)
    assert torch.allclose(first, cad.add_norm_plain(r, None, params.norm_f)[1],
                          rtol=1e-5, atol=1e-6)
