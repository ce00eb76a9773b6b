"""Caduceus-Ph in the port (models/caduceus.py, the Predictor's classify
step, the detect CLI) against the benchmark's plain reference
(benchmark/reference/caduceus.py, imported with benchmark/ on sys.path: the
repository holds one Caduceus reference), at a small size on the CPU:
d_model 16, 2 layers, d_state 4, dt_rank 2, weights drawn by the
reference's init from a seed and read by both sides from one npz.
"""

import gzip
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "benchmark"))

from reference import caduceus as cref  # noqa: E402
from reference import model as bref  # noqa: E402

from ribodetector_tpu_torch import cli  # noqa: E402
from ribodetector_tpu_torch.models import arch_of, caduceus as cad, load_params  # noqa: E402

MODEL = {"d_model": 16, "n_layer": 2, "vocab_size": 16, "d_state": 4, "d_conv": 4,
         "expand": 2, "dt_rank": 2, "num_classes": 2}
LEN = 32
BUCKETS = "16,32"
# fp32 on both sides: the port's plain forward and the reference sum in
# other orders (the reverse direction's gather, the tied products once or
# per strand), so logits agree to fp32 rounding over two layers, ~1e-8 of
# logits of ~0.1; 1e-5 leaves room and is far below any change of the
# mathematics (a dropped D skip or conv tap moves them by ~1e-3)
TOL = 1e-5


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cad") / "cad.npz")
    cref.save(path, cref.init(11, MODEL), MODEL)
    return path


def config(tmp_path, weights, **runtime):
    cfg = {"name": "cad", "arch": {"type": "CaduceusParams", "args": MODEL},
           "state_file": {"mcc": weights, "recall": weights},
           "runtime": {"semantics": "packed", "compute_dtype": "float32", "kernel": "auto",
                       **runtime}}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def reads(rng, n):
    """Lengths 1..LEN + 8 (some past -l), N inside and at the end, all-N
    reads, lower-case bases (no call in FASTQ)."""
    out = []
    for i in range(n):
        k = 1 + i % (LEN + 8)
        s = rng.choice(list("ACGT"), k)
        if i % 5 == 1:
            s[rng.integers(0, k)] = "N"
        if i % 7 == 2:
            s[-1] = "N"
        if i % 11 == 3:
            s[:] = "N"
        if i % 13 == 4:
            s[: min(3, k)] = [c.lower() for c in s[: min(3, k)]]
        out.append("".join(s))
    return out


def ref_tokens(seqs, fasta):
    lengths = np.array([len(s) for s in seqs])
    width = max(LEN, lengths.max())
    b = np.full((len(seqs), width), ord("A"), np.uint8)
    for i, s in enumerate(seqs):
        b[i, : len(s)] = np.frombuffer(s.encode(), np.uint8)
    return bref.encode(b, lengths, LEN, fasta), np.minimum(lengths, LEN)


def one_at_a_time(w, tokens, lengths):
    return np.stack([cref.one_read(w, torch.from_numpy(t.astype(np.int64)), int(n)).numpy()
                     if n else np.zeros(2, np.float32) for t, n in zip(tokens, lengths)])


def write(path, seqs, fmt):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "wt") as fh:
        for i, s in enumerate(seqs):
            fh.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n" if fmt == "fastq" else f">r{i}\n{s}\n")


def ids_in(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as fh:
        return [int(line[2:]) for line in fh if line[:1] in "@>" and line[1:2] == "r"]


def record_classify(monkeypatch):
    """Every classify call's (tokens, lengths, logits) through the one
    function both models' calls pass (ops.classify_logits)."""
    import ribodetector_tpu_torch.ops as ops

    rows, orig = [], ops.classify_logits

    def classify_logits(params, tokens, lengths=None, *a, **kw):
        out = orig(params, tokens, lengths, *a, **kw)
        rows.append((tokens.numpy().copy(), lengths.numpy().copy(), out.numpy().copy()))
        return out

    monkeypatch.setattr(ops, "classify_logits", classify_logits)
    return rows


# (a)
@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_bucketed_path_against_one_read_at_a_time(tmp_path, weights, monkeypatch, fmt):
    """The CLI's bucketed, padded packed rows, classified by the port, give
    each read the reference's logits of that read alone, unpadded."""
    seqs = reads(np.random.default_rng(1), 90)
    ext = ".fa" if fmt == "fasta" else ".fq.gz"
    src = str(tmp_path / f"in{ext}")
    write(src, seqs, fmt)
    rows = record_classify(monkeypatch)
    cli.main_cpu(["-c", config(tmp_path, weights), "-l", str(LEN), "--buckets", BUCKETS,
                  "-i", src, "-o", str(tmp_path / "o.fa"), "-r", str(tmp_path / "r.fa")])
    toks, lens, got = [], [], []
    for t, n, lg in rows:
        live = n > 0
        full = np.full((int(live.sum()), LEN), 4, np.uint8)
        full[:, : t.shape[1]] = t[live]
        toks.append(full), lens.append(n[live]), got.append(lg[live])
    toks, lens, got = np.concatenate(toks), np.concatenate(lens), np.concatenate(got)
    want_tok, want_len = ref_tokens(seqs, fmt == "fasta")
    # the classified rows are the reads, each once
    key = lambda t, n: sorted(bytes([*divmod(int(k), 256)]) + r.tobytes() for r, k in zip(t, n))
    assert key(toks, lens) == key(want_tok, want_len)
    w = cref.load(weights)
    assert np.abs(one_at_a_time(w, toks, lens) - got).max() < TOL
    assert {int(n) for n in lens} >= {1, LEN}


# (b)
def test_reference_blocks_equal_one_read_at_a_time(weights):
    w = cref.load(weights)
    tok, lengths = ref_tokens(reads(np.random.default_rng(2), 40), True)
    blocks = cref.logits(w, tok, lengths, block=7)
    assert np.abs(blocks - one_at_a_time(w, tok, lengths)).max() < 1e-6


# (c)
@pytest.mark.parametrize("side", ["port", "reference"])
def test_conjoined_logits_of_the_reverse_complement(weights, side):
    tok, lengths = ref_tokens(reads(np.random.default_rng(3), 40), True)
    t, n = torch.from_numpy(tok), torch.from_numpy(lengths)
    rc = cad.reverse_complement(t, n)
    if side == "port":
        p = load_params(weights, arch="CaduceusParams")
        a, b = cad.caduceus_logits(p, t, n), cad.caduceus_logits(p, rc, n)
    else:
        w = cref.load(weights)
        a, b = cref.forward(w, t, n), cref.forward(w, rc, n)
    assert torch.equal(a, b)
    # the complement is A<->T, C<->G on the read's own bases, N stays N
    assert torch.equal(cad.reverse_complement(rc, n), t)


# (d)
def test_padding_and_micro_batches_change_no_logits(tmp_path, weights, monkeypatch):
    """Pad columns (a wider bucket), rows of no bases and the Predictor's
    split into micro-batches leave every read's logits as they are."""
    from ribodetector_tpu_torch.config import ConfigParser
    from ribodetector_tpu_torch.runtime import Predictor

    p = load_params(weights, arch="CaduceusParams")
    tok, lengths = ref_tokens(reads(np.random.default_rng(4), 40), True)
    t, n = torch.from_numpy(tok), torch.from_numpy(lengths)
    base = cad.caduceus_logits(p, t, n)
    wide = torch.full((50, LEN + 16), 4, dtype=torch.uint8)
    wide[:40, :LEN] = t
    wn = torch.cat([n, torch.zeros(10, dtype=n.dtype)])
    got = cad.caduceus_logits(p, wide, wn)
    assert torch.equal(got[:40], base) and torch.all(got[40:] == 0)
    args = cli.build_arg_parser().parse_args(["-l", str(LEN), "-i", "x.fa", "-o", "y.fa"])
    pred = Predictor(ConfigParser(json.loads(Path(config(tmp_path, weights)).read_text())),
                     args, device="cpu")
    pred.load_model()
    one = pred._build_infer(emit="logits")(wide, wn)
    monkeypatch.setattr(cad, "ACTIVATION_BYTES", 7 * cad.bytes_per_token(p) * 2 * (LEN + 16))
    assert cad.micro_rows(p, LEN + 16) == 7
    pred._infer_cache.clear()
    split = pred._build_infer(emit="logits")(wide, wn)
    assert torch.allclose(one[:40], base, rtol=0, atol=1e-7)
    assert torch.allclose(split, one, rtol=0, atol=1e-7) and torch.all(split[40:] == 0)


def width_of(length, T):
    return min(T, -(-length // cad.WIDTH_STEP) * cad.WIDTH_STEP)


def test_micro_batches_are_cut_by_read_length(tmp_path, weights, monkeypatch):
    """One call of mixed lengths (rows of no bases, reads of 1 base and of
    exactly T, runs of one length) through the Predictor's step: its reads
    longest first, each micro-batch at its longest read rounded up to
    WIDTH_STEP and holding only reads of that rounded width, at most
    micro_rows at that width; every read classified once, its logits back
    in the call's row order as one untrimmed call gives them."""
    from ribodetector_tpu_torch.config import ConfigParser
    from ribodetector_tpu_torch.runtime import Predictor

    T = 100
    rng = np.random.default_rng(10)
    lengths = np.concatenate([[0, 1, T, 0, 1], [T] * 7, [40] * 13, [T - 3, 97, 48, 33, 32, 0],
                              rng.integers(1, T + 1, 30)])
    lengths = lengths[rng.permutation(len(lengths))]
    tok = rng.integers(0, 5, (len(lengths), T)).astype(np.uint8)
    tok[np.arange(T)[None, :] >= lengths[:, None]] = 4
    t, n = torch.from_numpy(tok), torch.from_numpy(lengths.astype(np.int32))
    p = load_params(weights, arch="CaduceusParams")
    base = cad.caduceus_logits(p, t, n)

    monkeypatch.setattr(cad, "ACTIVATION_BYTES", 3 * cad.bytes_per_token(p) * 2 * T)
    assert cad.micro_rows(p, T) == 3 and cad.micro_rows(p, 48) == 6
    args = cli.build_arg_parser().parse_args(["-l", str(T), "-i", "x.fa", "-o", "y.fa"])
    pred = Predictor(ConfigParser(json.loads(Path(config(tmp_path, weights)).read_text())),
                     args, device="cpu")
    pred.load_model()
    pred.timer.enabled = True
    calls = record_classify(monkeypatch)
    got = pred._build_infer(emit="logits")(t, n)

    # the rule, one read at a time: the longest left opens a micro-batch
    want, left = [], sorted(lengths[lengths > 0].tolist(), reverse=True)
    while left:
        W = width_of(left[0], T)
        k = 0
        while k < min(len(left), cad.micro_rows(p, W)) and width_of(left[k], T) == W:
            k += 1
        want.append((k, W))
        left = left[k:]
    assert [(len(ln), tk.shape[1]) for tk, ln, _ in calls] == want
    for tk, ln, _ in calls:
        W, longest = tk.shape[1], int(ln.max())
        assert longest <= W and (W < longest + cad.WIDTH_STEP or W == T)
        assert len(ln) <= cad.micro_rows(p, W) and ln.min() > 0
    # every read once: (length, its tokens) as a multiset
    seen = [(int(k), r[:k].tobytes()) for tk, ln, _ in calls for r, k in zip(tk, ln)]
    assert sorted(seen) == sorted((int(k), r[:k].tobytes()) for r, k in zip(tok, lengths) if k)
    assert got.shape == base.shape and torch.all(got[n == 0] == 0)
    assert (got - base).abs().max() < TOL
    c = pred.timer.counters
    assert c["cad.micro_batches"] == len(want)
    assert c["cad.padded_tokens"] == sum(2 * k * W for k, W in want)
    assert c["cad.tokens"] == 2 * int(lengths.sum())
    # a call of no bases at all: zero logits, nothing computed
    assert torch.equal(pred._build_infer(emit="logits")(t[:3], 0 * n[:3]), torch.zeros(3, 2))
    assert len(calls) == len(want) and c["cad.micro_batches"] == len(want)


# (e)
@pytest.mark.parametrize("fmt,ext", [("fasta", ".fa"), ("fastq", ".fq.gz")])
def test_cli_paired_against_reference_labels(tmp_path, weights, fmt, ext):
    rng = np.random.default_rng(5)
    sides = [reads(rng, 70), reads(rng, 70)]
    rng.shuffle(sides[1])
    ins = [str(tmp_path / f"in_{k}{ext}") for k in (1, 2)]
    for path, seqs in zip(ins, sides):
        write(path, seqs, fmt)
    out = [str(tmp_path / f"o_{k}{ext}") for k in (1, 2)]
    rr = [str(tmp_path / f"r_{k}{ext}") for k in (1, 2)]
    cli.main_cpu(["-c", config(tmp_path, weights), "-l", str(LEN), "--buckets", BUCKETS,
                  "-i", *ins, "-o", *out, "-r", *rr])
    w = cref.load(weights)
    lg = [cref.logits(w, *ref_tokens(s, fmt == "fasta")) for s in sides]
    want = bref.pair_labels(lg[0], lg[1], "none")
    margin = bref.pair_margin(lg[0], lg[1], "none")
    got = np.full(len(want), -1)
    for label, files in ((0, out), (1, rr)):
        a, b = ids_in(files[0]), ids_in(files[1])
        assert a == b and a == sorted(a)
        got[a] = label
    assert np.all(got >= 0)
    sure = margin > TOL
    assert np.array_equal(got[sure], want[sure]) and sure.mean() > 0.9
    assert 0 < want.sum() < len(want) or len(set(want)) == 1


# (f)
def test_npz_round_trip_names_the_arch(tmp_path):
    p = cad.init_params(torch.Generator().manual_seed(0), {k: MODEL[k] for k in (
        "d_model", "n_layer", "d_state", "dt_rank")})
    path = str(tmp_path / "p.npz")
    cad.save_params(path, p)
    assert arch_of(path) == "CaduceusParams"
    q = load_params(path, arch="CaduceusParams")
    assert all(torch.equal(a, b) for a, b in zip(p, q))
    assert cad.dims(q) == MODEL


def test_arch_type_is_checked(tmp_path, weights, ref_params_path):
    from ribodetector_tpu_torch.models import BiLSTMParams

    assert isinstance(load_params(ref_params_path, arch="BiLSTMParams"), BiLSTMParams)
    with pytest.raises(ValueError, match="holds CaduceusParams"):
        load_params(weights, arch="BiLSTMParams")
    with pytest.raises(ValueError, match="holds BiLSTMParams"):
        load_params(ref_params_path, arch="CaduceusParams")
    with pytest.raises(ValueError, match="unknown arch.type"):
        load_params(weights, arch="Mamba2")


def detect_cpu(tmp_path, cfg_path, *extra):
    src = str(tmp_path / "in.fa")
    write(src, reads(np.random.default_rng(6), 10), "fasta")
    cli.main_cpu(["-c", cfg_path, "-l", str(LEN), "-i", src, "-o", str(tmp_path / "o.fa"),
                  *extra])


@pytest.mark.parametrize("case", ["unknown", "mismatch", "precision", "dense", "widths"])
def test_caduceus_config_refusals(tmp_path, weights, ref_params_path, case):
    cfg = json.loads(Path(config(tmp_path, weights)).read_text())
    extra = []
    if case == "unknown":
        cfg["arch"]["type"] = "Hyena"
    elif case == "mismatch":
        cfg["state_file"] = {"mcc": ref_params_path, "recall": ref_params_path}
    elif case == "precision":
        extra = ["--precision", "exact"]
    elif case == "dense":
        extra = ["--semantics", "dense"]
    else:
        cfg["arch"]["args"] = {**MODEL, "d_model": 256}
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(cfg))
    match = {"unknown": "unknown arch.type", "mismatch": "holds BiLSTMParams",
             "precision": "--precision exact", "dense": "packed semantics",
             "widths": "disagree"}[case]
    with pytest.raises(ValueError, match=match):
        detect_cpu(tmp_path, str(path), *extra)


def test_default_precision_is_accepted(tmp_path, weights):
    detect_cpu(tmp_path, config(tmp_path, weights), "--precision", "high")
    assert os.path.getsize(tmp_path / "o.fa") > 0


def test_training_refuses_a_caduceus(tmp_path, weights):
    from ribodetector_tpu_torch.train import __main__ as train_cli
    from ribodetector_tpu_torch.train import trainer

    write(str(tmp_path / "a.fa"), ["ACGT" * 5] * 4, "fasta")
    with pytest.raises(SystemExit, match="trains the BiLSTM only"):
        train_cli.main_cpu(["--rrna", str(tmp_path / "a.fa"), "--norrna", str(tmp_path / "a.fa"),
                            "--init", weights, "--out", str(tmp_path / "ck")])
    data = (np.zeros((4, 8), np.uint8), np.full(4, 8, np.int32), np.zeros(4, np.int32))
    with pytest.raises(ValueError, match="BiLSTMParams only"):
        trainer.fit(load_params(weights), data)


# (g)
def test_bilstm_run_loads_no_caduceus(tmp_path):
    """A BiLSTM detect run imports no Caduceus module and builds or loads
    no Caduceus library."""
    write(str(tmp_path / "in.fa"), reads(np.random.default_rng(7), 12), "fasta")
    code = (
        "import json, sys\n"
        "from ribodetector_tpu_torch import cli\n"
        "from ribodetector_tpu_torch.ops import build\n"
        f"cli.main_cpu(['-l', '{LEN}', '-i', r'{tmp_path / 'in.fa'}', '-o', r'{tmp_path / 'o.fa'}'])\n"
        "print(json.dumps({'mods': sorted(m for m in sys.modules if 'caduceus' in m),\n"
        "                  'lib': build._caduceus is not None}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(REPO), env=dict(os.environ, PYTHONPATH=str(REPO)), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"mods": [], "lib": False}
    assert os.path.getsize(tmp_path / "o.fa") > 0


# (h)
def test_work_constants_hold_the_published_widths():
    from harness import work_caduceus as wc

    pub = cad.PUBLISHED
    D, E = pub["d_model"], pub["expand"] * pub["d_model"]
    S, R, K = pub["d_state"], pub["dt_rank"], pub["d_conv"]
    assert (wc.D, wc.E, wc.S, wc.R, wc.K, wc.LAYERS) == (D, E, S, R, K, pub["n_layer"])
    assert wc.FLOPS_PER_BASE_LAYER == 1_024_000
    assert wc.FLOPS_PER_BASE == 32_768_000
    assert wc.HEAD_FLOPS == 2 * 1024
    assert wc.SCAN_FLOPS == 159_744
    assert wc.SCAN_TRANSCENDENTALS == 2 * E * S + 2 * E == 17_408
    assert wc.SCAN_BYTES == 3 * 512 * 2
    assert wc.flops(10, 1) == 327_682_048
    # the SFU bounds the scan: ~4.2 ns a base, layer and strand
    assert wc.scan_bound_seconds(1) == pytest.approx(32 * 17_408 / (16 * 132 * 1.98e9))
    assert wc.NORM_BYTES == (6 + 15 * 12 + 10) * D == 50_176
    # the published model's parameter count (about 7.73 M)
    assert cad.param_count(cad.init_params(torch.Generator().manual_seed(0))) == 7_725_824


def test_serve_runs_a_caduceus_as_the_cli_does(tmp_path, weights):
    """serve.main_cpu on a Caduceus config: the job's outputs are the
    CLI's, byte for byte."""
    import io

    from ribodetector_tpu_torch import serve

    cfg = config(tmp_path, weights)
    src = str(tmp_path / "in.fa")
    write(src, reads(np.random.default_rng(8), 60), "fasta")
    common = ["-c", cfg, "-l", str(LEN), "--buckets", BUCKETS]
    cli.main_cpu([*common, "-i", src, "-o", str(tmp_path / "cli_o.fa"),
                  "-r", str(tmp_path / "cli_r.fa")])
    job = {"id": 1, "input": [src], "output": [str(tmp_path / "srv_o.fa")],
           "rrna": [str(tmp_path / "srv_r.fa")]}
    out = io.StringIO()
    serve.main_cpu(common, io.StringIO(json.dumps(job) + "\n"), out)
    resp = json.loads(out.getvalue().strip().splitlines()[-1])
    assert resp["status"] == "ok" and resp["num_read"] == 60, resp
    for side in ("o", "r"):
        assert (tmp_path / f"srv_{side}.fa").read_bytes() == (tmp_path / f"cli_{side}.fa").read_bytes()


def test_card_split_runs_a_caduceus(tmp_path, weights):
    """The several-card split (-d a,b; on the CPU Predictor(replicas=2)):
    each replica holds its own weights and classifies half of each batch's
    pairs, and the outputs are one replica's."""
    from ribodetector_tpu_torch.config import ConfigParser
    from ribodetector_tpu_torch.runtime import Predictor

    rng = np.random.default_rng(9)
    ins = [str(tmp_path / f"in_{k}.fa") for k in (1, 2)]
    for path in ins:
        write(path, reads(rng, 50), "fasta")
    cfg = config(tmp_path, weights)
    for replicas in (1, 2):
        argv = ["-c", cfg, "-l", str(LEN), "--buckets", BUCKETS, "-i", *ins,
                "-o", *[str(tmp_path / f"o{replicas}_{k}.fa") for k in (1, 2)]]
        args = cli.build_arg_parser().parse_args(argv)
        p = Predictor(ConfigParser.from_json(cfg), args, device="cpu", replicas=replicas)
        p.load_model()
        assert len({id(x.w_in) for x in p._card_params}) == replicas
        p.detect()
    for k in (1, 2):
        assert (tmp_path / f"o2_{k}.fa").read_bytes() == (tmp_path / f"o1_{k}.fa").read_bytes()
