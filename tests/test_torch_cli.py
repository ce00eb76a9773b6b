"""The port's CLI (main_cpu) against the JAX CLI (--kernel scan).

Both run the native streaming path over the same fixture files, and the
output files must be byte-identical (gz outputs: decompressed content).
Torch and XLA sum the fp32 dot products in different orders, so logits can
differ in the last ulps; every fixture therefore first asserts that no read
has a JAX-scan logit margin below 1e-4, which makes byte identity
well-defined. -l 50 -m 3 --chunk_size 1 keeps the device batch at 1024 rows.
The paired ensure modes are in test_torch_cli_paired.py.

Beyond the default run: --precision fast (on the CPU both packages run the
fp32 recurrence whatever the precision), the portable runner
(runtime.native=false, at -m 2: the 256-row batch floor), the bf16 config
(runtime.compute_dtype=bfloat16, held to byte identity only after every
read's JAX bf16 margin is checked to be >= 0.25) and --trace-dir.
"""

import gzip
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ribodetector_tpu.cli import main as jax_main
from ribodetector_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from ribodetector_tpu.models import bilstm_logits, load_params
from ribodetector_tpu_torch.cli import main, main_cpu
from ribodetector_tpu_torch.config import DEFAULT_CONFIG
from ribodetector_tpu_torch.encode import encode_batch
from tests.conftest import random_reads

LEN = 50
COMMON = ["-l", str(LEN), "-m", "3", "--chunk_size", "1"]
MARGIN = 1e-4


def write_fastq(path, names, seqs):
    op = gzip.open if str(path).endswith("gz") else open
    with op(path, "wt") as fh:
        for n, s in zip(names, seqs):
            fh.write(f"@{n}\n{s}\n+\n{'I' * len(s)}\n")


def write_fasta(path, names, seqs):
    with open(path, "w") as fh:
        for n, s in zip(names, seqs):
            fh.write(f">{n} desc\n{s[:25]}\n{s[25:]}\n")


def content(path):
    op = gzip.open if str(path).endswith("gz") else open
    with op(path, "rb") as fh:
        return fh.read()


def assert_margins(ref_params_path, *seq_lists, bf16=False):
    """No read near the decision boundary (see module docstring): JAX-scan
    margin >= 1e-4 in fp32, >= 0.25 in bf16 (the bf16 scans of the two
    packages differ by up to 0.066, test_torch_bilstm.py)."""
    params = load_params(ref_params_path)
    kw = {}
    if bf16:
        kw = {"compute_dtype": jnp.bfloat16, "precision": jax.lax.Precision.DEFAULT}
    for seqs in seq_lists:
        tok, _ = encode_batch(seqs, LEN)
        logits = np.asarray(bilstm_logits(params, jnp.asarray(tok), **kw))
        assert np.abs(logits[:, 1] - logits[:, 0]).min() >= (0.25 if bf16 else MARGIN)


def runtime_configs(tmp, **runtime):
    """["-c", path] for the JAX CLI and for the port: each package's shipped
    config with the given runtime keys set."""
    flags = []
    for tag, src in (("jax", JAX_CONFIG), ("torch", DEFAULT_CONFIG)):
        with open(src) as fh:
            cfg = json.load(fh)
        cfg["runtime"].update(runtime)
        path = tmp / f"{tag}_config.json"
        path.write_text(json.dumps(cfg))
        flags.append(["-c", str(path)])
    return flags


def outputs(tmp, tag, paired, gz, ensure="none"):
    ext = ".fq.gz" if gz else ".fq"
    sides = (1, 2) if paired else (1,)
    norrna = [str(tmp / f"{tag}_norrna{s}{ext}") for s in sides]
    rrna = [str(tmp / f"{tag}_rrna{s}{ext}") for s in sides]
    files = norrna + rrna
    if paired and ensure == "both":
        files += [f + ".unclassified.gz" for f in norrna]
    return ["-o", *norrna, "-r", *rrna], files


def run_both(tmp, inputs, extra=(), paired=False, ensure="none", gz_out=False,
             common=COMMON, configs=([], [])):
    """Run the JAX CLI and the port on the same inputs; return both file
    lists (JAX's first). configs: each side's ["-c", path] flags."""
    flags = ["-i", *inputs, *common, *extra]
    if paired:
        flags += ["-e", ensure]
    jo, jfiles = outputs(tmp, "jax", paired, gz_out, ensure)
    to, tfiles = outputs(tmp, "torch", paired, gz_out, ensure)
    jax_main([*flags, *configs[0], *jo, "--kernel", "scan"])
    main_cpu([*flags, *configs[1], *to])
    return jfiles, tfiles


def assert_identical(jfiles, tfiles):
    for j, t in zip(jfiles, tfiles):
        assert content(t) == content(j), (j, t)
    # the fixtures put reads on both sides of the partition
    assert sum(len(content(j)) > 0 for j in jfiles) >= 2


@pytest.fixture(scope="module")
def reads():
    rng = np.random.default_rng(2024)
    seqs = random_reads(rng, 60, lmin=20, lmax=70)
    names = [f"r{i}" for i in range(len(seqs))]
    return names, seqs


def test_single_end_gz(tmp_path, reads, ref_params_path):
    names, seqs = reads
    assert_margins(ref_params_path, seqs)
    inp = tmp_path / "in.fq.gz"
    write_fastq(inp, names, seqs)
    assert_identical(*run_both(tmp_path, [str(inp)], gz_out=True))


@pytest.mark.parametrize("buckets", ["auto", "off", "24,40"])
def test_buckets(tmp_path, reads, ref_params_path, buckets):
    """auto and off (the same single bucket at -l 50), and an explicit list
    that routes reads through T=24 and T=40 buckets with the zero-prefix
    backward init."""
    names, seqs = reads
    assert_margins(ref_params_path, seqs)
    inp = tmp_path / "in.fq"
    write_fastq(inp, names, seqs)
    assert_identical(*run_both(tmp_path, [str(inp)], extra=["--buckets", buckets]))


def test_fasta_input(tmp_path, reads, ref_params_path):
    names, seqs = reads
    # FASTA records are emitted uppercased (reference quirk #1)
    assert_margins(ref_params_path, [s.upper() for s in seqs])
    inp = tmp_path / "in.fasta"
    write_fasta(inp, names, seqs)
    assert_identical(*run_both(tmp_path, [str(inp)]))


def test_trailing_n_and_lowercase(tmp_path, ref_params_path):
    rng = np.random.default_rng(77)
    seqs = random_reads(rng, 30, lmin=30, lmax=LEN, alphabet="ACGT")
    seqs = [s + "N" * int(rng.integers(1, 15)) if i % 3 == 0 else s
            for i, s in enumerate(seqs)]
    seqs = [s[:10].lower() + s[10:] if i % 4 == 1 else s for i, s in enumerate(seqs)]
    seqs += ["N" * 40, "acgt" * 10]
    names = [f"t{i}" for i in range(len(seqs))]
    assert_margins(ref_params_path, seqs)
    inp = tmp_path / "in.fq"
    write_fastq(inp, names, seqs)
    assert_identical(*run_both(tmp_path, [str(inp)]))


def test_precision_fast(tmp_path, reads, ref_params_path):
    names, seqs = reads
    assert_margins(ref_params_path, seqs)
    inp = tmp_path / "in.fq.gz"
    write_fastq(inp, names, seqs)
    assert_identical(*run_both(tmp_path, [str(inp)], extra=["--precision", "fast"],
                               gz_out=True))


@pytest.mark.parametrize("chunked", [False, True])
def test_portable_runner(tmp_path, reads, ref_params_path, chunked):
    """runtime.native=false: Python parsing, one [256, 50] batch per call,
    text writers; whole-file and --chunk_size 1."""
    names, seqs = reads
    assert_margins(ref_params_path, seqs)
    inp = tmp_path / "in.fq.gz"
    write_fastq(inp, names, seqs)
    common = ["-l", str(LEN), "-m", "2"] + (["--chunk_size", "1"] if chunked else [])
    assert_identical(*run_both(tmp_path, [str(inp)], gz_out=True, common=common,
                               configs=runtime_configs(tmp_path, native=False)))


def test_bf16_config(tmp_path, ref_params_path):
    rng = np.random.default_rng(14)  # every read's bf16 margin >= 0.25
    seqs = random_reads(rng, 40, lmin=20, lmax=70)
    names = [f"b{i}" for i in range(len(seqs))]
    assert_margins(ref_params_path, seqs, bf16=True)
    inp = tmp_path / "in.fq"
    write_fastq(inp, names, seqs)
    assert_identical(*run_both(
        tmp_path, [str(inp)],
        configs=runtime_configs(tmp_path, compute_dtype="bfloat16")))


@pytest.mark.parametrize("native", [True, False])
def test_trace_dir(tmp_path, reads, native):
    """--trace-dir writes a torch.profiler Chrome trace of the run. The
    profiler records the torch ops of the thread that started it: the
    portable runner classifies on that thread, the native runner on its
    rd-dispatch threads (on the card, CUPTI records the kernels of every
    thread)."""
    names, seqs = reads
    inp = tmp_path / "in.fq"
    write_fastq(inp, names, seqs)
    trace = tmp_path / "trace"
    cfg = runtime_configs(tmp_path, native=native)[1]
    main_cpu(["-i", str(inp), *COMMON, *cfg, "-o", str(tmp_path / "o.fq"),
              "--trace-dir", str(trace)])
    files = list(trace.glob("trace_*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    events = json.loads(files[0].read_text())["traceEvents"]
    assert events
    if not native:
        assert any(e.get("cat") == "cpu_op" for e in events)


@pytest.mark.parametrize("flag", [
    (["--resume", "--hosts", "2"], RuntimeError, "--resume with --hosts requires"),
    (["--hosts", "2", "--host-id", "2"], RuntimeError, "out of range"),
    (["--coordinator", "localhost:1", "--num-hosts", "1"], SystemExit,
     "--coordinator requires --num-hosts >= 2"),
], ids=["flag0", "flag1", "flag2"])
def test_unported_flags_are_refused(tmp_path, flag):
    """--resume, --hosts and --coordinator, refused as not ported until
    their paths came over, now reach their own checks: a misuse of each is
    refused with the JAX package's message before anything is written (the
    paths themselves: test_torch_resume.py, test_torch_distributed.py,
    test_torch_sharding.py)."""
    argv, exc, match = flag
    inp = tmp_path / "in.fq"
    write_fastq(inp, ["a"], ["ACGT" * 10])
    out = str(tmp_path / "out.fq")
    with pytest.raises(exc, match=match):
        main_cpu(["-l", "40", "-i", str(inp), "-o", out, *argv])
    assert not list(tmp_path.glob("out.fq*"))


def test_bad_compute_dtype_is_refused(tmp_path):
    inp = tmp_path / "in.fq"
    write_fastq(inp, ["a"], ["ACGT" * 10])
    cfg = runtime_configs(tmp_path, compute_dtype="float16")[1]
    with pytest.raises(ValueError, match="compute_dtype"):
        main_cpu([*cfg, "-l", "40", "-i", str(inp), "-o", str(tmp_path / "o.fq")])
    assert not (tmp_path / "o.fq").exists()


def test_main_needs_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: main runs on it")
    inp = tmp_path / "in.fq"
    write_fastq(inp, ["a"], ["ACGT" * 10])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-l", "40", "-i", str(inp), "-o", str(tmp_path / "o.fq")])
    with pytest.raises(ValueError, match="needs the card"):
        main_cpu(["-l", "40", "-i", str(inp), "-o", str(tmp_path / "o.fq"),
                  "--kernel", "cuda"])
    assert not (tmp_path / "o.fq").exists()
