"""The JAX package's documented configurations at -l 300: the port's CLI
(main_cpu) against the JAX CLI (--kernel scan), byte for byte.

At -l 300, buckets auto gives the grid T = 64, 128, 192, 256, 300: every
bucket below 300 runs its backward carry from zero_prefix_state(k) with
k = 236, 172, 108 or 44 pad steps. The reads are 40-320 bp: ~10% exactly
300 bp and clean, on both ends of a pair (the FASTQ 2-bit lane), a few
301-320 bp (truncated to 300 by both parsers), ~5% with N calls or
lowercase bases, and two all-N reads (pinned to the full bucket by the
router); chip_smoke.config4_reads makes them, for the card's
configs phase as here.

Cases (the JAX CLI runs once per case, in a module-scoped fixture, after
the margin precondition of test_torch_cli.py at -l 300):
  - paired FASTA, -e both (configuration 4);
  - the same reads as FASTQ.gz (the 300 bp reads take the 2-bit lane);
  - single-end FASTQ at --chunk_size 1 -m 3 over three chunks
    (configuration 1's chunked mode);
  - --semantics packed on the paired FASTA.
Outputs are compared decompressed; FASTA records are written uppercased
by both packages (reference quirk #1), so the margins are taken on the
uppercased reads there.
"""

import numpy as np
import pytest
import torch

from chip_smoke import config4_reads
from ribodetector_tpu.cli import main as jax_main
from ribodetector_tpu.models import bilstm as jb
from ribodetector_tpu.models import load_params as jax_load_params
from ribodetector_tpu.native import pack_b5 as jax_pack_b5
from ribodetector_tpu.runtime import buckets as jax_buckets
from ribodetector_tpu_torch import native
from ribodetector_tpu_torch.cli import main_cpu
from ribodetector_tpu_torch.encode import encode_batch
from ribodetector_tpu_torch.models import bilstm as tb
from ribodetector_tpu_torch.ops import dispatch
from ribodetector_tpu_torch.runtime.batching import auto_batch_size
from ribodetector_tpu_torch.runtime.buckets import choose_buckets, route_records
from tests.test_torch_cli import assert_identical, assert_margins, write_fastq

L = 300
BUCKETS = [64, 128, 192, 256, 300]
COMMON = ["-l", str(L), "-m", "3", "--chunk_size", "1"]
N_PAIRS = 120
N_SINGLE = 1200  # 512-read chunks at -l 300 -m 3: three chunks


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one intra-op thread for the module's tests and fixtures:
    the plain recurrence is thousands of small ops, whose per-op thread
    barriers stall when the test workers oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_fasta(path, names, seqs):
    """Two sequence lines a record, as multi-line FASTA files have."""
    with open(path, "w") as fh:
        for n, s in zip(names, seqs):
            fh.write(f">{n} desc\n{s[:70]}\n{s[70:]}\n")


def outputs(d, tag, sides, ext, ensure):
    norrna = [str(d / f"{tag}_norrna{s}{ext}") for s in sides]
    rrna = [str(d / f"{tag}_rrna{s}{ext}") for s in sides]
    files = norrna + rrna
    if len(sides) == 2 and ensure == "both":
        files += [f + ".unclassified.gz" for f in norrna]
    return ["-o", *norrna, "-r", *rrna], files


@pytest.fixture(scope="module")
def pairs(tmp_path_factory, ref_params_path):
    rng = np.random.default_rng(303)
    full = rng.random(N_PAIRS) < 0.1
    full[[5, N_PAIRS // 2]] = False
    seqs = [config4_reads(rng, N_PAIRS, full), config4_reads(rng, N_PAIRS, full)]
    # FASTA records are uppercased by the parsers; FASTQ ones are not
    assert_margins(ref_params_path, *[[s.upper() for s in side] for side in seqs],
                   length=L)
    assert_margins(ref_params_path, *seqs, length=L)
    names = [f"p{i}" for i in range(N_PAIRS)]
    d = tmp_path_factory.mktemp("config4")
    files = {"fa": [str(d / f"r{s}.fa") for s in (1, 2)],
             "fq.gz": [str(d / f"r{s}.fq.gz") for s in (1, 2)]}
    for s, side in enumerate(seqs):
        write_fasta(files["fa"][s], names, side)
        write_fastq(files["fq.gz"][s], names, side)
    return d, files, seqs


def jax_run(d, tag, inputs, ext, extra=(), ensure="both"):
    """The JAX CLI once; returns (the port's argv without outputs, JAX's
    files)."""
    sides = (1, 2) if len(inputs) == 2 else (1,)
    argv = ["-i", *inputs, *COMMON, *extra]
    if len(sides) == 2:
        argv += ["-e", ensure]
    jo, jfiles = outputs(d, f"jax_{tag}", sides, ext, ensure)
    jax_main([*argv, *jo, "--kernel", "scan"])
    return argv, sides, jfiles


def port_matches(d, tag, run, ext, ensure="both"):
    argv, sides, jfiles = run
    to, tfiles = outputs(d, f"torch_{tag}", sides, ext, ensure)
    main_cpu([*argv, *to])
    assert_identical(jfiles, tfiles)


@pytest.fixture(scope="module")
def fasta_run(pairs):
    d, files, _ = pairs
    return jax_run(d, "fa", files["fa"], ".fa")


@pytest.fixture(scope="module")
def fastq_run(pairs):
    d, files, _ = pairs
    return jax_run(d, "fq", files["fq.gz"], ".fq.gz")


@pytest.fixture(scope="module")
def packed_run(pairs, ref_params_path):
    d, files, seqs = pairs
    assert_margins(ref_params_path, *[[s.upper() for s in side] for side in seqs],
                   length=L, semantics="packed")
    return jax_run(d, "packed", files["fa"], ".fa", extra=["--semantics", "packed"])


@pytest.fixture(scope="module")
def single_run(tmp_path_factory, ref_params_path):
    rng = np.random.default_rng(404)
    full = rng.random(N_SINGLE) < 0.1
    full[[5, N_SINGLE // 2]] = False
    seqs = config4_reads(rng, N_SINGLE, full)
    assert_margins(ref_params_path, seqs, length=L)
    d = tmp_path_factory.mktemp("config1")
    inp = str(d / "single.fq")
    write_fastq(inp, [f"s{i}" for i in range(N_SINGLE)], seqs)
    assert N_SINGLE > 2 * auto_batch_size(3, L, False)  # >= three chunks
    return d, jax_run(d, "single", [inp], ".fq")


@pytest.fixture
def b2_rows(monkeypatch):
    """Rows unpacked from the 2-bit lane during a run (the classify steps
    import the unpack function when they are built)."""
    rows = []
    unpack = dispatch.unpack_b2_tokens

    def spy(packed, max_len):
        rows.append(packed.shape[0])
        return unpack(packed, max_len)

    monkeypatch.setattr(dispatch, "unpack_b2_tokens", spy)
    return rows


def test_paired_fasta_five_buckets(pairs, fasta_run, b2_rows):
    """Configuration 4: every bucket of the -l 300 grid holds reads on both
    sides, FASTA keeps the base-5 lane, and the outputs are JAX's."""
    d, _, seqs = pairs
    for side in seqs:
        tok, lengths = encode_batch([s.upper() for s in side], L)
        idx = route_records(lengths, native.pack_b5(tok), BUCKETS, L)
        assert sorted(set(idx.tolist())) == list(range(len(BUCKETS)))
    port_matches(d, "fa", fasta_run, ".fa")
    assert not b2_rows


def test_paired_fastq_gz_two_bit_lane(pairs, fastq_run, b2_rows):
    """The same reads as FASTQ.gz: the clean 300 bp reads go through the
    2-bit lane, the rest through the five base-5 buckets."""
    d, _, seqs = pairs
    clean = [all(len(s[i]) == L and set(s[i]) <= set("ACGT") for s in seqs)
             for i in range(N_PAIRS)]
    assert sum(clean) >= 5
    port_matches(d, "fq", fastq_run, ".fq.gz")
    assert b2_rows


def test_single_end_chunked(single_run):
    d, run = single_run
    port_matches(d, "single", run, ".fq")


def test_packed_semantics(pairs, packed_run):
    d, _, _ = pairs
    port_matches(d, "packed", packed_run, ".fa")


@pytest.mark.parametrize("k", [44, 108, 172, 236])
def test_zero_prefix_state_at_l300(ref_params_path, k):
    """The backward-carry init of each bucket below 300 (k = 300 - T)."""
    jp = jax_load_params(ref_params_path)
    tp = tb.params_from_numpy({f: np.asarray(v) for f, v in jp._asdict().items()})
    jh, jc = jb.zero_prefix_state(jp, k)
    th, tc = tb.zero_prefix_state(tp, k)
    assert np.abs(th.numpy() - np.asarray(jh)).max() <= 1e-6
    assert np.abs(tc.numpy() - np.asarray(jc)).max() <= 1e-6


def test_router_at_l300():
    """choose_buckets and route_records at -l 300 against the JAX package's,
    on reads at every boundary, truncated reads and all-pad reads."""
    assert choose_buckets(L, "auto") == jax_buckets.choose_buckets(L, "auto") == BUCKETS
    rng = np.random.default_rng(5)
    seqs = config4_reads(rng, 400, rng.random(400) < 0.1)
    seqs += ["A" * t for t in (1, 63, 64, 65, 128, 129, 192, 193, 256, 257, 299, 300, 301)]
    seqs += ["N" * 10, "n" * 300, "N" * 500]
    tok, lengths = encode_batch(seqs, L)
    got = route_records(lengths, native.pack_b5(tok), BUCKETS, L)
    want = jax_buckets.route_records(lengths, jax_pack_b5(tok), BUCKETS, L)
    np.testing.assert_array_equal(got, want)
    assert (got[-3:] == len(BUCKETS) - 1).all()  # all-pad reads: the full bucket
    assert auto_batch_size(32, L, True) == 8192 and auto_batch_size(32, L, False) == 16384
