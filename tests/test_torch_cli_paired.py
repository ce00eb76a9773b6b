"""Paired-end CLI parity: the port's main_cpu against the JAX CLI under all
four ensure modes, plain and gz (inputs and outputs). The JAX CLI runs once
per ensure mode, on the plain inputs, in a module-scoped fixture; the port
runs on plain and on gz files, and its outputs must be byte-identical to
JAX's (gz: decompressed content). See test_torch_cli.py for the margin
precondition that makes byte identity well-defined. -e both also runs at
--precision fast and at -m 2 (the 256-row batch floor), whole-file and at
--chunk_size 1."""

import numpy as np
import pytest

from ribodetector_tpu.cli import main as jax_main
from ribodetector_tpu_torch.cli import main_cpu
from tests.conftest import random_reads
from tests.test_torch_cli import (
    COMMON,
    LEN,
    assert_identical,
    assert_margins,
    outputs,
    run_both,
    write_fastq,
)

N = 60


@pytest.fixture(scope="module")
def pairs(tmp_path_factory, ref_params_path):
    rng = np.random.default_rng(606)
    seqs1 = random_reads(rng, N, lmin=30, lmax=LEN + 10)
    seqs2 = random_reads(rng, N, lmin=30, lmax=LEN + 10)
    assert_margins(ref_params_path, seqs1, seqs2)
    names = [f"p{i}" for i in range(N)]
    d = tmp_path_factory.mktemp("pairs")
    files = {}
    for kind, ext in (("plain", ".fq"), ("gz", ".fq.gz")):
        files[kind] = [str(d / f"r{s}{ext}") for s in (1, 2)]
        write_fastq(files[kind][0], names, seqs1)
        write_fastq(files[kind][1], names, seqs2)
    return d, files


@pytest.fixture(scope="module")
def jax_outputs(pairs):
    """{ensure: JAX output files} from one JAX CLI run per ensure mode."""
    d, files = pairs
    runs = {}
    for ensure in ("none", "rrna", "norrna", "both"):
        sub = d / f"jax_{ensure}"
        sub.mkdir()
        flags, jfiles = outputs(sub, "jax", True, False, ensure)
        jax_main(["-i", *files["plain"], *COMMON, "-e", ensure, *flags,
                  "--kernel", "scan"])
        runs[ensure] = jfiles
    return runs


@pytest.mark.parametrize("io", ["plain", "gz"])
@pytest.mark.parametrize("ensure", ["none", "rrna", "norrna", "both"])
def test_paired_matches_jax(tmp_path, pairs, jax_outputs, ensure, io):
    _, files = pairs
    flags, tfiles = outputs(tmp_path, "torch", True, io == "gz", ensure)
    main_cpu(["-i", *files[io], *COMMON, "-e", ensure, *flags])
    assert_identical(jax_outputs[ensure], tfiles)


def test_paired_precision_fast(tmp_path, pairs):
    _, files = pairs
    assert_identical(*run_both(tmp_path, files["gz"], extra=["--precision", "fast"],
                               paired=True, ensure="both", gz_out=True))


@pytest.mark.parametrize("chunked", [False, True])
def test_paired_small_batches(tmp_path, pairs, chunked):
    _, files = pairs
    common = ["-l", str(LEN), "-m", "2"] + (["--chunk_size", "1"] if chunked else [])
    assert_identical(*run_both(tmp_path, files["gz"], paired=True, ensure="both",
                               gz_out=True, common=common))
