"""Each traffic mix's generator against the shares its file states, and
the writers against the output reader."""

import gzip

import numpy as np
import pytest

from harness import core, outputs, traffic

N = 200_000


def load_mix(name):
    return core.load_json("traffic", f"{name}.json")


def shares(rows, n):
    return rows.sum() / n


def test_illumina_pairs_mix():
    spec = load_mix("lib_pe_gz")["library"]["reads"]
    sides = traffic.make_pairs(np.random.default_rng(1), N, spec)
    for bases, lengths in sides:
        assert bases.shape == (N, 100)
        n_calls = (bases[:, :100] == ord("N")).sum(1)
        lower = bases[:, 0] >= ord("a")
        assert abs(shares(lengths < 100, N) - 0.08) < 0.005
        assert lengths.min() == 40 and lengths.max() == 100
        assert abs(shares(n_calls == 1, N) - 0.03) < 0.003
        assert abs(shares(lower, N) - 0.02) < 0.002
        clean = (lengths == 100) & (n_calls == 0) & ~lower
        assert abs(shares(clean, N) - 0.87) < 0.01


def test_config4_pairs_mix():
    spec = load_mix("lib_fa_long")["library"]["reads"]
    (b1, l1), (b2, l2) = traffic.make_pairs(np.random.default_rng(2), N, spec)
    assert l1[5] == 120 and l1[N // 2] == 300 and np.all(b1[N // 2, :300] == ord("N"))
    full = (l1 == 300) & (l2 == 300)
    assert abs(shares(full, N) - (0.10 + 0.9 * (1 / 261) ** 2)) < 0.005
    over = l1 > 300
    assert abs(shares(over, N) - 0.03 * 0.9) < 0.003 and l1.max() == 320
    assert l1.min() == 40
    lower = b1[:, 0] >= ord("a")
    assert abs(shares(lower, N) - 0.02 * 0.9) < 0.002
    three_n = (b1 == ord("N")).sum(1)
    assert abs(shares((three_n >= 1) & (three_n <= 3), N) - 0.03 * 0.9) < 0.003


def test_motif_task():
    mix = load_mix("retrain_motif")
    bases, lengths, labels = traffic.motif_task(np.random.default_rng(4), 4096, 100, mix["motif"])
    assert labels.sum() == 2048
    assert lengths.min() >= 50 and lengths.max() <= 100
    m = mix["motif"].encode()
    found = np.array([m in bases[i, :lengths[i]].tobytes() for i in range(4096)])
    assert np.all(found[labels == 1])
    assert found[labels == 0].mean() < 0.01


@pytest.mark.parametrize("fmt,gz", [("fastq", 1), ("fasta", None)])
def test_writers_read_back(tmp_path, fmt, gz):
    spec = load_mix("lib_fa_long")["library"]["reads"]
    sides = traffic.make_pairs(np.random.default_rng(5), 1000, spec)
    paths = [str(tmp_path / f"x_{s}") + (".gz" if gz else "") for s in (1, 2)]
    traffic.write_sides(paths, sides, fmt, gz)
    if fmt == "fasta":
        with open(paths[0], "rb") as fh:
            first = fh.read().split(b">r1\n")[0]
        assert max(len(x) for x in first.split(b"\n")[1:]) <= 80
    else:
        ids = outputs.read_ids(paths[0])
        assert ids.tolist() == list(range(1000))
        with gzip.open(paths[1], "rb") as fh:
            rec = fh.read().split(b"\n")[:4]
        assert rec[0] == b"@r0" and len(rec[1]) == sides[1][1][0] == len(rec[3])
