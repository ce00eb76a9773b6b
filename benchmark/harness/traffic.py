"""The one generator every traffic mix is read by.

A mix is a JSON file under ``benchmark/traffic/`` that gives its reads as
parameters; this module turns them into files and arrays from ``--seed``.
The read mixes were first written for ``chip_smoke.py`` (``write_pairs``,
``config4_reads``/``config4_pairs``, ``fastq``, ``fasta``) and for the training motif task
(``ribodetector_tpu_torch/train/trainer.py`` ``synthetic_dataset``); they
are frozen here as parameters of one vectorised generator, so that the
program's files can change without changing the yardstick.

A read spec (``"reads"`` in a mix):

    {"width": 320,                    # bytes held per read (>= the longest)
     "length": [40, 300],             # default length, uniform, inclusive
     "classes": [                     # exclusive classes drawn by share
        {"share": 0.03, "length": [301, 320]},
        {"share": 0.03, "n_calls": 3},                 # N at random bases
        {"share": 0.02, "lower": 10}],                 # first 10 lower-case
     "full_pairs": 0.10,              # pairs clean at full_length, both ends
     "full_length": 300,
     "all_n": [[5, 120], ["half", 300]]}  # reads made all N: [index, length]
"""

import gzip
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)


def make_reads(rng, n, spec, full=None):
    """n reads by `spec` -> (bases [n, width] uint8, lengths [n] int64).
    `full`: a boolean [n] of the reads to make clean at spec's full_length
    (a pair's ends share it)."""
    width = int(spec["width"])
    bases = ACGT[rng.integers(0, 4, (n, width))]
    lo, hi = spec["length"]
    lengths = rng.integers(lo, hi + 1, n)
    kind = rng.random(n)
    free = np.ones(n, bool) if full is None else ~full
    at = 0.0
    for cls in spec.get("classes", []):
        rows = np.flatnonzero(free & (kind >= at) & (kind < at + cls["share"]))
        at += cls["share"]
        if "length" in cls:
            lengths[rows] = rng.integers(cls["length"][0], cls["length"][1] + 1, rows.size)
        for _ in range(cls.get("n_calls", 0)):
            reach = np.minimum(lengths[rows], width)
            bases[rows, (rng.random(rows.size) * reach).astype(np.int64)] = ord("N")
        if cls.get("lower"):
            bases[rows, : cls["lower"]] += 32
    if full is not None:
        lengths[full] = spec["full_length"]
    for index, length in spec.get("all_n", []):
        i = n // 2 if index == "half" else int(index)
        lengths[i] = length
        bases[i, :length] = ord("N")
    return bases, lengths


def make_pairs(rng, n, spec):
    """n pairs -> [(bases, lengths) of side 1, of side 2]."""
    full = None
    if spec.get("full_pairs"):
        full = rng.random(n) < spec["full_pairs"]
        for index, _ in spec.get("all_n", []):
            full[n // 2 if index == "half" else int(index)] = False
    return [make_reads(rng, n, spec, full) for _ in (1, 2)]


def fastq(bases, lengths):
    """FASTQ records "@r<i>" with quality I at every base."""
    qual = {}
    out = []
    for i, (row, k) in enumerate(zip(bases, lengths.tolist())):
        q = qual.get(k)
        if q is None:
            q = qual[k] = b"I" * k
        out.append(b"@r%d\n%s\n+\n%s\n" % (i, row[:k].tobytes(), q))
    return b"".join(out)


def fasta(bases, lengths, wrap=80):
    """FASTA records ">r<i>", the sequence wrapped at `wrap` bases a line."""
    out = []
    for i, (row, k) in enumerate(zip(bases, lengths.tolist())):
        s = row[:k].tobytes()
        out.append(b">r%d\n%s\n" % (i, b"\n".join(s[j: j + wrap] for j in range(0, k, wrap))))
    return b"".join(out)


def write_sides(paths, sides, fmt, gz_level=None, wrap=80):
    """Write each side's reads as FASTQ or FASTA, gz-compressed at gz_level
    when given, the sides compressed on threads of their own."""
    def one(path, side):
        data = fastq(*side) if fmt == "fastq" else fasta(*side, wrap=wrap)
        if gz_level is not None:
            data = gzip.compress(data, compresslevel=gz_level)
        with open(path, "wb") as fh:
            fh.write(data)
        return len(data)

    with ThreadPoolExecutor(len(paths)) as pool:
        return sum(pool.map(one, paths, sides))


def motif_task(rng, n, max_len, motif):
    """The planted-motif task of the port's synthetic_dataset, vectorised:
    n reads of uniform length in [max(len(motif) + 2, max_len // 2),
    max_len], exactly half of them labelled 1 and carrying `motif` at a
    uniform position -> (bases [n, max_len], lengths, labels int32)."""
    m = np.frombuffer(motif.encode(), np.uint8)
    lmin = min(max(len(m) + 2, max_len // 2), max_len)
    lengths = rng.integers(lmin, max_len + 1, n)
    bases = ACGT[rng.integers(0, 4, (n, max_len))]
    labels = rng.permutation(np.arange(n) % 2).astype(np.int32)
    rows = np.flatnonzero(labels == 1)
    pos = (rng.random(rows.size) * (lengths[rows] - len(m))).astype(np.int64)
    bases[rows[:, None], pos[:, None] + np.arange(len(m))[None, :]] = m
    return bases, lengths, labels
