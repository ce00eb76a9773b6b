"""Reading the program's output files back: which read went where.

The generator names record i "r<i>" (traffic.py), so an output file gives
the indices of the reads it holds. Copied in idea from ``chip_smoke.py``
``read_indices``/``read_partition``, and vectorised.
"""

import gzip

import numpy as np


def read_ids(path):
    """The index of every record of a FASTQ (4 lines a record, "@r<i>") or
    FASTA (2 lines, ">r<i>", as the program writes it) file, gz or plain.
    Raises ValueError on a header that is not the generator's."""
    with open(path, "rb") as fh:
        data = fh.read()
    if path.endswith(".gz"):
        data = gzip.decompress(data)
    if not data:
        return np.zeros(0, np.int64)
    buf = np.frombuffer(data, np.uint8)
    ends = np.flatnonzero(buf == 10)
    starts = np.concatenate([[0], ends[:-1] + 1])
    step = 2 if buf[0] == ord(">") else 4
    if len(ends) % step or buf[-1] != 10:
        raise ValueError(f"{path}: {len(ends)} lines do not make whole records")
    hs, he = starts[::step], ends[::step]
    if not (np.all(buf[hs] == buf[0]) and np.all(buf[hs + 1] == ord("r"))):
        raise ValueError(f"{path}: a header is not the generator's")
    width = he - hs - 2
    ids = np.zeros(len(hs), np.int64)
    for k in range(int(width.max())):
        live = k < width
        digit = buf[np.minimum(hs + 2 + k, len(buf) - 1)].astype(np.int64) - 48
        if np.any(live & ((digit < 0) | (digit > 9))):
            raise ValueError(f"{path}: a header's index is not a number")
        ids = np.where(live, ids * 10 + digit, ids)
    return ids


def partition(files, n):
    """{label: [file per side]} -> (label of each of the n reads or pairs,
    -9 where none was written; {fault: count}). The faults: ends of a pair
    out of step, records out of input order, reads written twice, indices
    that are no read's, reads never written, files that cannot be read."""
    got = np.full(n, -9, np.int64)
    faults = {"out_of_step": 0, "out_of_order": 0, "written_twice": 0,
              "unreadable": 0, "foreign": 0, "missing": 0}
    for label, paths in files.items():
        try:
            idx = [read_ids(p) for p in paths]
        except (OSError, ValueError, EOFError):
            faults["unreadable"] += 1
            continue
        for other in idx[1:]:
            faults["out_of_step"] += int(not np.array_equal(idx[0], other))
        ids = idx[0]
        faults["out_of_order"] += int(np.sum(np.diff(ids) <= 0))
        inside = (ids >= 0) & (ids < n)
        faults["foreign"] += int(np.sum(~inside))
        ids = ids[inside]
        faults["written_twice"] += int(np.sum(got[ids] != -9))
        got[ids] = label
    faults["missing"] = int(np.sum(got == -9))
    return got, faults


def held(got, want, margin):
    """(reads or pairs in another file than the reference's, the widest
    reference margin among them); reads never written are partition's
    faults."""
    bad = (got != want) & (got != -9)
    return int(bad.sum()), float(margin[bad].max(initial=0.0))
