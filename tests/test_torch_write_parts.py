"""Write parts (runtime/native_pipeline.py, NativeRunner._part): the
input's last chunk has its write accumulator cut every dbs >> PART_SHIFT
records, so that a part's labels, byte gather and deflate run while the
card classifies the chunk's later parts.

On the CPU the device batch is small: -l 100 at -m 6 single-end and -m 10
paired gives a 4096-row batch, and --chunk_size 1 chunks of 4096 records.
LADDER_MIN is lowered to 64 so that parts of 1024 records are cut there, as
parts of 32,768 are at the card's 131,072-row batch. The yardstick is the
same run at PART_SHIFT 0, one part a chunk: the outputs must hold the same
decompressed bytes, in the same order. Half the reads are clean 100 bp (the
2-bit lane), the rest 20-100 bp with some N (buckets 64 and 100)."""

import gzip
import time

import numpy as np
import pytest

from ribodetector_tpu_torch.cli import main_cpu
from ribodetector_tpu_torch.runtime.native_pipeline import NativeRunner
from ribodetector_tpu_torch.runtime.pipeline import Predictor

LEN = 100
COUNTER = "write_parts_overlapped"
# the methods run() wraps, as the module found them
DETECT, BUCKET_INFERS = Predictor.detect, NativeRunner._bucket_infers
WRITE, DEVICE_CALL = NativeRunner._write_chunk_bucketed, NativeRunner._device_call_with


def library(n, seed):
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n):
        if rng.random() < 0.5:
            seqs.append("".join(rng.choice(list("ACGT"), LEN)))
        else:
            length = int(rng.integers(20, LEN + 1))
            seqs.append("".join(rng.choice(list("ACGTN"), length,
                                           p=[0.24, 0.24, 0.24, 0.24, 0.04])))
    return seqs


def write_fastq(path, seqs):
    with open(path, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")
    return str(path)


def inputs(d, n, paired):
    sides = (1, 2) if paired else (1,)
    return [write_fastq(d / f"in{s}.fq", library(n, 40 + s)) for s in sides]


def content(path):
    with gzip.open(path, "rb") as fh:
        return fh.read()


def run(d, tag, ins, monkeypatch, parts=True, slow=True):
    """One CLI run with --profile; returns (output files, the write-parts
    counter, token and length staging bytes allocated, {chunk: writes}).
    With `slow` each classify call takes at least 0.1 s, as on a card
    slower than the host, so that a part's batches are still running when
    an earlier part writes."""
    monkeypatch.setattr(NativeRunner, "LADDER_MIN", 64)
    monkeypatch.setattr(NativeRunner, "PART_SHIFT", 2 if parts else 0)
    seen, stagers, writes = {}, [], {}

    def counting_write(self, acc):
        writes[acc.ci] = writes.get(acc.ci, 0) + 1
        return WRITE(self, acc)

    def slow_call(self, *a):
        time.sleep(0.1)
        return DEVICE_CALL(self, *a)

    def keep_predictor(self):
        seen["p"] = self
        return DETECT(self)

    def keep_stagers(self, buckets):
        infers, st = BUCKET_INFERS(self, buckets)
        stagers.extend(st)
        return infers, st

    monkeypatch.setattr(Predictor, "detect", keep_predictor)
    monkeypatch.setattr(NativeRunner, "_bucket_infers", keep_stagers)
    monkeypatch.setattr(NativeRunner, "_write_chunk_bucketed", counting_write)
    if slow:
        monkeypatch.setattr(NativeRunner, "_device_call_with", slow_call)
    paired = len(ins) == 2
    sides = (1, 2) if paired else (1,)
    norrna = [str(d / f"{tag}_norrna{s}.fq.gz") for s in sides]
    rrna = [str(d / f"{tag}_rrna{s}.fq.gz") for s in sides]
    files = norrna + rrna
    argv = ["-l", str(LEN), "-m", "10" if paired else "6", "--chunk_size", "1",
            "-i", *ins, "-o", *norrna, "-r", *rrna, "--profile"]
    if paired:
        argv += ["-e", "both"]
        files += [f + ".unclassified.gz" for f in norrna]
    main_cpu(argv)
    timer = seen["p"].timer
    return (files, timer.counters.get(COUNTER, 0),
            sum(s.allocated for s in stagers), writes)


@pytest.mark.parametrize(
    "n,paired,writes,overlapped",
    [(4096, False, {0: 4}, True), (4096, True, {0: 4}, True),
     (7000, False, {0: 1, 1: 3}, None), (900, False, {0: 1}, False)],
    ids=["single_end", "paired_both", "two_chunks", "one_part"])
def test_parts_keep_the_outputs(tmp_path, monkeypatch, n, paired, writes,
                                overlapped):
    """4096 records make one chunk, written in four parts; 7000 make a
    chunk of 4096, written whole, and a last chunk of 2904, written in
    three parts; 900 make a last chunk smaller than one part, never cut.
    (Two chunks leave the counter to timing: the first chunk's larger
    batches can return after the last chunk's.)"""
    ins = inputs(tmp_path, n, paired)
    files, counted, _, got = run(tmp_path, "parts", ins, monkeypatch)
    ref, ref_counted, _, ref_got = run(tmp_path, "whole", ins, monkeypatch,
                                       parts=False)
    for a, b in zip(files, ref):
        assert content(a) == content(b), (a, b)
    # the library puts reads on both sides of the partition
    assert sum(len(content(f)) > 0 for f in ref) >= 2
    assert got == writes
    assert ref_got == {ci: 1 for ci in writes}
    assert ref_counted == 0
    if overlapped is not None:
        assert (counted >= 1) == overlapped, counted


@pytest.mark.parametrize("paired", [False, True], ids=["single_end", "paired"])
def test_parts_allocate_no_more_staging(tmp_path, monkeypatch, paired):
    """One chunk of four parts: the token and length staging buffers a run
    allocates hold no more bytes with parts than with one part a chunk."""
    ins = inputs(tmp_path, 4096, paired)
    _, overlapped, with_parts, writes = run(tmp_path, "parts", ins, monkeypatch)
    _, _, whole, _ = run(tmp_path, "whole", ins, monkeypatch, parts=False)
    assert writes == {0: 4} and overlapped >= 1
    assert 0 < with_parts <= whole


def test_part_size_follows_the_device_batch():
    """Parts are dbs >> 2 records where the ladder under a part starts at a
    full LADDER_MIN batch and the chunk holds two parts; none otherwise."""
    from types import SimpleNamespace

    def runner(batch_size, chunk_size):
        p = SimpleNamespace(batch_size=batch_size, chunk_size=chunk_size,
                            config={}, semantics="dense")
        return NativeRunner(p)

    whole = runner(16384, None)  # whole-file: 131072-record chunks
    assert (whole.dbs, whole._part) == (131072, 32768)
    chunked = runner(16384, 1)  # 16384-record chunks: a ladder from 256 rows
    assert (chunked.dbs, chunked._part) == (16384, None)


def test_classify_calls_hold_each_read_once(tmp_path, monkeypatch):
    """A batch reuses the staging buffers earlier batches released: a
    partial batch pads the rows past its reads, so that no classify call
    holds a read of an earlier batch. DEPTH 2 makes the runner take in
    labels, and free buffers, early. The first chunk's 4096 pairs are all
    20-60 bp (a full batch of the 64 bucket), the next two hold 70-99 bp
    pairs with 205 and then 51 short ones (the third chunk's short pairs
    go to a buffer that held more rows), and a last chunk of 1712 is
    written in two parts; no pair rides the 2-bit lane, whose padding rows
    unpack as bases."""
    import threading

    import ribodetector_tpu_torch.ops as ops

    rng = np.random.default_rng(77)

    def read(i):
        short = i < 4096 or i % (20 if i < 8192 else 80) == 0
        return "".join(rng.choice(list("ACGT"),
                                  int(rng.integers(20, 61) if short else rng.integers(70, 100))))

    ins = [write_fastq(tmp_path / f"in{s}.fq", [read(i) for i in range(14000)])
           for s in (1, 2)]
    rows = []
    classify = ops.classify_logits

    def recording(params, tokens, *a, **kw):
        if threading.current_thread().name.startswith("rd-dispatch"):
            rows.append(int((tokens.cpu().numpy() != 4).any(axis=1).sum()))
        return classify(params, tokens, *a, **kw)

    monkeypatch.setattr(ops, "classify_logits", recording)
    monkeypatch.setattr(NativeRunner, "DEPTH", 2)
    _, _, _, writes = run(tmp_path, "parts", ins, monkeypatch, slow=False)
    assert writes == {0: 1, 1: 1, 2: 1, 3: 2}
    assert len(rows) > 8 and sum(rows) == 2 * 14000
