"""The port's native parse wrappers against the JAX package's.

Twins of the tests of tests/test_native.py that call parse_fastq_chunk,
parse_fastq_chunk_b5 and parse_fastq_chunk_b5b2 (and of test_b2_lane.py's
2-bit lane parse): every call goes through both packages' wrappers on the
same bytes, and every returned array must be equal, dtype included,
before the original test's own checks run on the port's result.
"""

import io

import numpy as np
import pytest

from ribodetector_tpu import native as jnative
from ribodetector_tpu.encode import encode_batch
from ribodetector_tpu.io.fastx import seq_parser
from ribodetector_tpu_torch import native

pytestmark = pytest.mark.skipif(
    not jnative.available(), reason="native extension unavailable (no g++)"
)


def make_fastq(seqs):
    return "".join(
        f"@read{i} x\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(seqs)
    ).encode()


def parse(name, data, *args, **kw):
    """The port's `name`(data, ...) after checking it equals the JAX
    wrapper's output, element for element."""
    got = getattr(native, name)(data, *args, **kw)
    want = getattr(jnative, name)(data, *args, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert type(g) is type(w) and g == w
    return got


def test_tokens_lengths_match_python():
    rng = np.random.default_rng(46)
    bases = np.array(list("ACGTUNacgt"))
    seqs = ["".join(rng.choice(bases, size=rng.integers(5, 160))) for _ in range(200)]
    data = make_fastq(seqs)
    offsets, tokens, lengths, clean, consumed = parse("parse_fastq_chunk", data, 100)
    assert len(offsets) == 200 and consumed == len(data) and clean.all()
    t_py, l_py = encode_batch(seqs, 100)
    np.testing.assert_array_equal(tokens, t_py)
    np.testing.assert_array_equal(lengths, l_py)


def test_record_slices_are_verbatim():
    data = make_fastq(["ACGT", "GGTT"])
    offsets, *_ = parse("parse_fastq_chunk", data, 10)
    rec0 = data[offsets[0, 0] : offsets[0, 1]]
    assert rec0 == b"@read0 x\nACGT\n+\nIIII\n"
    recs = list(seq_parser(io.StringIO(data.decode()), "fastq"))
    assert rec0[:-1].decode() == "\n".join(recs[0])


def test_partial_record_at_buffer_end():
    data = make_fastq(["ACGT", "GGTT"])
    cut = data[:-3]  # cut inside the last record's qual line
    offsets, tokens, lengths, clean, consumed = parse(
        "parse_fastq_chunk", cut, 10, at_eof=False
    )
    assert len(offsets) == 1
    assert consumed == offsets[0, 1]
    offsets, _, lengths, clean, consumed = parse("parse_fastq_chunk", cut, 10)
    assert len(offsets) == 2 and lengths[1] == 4
    assert clean[1] == 0
    offsets, *_ = parse("parse_fastq_chunk", data[:-8], 10)  # cut before qual
    assert len(offsets) == 1


def test_trailing_blank_lines_at_eof_consumed():
    data = make_fastq(["ACGT"]) + b"\n  \n\n"
    offsets, _, _, _, consumed = parse("parse_fastq_chunk", data, 10)
    assert len(offsets) == 1
    assert consumed == len(data)


def test_crlf_records_flagged_dirty():
    data = b"@r0\r\nACGT\r\n+\r\nIIII\r\n@r1\nGGGG\n+\nIIII\n"
    offsets, tokens, lengths, clean, consumed = parse("parse_fastq_chunk", data, 10)
    assert list(clean) == [0, 1]
    np.testing.assert_array_equal(tokens[0][:4], [0, 1, 2, 3])
    assert lengths[0] == 4


def test_gather_with_scratch_reuse():
    data = make_fastq(["AAAA", "CCCC", "GGGG"])
    offsets, *_ = parse("parse_fastq_chunk", data, 10)
    scratch = bytearray()
    out1 = bytes(native.gather_records(data, offsets, np.array([0, 2]), scratch))
    want = (
        data[offsets[0, 0] : offsets[0, 1]] + data[offsets[2, 0] : offsets[2, 1]]
    )
    assert out1 == want
    out2 = bytes(native.gather_records(data, offsets, np.array([1]), scratch))
    assert out2 == data[offsets[1, 0] : offsets[1, 1]]


def test_b5_packed_parse_matches_unpacked():
    rng = np.random.default_rng(109)
    bases = np.array(list("ACGTUNacgt"))
    seqs = ["".join(rng.choice(bases, size=rng.integers(5, 160))) for _ in range(150)]
    data = make_fastq(seqs)
    for max_len in (100, 99):  # divisible and non-divisible by 3
        o1, tokens, l1, c1, u1 = parse("parse_fastq_chunk", data, max_len)
        o2, packed, l2, c2, u2 = parse("parse_fastq_chunk_b5", data, max_len)
        np.testing.assert_array_equal(o1, o2)
        np.testing.assert_array_equal(l1, l2)
        assert u1 == u2
        assert packed.shape[1] == native.b5_packed_len(max_len)
        assert packed.max() <= 124
        trios = packed.astype(np.int32)
        dec = np.stack([trios % 5, (trios // 5) % 5, trios // 25], axis=-1)
        dec = dec.reshape(len(seqs), -1)[:, :max_len].astype(np.uint8)
        np.testing.assert_array_equal(dec, tokens)
        np.testing.assert_array_equal(native.pack_b5(tokens), packed)


def test_b5b2_parse_flags_and_packs_the_2bit_lane():
    """Twin of test_b2_lane.py's parse check: clean full-length ACGT(U)
    calls are b2ok with pack_b2 rows; N, short or lowercase reads are not;
    the b5 half equals parse_fastq_chunk_b5's, in a stream cut mid-record
    too."""
    rng = np.random.default_rng(128)
    lut = {"A": 0, "C": 1, "G": 2, "T": 3, "U": 3}
    recs, want_ok, want_rows = [], [], []
    for i in range(64):
        seq = {0: lambda: "".join(rng.choice(list("ACGT"), size=24)),
               1: lambda: "".join(rng.choice(list("ACGTN"), size=24)),
               2: lambda: "".join(rng.choice(list("ACGT"), size=int(rng.integers(1, 24)))),
               3: lambda: "".join(rng.choice(list("acgt"), size=24))}[i % 4]()
        recs.append(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
        ok = len(seq) == 24 and all(c in lut for c in seq)
        want_ok.append(ok)
        want_rows.append(native.pack_b2(np.array([[lut[c] for c in seq]], np.uint8))[0]
                         if ok else None)
    blob = "".join(recs).encode()
    offsets, p5, p2, lengths, clean, b2ok, consumed = parse("parse_fastq_chunk_b5b2", blob, 24)
    assert [bool(x) for x in b2ok] == want_ok
    assert p2.shape[1] == native.b2_packed_len(24)
    for i, row in enumerate(want_rows):
        if row is not None:
            np.testing.assert_array_equal(p2[i], row)
    o5, q5, l5, c5, u5 = parse("parse_fastq_chunk_b5", blob, 24)
    np.testing.assert_array_equal(p5, q5)
    assert consumed == u5 == len(blob)
    cut = parse("parse_fastq_chunk_b5b2", blob[:-5], 24, at_eof=False)
    assert len(cut[0]) == 63 and cut[-1] == cut[0][-1, 1]
