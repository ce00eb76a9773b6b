"""The port's training-era helpers against the JAX package's.

Twins of tests/test_aux.py (windows and reverse complement, datasets and
train_val_split, MetricTracker and inf_loop, param_count/describe), each
held to the JAX function on the same inputs; the model helpers (init,
save/load with metadata, the BiLSTM module); and the two reader faults
repaired in the port's copies of io/gzfast.py and io/fastx.py.
"""

import gzip
import os
import struct

import numpy as np
import pytest
import torch

from ribodetector_tpu import data_sets as jds
from ribodetector_tpu.encode import windows as jw
from ribodetector_tpu.models import bilstm as jb
from ribodetector_tpu.train import tracking as jtrack
from ribodetector_tpu_torch import data_sets as tds
from ribodetector_tpu_torch.encode import encode_batch
from ribodetector_tpu_torch.encode import windows as tw
from ribodetector_tpu_torch.models import bilstm as tb
from ribodetector_tpu_torch.train import tracking as ttrack
from tests.conftest import random_reads

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one intra-op thread for the module's tests and fixtures:
    the plain recurrence is thousands of small ops, whose per-op thread
    barriers stall when the test workers oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- windows


def test_get_read_rc_with_maxlen():
    seq = "A" * 10 + "CGTN" + "T" * 10  # len 24
    read, rc = tw.get_read_rc_with_maxlen(seq, max_len=10)
    assert read == seq[7:17] == "AAACGTNTTT"
    assert rc == "AAANACGTTT"
    assert tw.get_read_rc_with_maxlen("ACG", max_len=5) == ("ACGNN", "CGTNN")
    rng = np.random.default_rng(3)
    for seq in random_reads(rng, 50, lmin=1, lmax=140, alphabet="ACGTUNRYacgtn"):
        for max_len in (10, 100):
            assert tw.get_read_rc_with_maxlen(seq, max_len) == \
                jw.get_read_rc_with_maxlen(seq, max_len)


def test_reverse_complement_tokens():
    tokens, lengths = encode_batch(["ACGT", "AC"], 6)
    rc = tw.reverse_complement_tokens(tokens, lengths)
    t_acgt, _ = encode_batch(["ACGT"[::-1].translate(str.maketrans("ACGT", "TGCA"))], 6)
    np.testing.assert_array_equal(rc[0], t_acgt[0])
    rng = np.random.default_rng(4)
    tokens, lengths = encode_batch(random_reads(rng, 40, lmin=0, lmax=60), 50)
    for ln in (lengths, None):
        got = tw.reverse_complement_tokens(tokens, ln)
        want = jw.reverse_complement_tokens(tokens, ln)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_encode_seq_windows():
    seq = "ACGT" * 30  # len 120
    wins = tw.encode_seq_windows(seq, step_size=50, max_len=100)
    assert wins.shape == (2, 100)
    full, _ = encode_batch([seq[:100]], 100)
    np.testing.assert_array_equal(wins[0], full[0])
    assert tw.encode_seq_windows("ACGT" * 10, step_size=100, max_len=100).shape == (0, 100)
    rng = np.random.default_rng(5)
    for seq in random_reads(rng, 20, lmin=0, lmax=400):
        for step, max_len in ((50, 100), (7, 30)):
            np.testing.assert_array_equal(tw.encode_seq_windows(seq, step, max_len),
                                          jw.encode_seq_windows(seq, step, max_len))


def test_load_labeled_seqs(tmp_path):
    rng = np.random.default_rng(6)
    seqs = random_reads(rng, 30, lmin=5, lmax=150)
    path = tmp_path / "in.fa.gz"
    with gzip.open(path, "wt") as fh:
        for i, s in enumerate(seqs):
            fh.write(f">s{i}\n{s}\n")
    got = tw.load_labeled_seqs(str(path), 1, max_len=100)
    assert len(got) == 2 * len(seqs)
    assert got == jw.load_labeled_seqs(str(path), 1, max_len=100)


# ---------------------------------------------------------------- data sets


def test_datasets():
    reads = [("@a", "AC"), ("@b", "GG"), ("@c", "TT")]
    ds = tds.SeqData(reads)
    assert len(ds) == 3 and ds[1] == ("@b", "GG")
    assert list(ds.batches(2)) == [reads[:2], reads[2:]]
    assert list(ds.batches(2)) == list(jds.SeqData(reads).batches(2))
    pd = tds.PairedReadData((reads, reads))
    assert pd[2] == (("@c", "TT"), ("@c", "TT"))
    assert list(pd.batches(2)) == list(jds.PairedReadData((reads, reads)).batches(2))


@pytest.mark.parametrize("val", [0.2, 0, 15, 0.5])
def test_train_val_split(val):
    tr, va = tds.train_val_split(100, val, seed=1)
    jtr, jva = jds.train_val_split(100, val, seed=1)
    np.testing.assert_array_equal(tr, jtr)
    np.testing.assert_array_equal(va, jva)
    assert sorted(np.concatenate([tr, va])) == list(range(100))
    want = {0.2: 20, 0: 0, 15: 15, 0.5: 50}[val]
    assert len(va) == want


# ---------------------------------------------------------------- tracking


def test_metric_tracker_and_inf_loop(tmp_path):
    for mod in (ttrack, jtrack):
        mt = mod.MetricTracker("loss")
        mt.update("loss", 2.0)
        mt.update("loss", 4.0, n=3)
        mt.update("acc", 0.5)
        assert mt.avg("loss") == pytest.approx((2 + 12) / 4)
        assert mt.result() == {"loss": 3.5, "acc": 0.5}
        mt.reset()
        assert mt.result() == {"loss": 0.0, "acc": 0.0}
        it = mod.inf_loop([1, 2])
        assert [next(it) for _ in range(5)] == [1, 2, 1, 2, 1]
    path = tmp_path / "m.json"
    ttrack.write_json({"b": 1, "a": [2]}, path)
    assert list(ttrack.read_json(path).items()) == list(jtrack.read_json(path).items())


# ---------------------------------------------------------------- model helpers


def test_param_count_and_describe(ref_params_path):
    params = tb.load_params(ref_params_path)
    assert tb.reference_param_count(params) == 137730
    assert tb.param_count(params) == 136706
    assert tb.describe(params) == jb.describe(jb.load_params(ref_params_path))
    assert "136706" in tb.describe(params)


@pytest.mark.parametrize("hidden", [128, 32])
def test_init_params_bounds(hidden):
    params = tb.init_params(torch.Generator().manual_seed(3), hidden=hidden)
    want = jb.init_params(__import__("jax").random.PRNGKey(0), hidden=hidden)
    bound = 1 / np.sqrt(hidden)
    for name in tb.BiLSTMParams._fields:
        p = getattr(params, name)
        assert p.dtype == torch.float32 and p.device.type == "cpu"
        assert tuple(p.shape) == tuple(getattr(want, name).shape)
        b = 1 / np.sqrt(2 * hidden) if name in ("w_out", "b_out") else bound
        if name in ("b_f", "b_b"):
            b = 2 * bound  # the sum of two draws
        assert float(p.abs().max()) <= b
        if p.numel() >= 64:  # the draws fill their range
            assert float(p.abs().max()) > 0.8 * (bound if name in ("b_f", "b_b") else b)
    assert tb.param_count(params) == jb.param_count(want)
    # the generator, never the global RNG: the same seed gives the same
    # weights whatever the global RNG's state, another seed others
    torch.manual_seed(123)
    again = tb.init_params(torch.Generator().manual_seed(3), hidden=hidden)
    other = tb.init_params(torch.Generator().manual_seed(4), hidden=hidden)
    for a, b_, c in zip(params, again, other):
        assert torch.equal(a, b_) and not torch.equal(a, c)


def test_npz_written_by_either_package_loads_in_the_other(tmp_path, ref_params_path):
    meta = {"arch": "BiLSTM 4x16x2 bidirectional", "epoch": 3, "batch_size": 8,
            "metrics": {"mcc": 0.5, "train_loss": 0.25}, "path": tmp_path}
    params = tb.init_params(torch.Generator().manual_seed(0), hidden=16)
    port_npz = str(tmp_path / "port.npz")
    tb.save_params(port_npz, params, meta)
    back = jb.load_params(port_npz)
    for name in tb.BiLSTMParams._fields:
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      getattr(params, name).numpy())
    want_meta = {**meta, "path": str(tmp_path)}  # default=str, as in JAX
    assert jb.load_params_meta(port_npz) == want_meta == tb.load_params_meta(port_npz)

    jax_npz = str(tmp_path / "jax.npz")
    jb.save_params(jax_npz, jb.load_params(port_npz), meta)
    for name, p in tb.load_params(jax_npz)._asdict().items():
        assert torch.equal(p, getattr(params, name))
    assert tb.load_params_meta(jax_npz) == want_meta
    with open(port_npz, "rb") as a, open(jax_npz, "rb") as b:
        assert a.read() == b.read()  # the same file, byte for byte
    tb.save_params(str(tmp_path / "nometa.npz"), params)
    assert tb.load_params_meta(str(tmp_path / "nometa.npz")) == {}
    assert tb.load_params_meta(ref_params_path)["epoch"] == 47


def test_bilstm_module_holds_the_params(ref_params_path):
    params = tb.load_params(ref_params_path)
    model = tb.BiLSTM(params)
    names = [n for n, _ in model.named_parameters()]
    assert names == list(tb.BiLSTMParams._fields)
    leaves = model.params()
    assert all(a is b for a, b in zip(leaves, model.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(leaves, params))
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(leaves, params))
    tokens, lengths = encode_batch(random_reads(np.random.default_rng(1), 9), 40)
    tok = torch.from_numpy(tokens)
    for sem in ("dense", "packed"):
        got = model(tok, torch.from_numpy(lengths), semantics=sem)
        want = tb.bilstm_logits(params, tok, torch.from_numpy(lengths), semantics=sem)
        assert torch.equal(got.detach(), want)
    model(tok).sum().backward()
    assert all(p.grad is not None for p in model.parameters())


# ---------------------------------------------------------------- reader faults


def test_corrupt_isize_of_a_hinted_member_is_not_allocated(monkeypatch):
    """A hinted member whose trailer claims ~4 GiB, at the end of a stream
    that flush() re-runs with an unbounded budget (behind a member whose
    hint overshoots the file): the fast path must not allocate the claimed
    size; zlib decodes the member and raises on its length."""
    from ribodetector_tpu_torch.io import gzfast

    asked = []
    real = gzfast.RawInflater._fast_member

    def spy(self, mv, isize, want_crc):
        asked.append(isize)
        if isize > 1 << 26:
            raise AssertionError(f"fast path asked for {isize} bytes")
        return real(self, mv, isize, want_crc)

    monkeypatch.setattr(gzfast.RawInflater, "_fast_member", spy)
    rng = np.random.default_rng(224)
    a = rng.integers(65, 91, 120000).astype(np.uint8).tobytes()
    b = rng.integers(65, 91, 90001).astype(np.uint8).tobytes()
    first = bytearray(gzfast.compress_member(a))
    struct.pack_into("<I", first, 16, 200 << 20)  # hint past the end
    second = bytearray(gzfast.compress_member(b))
    struct.pack_into("<I", second, len(second) - 4, 0xFFFFFFF0)  # ISIZE

    inf = gzfast.RawInflater()
    out, left = inf.decompress(bytes(first + second), 1 << 30)
    assert out == b"" and not left  # all of it stashed behind the hint
    with pytest.raises(gzfast.BadGzipFile, match="Incorrect length"):
        inf.flush()
    # the same member fed directly under an unbounded budget
    inf = gzfast.RawInflater()
    with pytest.raises(gzfast.BadGzipFile, match="Incorrect length"):
        inf.decompress(bytes(second), 1 << 62)
    assert all(x <= 1 << 26 for x in asked)
    # an intact member still takes the fast path under that budget
    inf = gzfast.RawInflater()
    out, _ = inf.decompress(gzfast.compress_member(b), 1 << 62)
    assert out == b and inf.fast_members == 1


def _open_fds():
    return len(os.listdir("/proc/self/fd"))


@pytest.mark.skipif(not os.path.isdir("/proc/self/fd"), reason="needs /proc")
def test_parse_file_closes_a_file_it_never_read(tmp_path):
    from ribodetector_tpu_torch.io import parse_file

    path = tmp_path / "in.fq.gz"
    with gzip.open(path, "wt") as fh:
        fh.write("@a\nACGT\n+\nIIII\n@b\nGG\n+\nII\n")
    before = _open_fds()
    held = [parse_file(str(path)) for _ in range(5)]
    assert _open_fds() == before + 5
    for records in held:  # abandoned before the first next()
        records.close()
    assert _open_fds() == before
    held = [parse_file(str(path)) for _ in range(5)]
    del held  # dropped, never started
    assert _open_fds() == before
    with parse_file(str(path)) as records:
        assert next(records)[:2] == ("@a", "ACGT")
    assert _open_fds() == before
    assert [r[:2] for r in parse_file(str(path))] == [("@a", "ACGT"), ("@b", "GG")]
    assert _open_fds() == before
    with pytest.raises(Exception):
        parse_file(str(tmp_path / "missing.fq"))
    assert _open_fds() == before
