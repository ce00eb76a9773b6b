"""The plain reference against hand arithmetic, and the model-work count
against its formula."""

import numpy as np
import pytest
import torch

from harness import work
from reference import model as ref


def sig(x):
    return 1 / (1 + np.exp(-x))


def by_hand(w, tokens):
    """The dense BiLSTM, one read and one step at a time, in float64."""
    w = {k: v.double().numpy() for k, v in w.items()}
    out = []
    for row in tokens:
        T = len(row)
        called = [t for t in range(T) if row[t] != 4]
        at = called[-1] if called else T - 1
        caps = []
        for s, order in (("f", range(T)), ("b", range(T - 1, -1, -1))):
            h, c = np.zeros(128), np.zeros(128)
            for t in order:
                x = np.zeros(4)
                if row[t] != 4:
                    x[row[t]] = 1
                g = x @ w[f"w_ih_{s}"] + h @ w[f"w_hh_{s}"] + w[f"b_{s}"]
                i, f, gg, o = np.split(g, 4)
                c = sig(f) * c + sig(i) * np.tanh(gg)
                h = sig(o) * np.tanh(c)
                if t == at:
                    cap = h
            caps.append(cap)
        out.append(np.concatenate(caps) @ w["w_out"] + w["b_out"])
    return np.array(out)


@pytest.fixture(scope="module")
def weights():
    g = torch.Generator().manual_seed(0)
    shapes = {"w_ih_f": (4, 512), "w_hh_f": (128, 512), "b_f": (512,), "w_ih_b": (4, 512),
              "w_hh_b": (128, 512), "b_b": (512,), "w_out": (256, 2), "b_out": (2,)}
    return {k: (torch.rand(s, generator=g) - 0.5) * 0.4 for k, s in shapes.items()}


def test_forward_matches_hand_arithmetic(weights):
    tokens = np.array([[0, 1, 2, 3, 4, 4], [3, 3, 4, 1, 0, 2], [4, 4, 4, 4, 4, 4],
                       [2, 4, 4, 4, 4, 4]], np.uint8)
    got = ref.logits(weights, tokens)
    np.testing.assert_allclose(got, by_hand(weights, tokens), rtol=1e-5, atol=1e-6)


def test_one_lstm_step_by_hand(weights):
    """A one-base read: both directions take one cell step from zero."""
    w = {k: v.double().numpy() for k, v in weights.items()}
    caps = []
    for s in "fb":
        g = w[f"w_ih_{s}"][2] + w[f"b_{s}"]
        i, f, gg, o = g[:128], g[128:256], g[256:384], g[384:]
        caps.append(sig(o) * np.tanh(sig(i) * np.tanh(gg)))
    want = np.concatenate(caps) @ w["w_out"] + w["b_out"]
    got = ref.logits(weights, np.array([[2]], np.uint8))[0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_encoder_rules():
    bases = np.frombuffer(b"ACGTNacgtU", np.uint8)[None, :].repeat(2, 0)
    fastq = ref.encode(bases, np.array([10, 4]), 12, fasta=False)
    fasta = ref.encode(bases, np.array([10, 4]), 12, fasta=True)
    assert fastq[0].tolist() == [0, 1, 2, 3, 4, 4, 4, 4, 4, 3, 4, 4]
    assert fasta[0].tolist() == [0, 1, 2, 3, 4, 0, 1, 2, 3, 3, 4, 4]
    assert fastq[1].tolist() == [0, 1, 2, 3] + [4] * 8
    assert ref.encode(bases, np.array([10, 10]), 3, False)[0].tolist() == [0, 1, 2]


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1 + 2 ** -10, 1 + 2 ** -11 + 2 ** -12, 3.0, -1 - 2 ** -13])
    assert ref._tf32(x).tolist() == [1 + 2 ** -10, 1 + 2 ** -10, 3.0, -1.0]


def test_pair_rules():
    one, zero = np.array([[0.0, 1.0]]), np.array([[1.0, 0.0]])
    table = {"rrna": (1, 0, 0), "norrna": (1, 1, 0), "both": (1, -1, 0)}
    for ensure, (both1, mixed, both0) in table.items():
        assert ref.pair_labels(one, one, ensure)[0] == both1
        assert ref.pair_labels(one, zero, ensure)[0] == mixed
        assert ref.pair_labels(zero, zero, ensure)[0] == both0
    assert ref.pair_labels(np.array([[0.0, 3.0]]), np.array([[2.0, 0.0]]), "none")[0] == 1


def test_adam_first_step_is_lr_times_sign():
    w = {"x": torch.tensor([1.0, -2.0, 0.5])}
    g = {"x": torch.tensor([0.3, -4.0, 1e-3])}
    new = ref.Adam(1e-3).step(w, g)
    np.testing.assert_allclose((w["x"] - new["x"]).numpy(), 1e-3 * np.sign(g["x"].numpy()),
                               rtol=1e-4)


def test_model_work_matches_formula():
    assert work.FLOPS_PER_BASE == 2 * 2 * (4 + 128) * (4 * 128) == 270_336
    assert work.HEAD_FLOPS == 1024
    lengths = np.array([40, 100, 150, 300])
    assert work.bases(lengths, 100) == 40 + 100 + 100 + 100
    assert work.flops(340, 4) == 270_336 * 340 + 4 * 1024
    # compute-bound: 270,336 FLOPs against ~1 byte a base
    assert work.bound_seconds(340, 4) == work.flops(340, 4) / 989e12
