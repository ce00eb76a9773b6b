"""ribodetector_tpu_torch.models.bilstm against ribodetector_tpu.models.bilstm.

The same numpy-seeded tokens and parameters (the shipped npz, and random
weights of the same shapes) go through the JAX lax.scan forward and the
port's plain torch forward. Tolerance: max-abs <= 1e-5 on fp32 logits (both
are fp32 recurrences; only the summation order of the 128-term dot products
differs) with identical argmax. The bf16 forward (compute_dtype=bfloat16,
the CPU path of the bf16 config) is held to the JAX scan in bf16 at the
tolerance stated in its tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ribodetector_tpu.models import bilstm as jb
from ribodetector_tpu_torch.models import bilstm as tb

TOL = 1e-5
B, T = 14, 21


def _random_arrays(seed, hidden=128):
    rng = np.random.default_rng(seed)
    g = 4 * hidden
    u = lambda *shape: rng.uniform(-0.3, 0.3, shape).astype(np.float32)
    return {
        "w_ih_f": u(4, g), "w_hh_f": u(hidden, g), "b_f": u(g),
        "w_ih_b": u(4, g), "w_hh_b": u(hidden, g), "b_b": u(g),
        "w_out": u(2 * hidden, 2), "b_out": u(2),
    }


@pytest.fixture(scope="module", params=["npz", "random"])
def both_params(request, ref_params_path):
    if request.param == "npz":
        jp = jb.load_params(ref_params_path)
        arrays = {k: np.asarray(v) for k, v in jp._asdict().items()}
    else:
        arrays = _random_arrays(11)
        jp = jb.BiLSTMParams(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return jp, tb.params_from_numpy(arrays)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(21)
    tok = rng.integers(0, 5, (B, T)).astype(np.uint8)
    tok[2] = 4  # all-pad read
    tok[5, 9:] = 4  # trailing pads
    lengths = rng.integers(0, T + 4, B).astype(np.int32)  # incl. 0 and > T
    return tok, lengths


def _both(jp, tp, tok, lengths, semantics, k=None):
    jinit = tinit = None
    if k is not None:
        jinit = jb.zero_prefix_state(jp, k)
        tinit = tb.zero_prefix_state(tp, k)
    ref = np.asarray(jb.bilstm_logits(jp, jnp.asarray(tok), jnp.asarray(lengths),
                                      semantics=semantics, bwd_init=jinit))
    got = tb.bilstm_logits(tp, torch.from_numpy(tok), torch.from_numpy(lengths),
                           semantics=semantics, bwd_init=tinit).numpy()
    return got, ref


@pytest.mark.parametrize("semantics,k", [("dense", None), ("packed", None),
                                         ("dense", 9)])
def test_logits_match_jax(both_params, batch, semantics, k):
    jp, tp = both_params
    got, ref = _both(jp, tp, *batch, semantics, k)
    assert got.shape == ref.shape == (B, 2)
    assert np.abs(got - ref).max() <= TOL
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))


@pytest.mark.parametrize("k", [0, 1, 7, 36])
def test_zero_prefix_state_matches_jax(both_params, k):
    jp, tp = both_params
    jh, jc = jb.zero_prefix_state(jp, k)
    th, tc = tb.zero_prefix_state(tp, k)
    assert th.shape == tc.shape == (1, 128)
    assert np.abs(th.numpy() - np.asarray(jh)).max() <= 1e-6
    assert np.abs(tc.numpy() - np.asarray(jc)).max() <= 1e-6


def _both_bf16(jp, tp, tok, lengths, semantics, k=None):
    jinit = tinit = None
    if k is not None:
        jinit = jb.zero_prefix_state(jp, k, compute_dtype=jnp.bfloat16)
        tinit = tb.zero_prefix_state(tp, k, compute_dtype=torch.bfloat16)
    ref = np.asarray(jb.bilstm_logits(
        jp, jnp.asarray(tok), jnp.asarray(lengths), semantics=semantics,
        bwd_init=jinit, compute_dtype=jnp.bfloat16,
        precision=jax.lax.Precision.DEFAULT))
    got = tb.bilstm_logits(tp, torch.from_numpy(tok), torch.from_numpy(lengths),
                           semantics=semantics, bwd_init=tinit,
                           compute_dtype=torch.bfloat16).numpy()
    return got, ref


@pytest.mark.parametrize("semantics,k", [("dense", None), ("packed", None),
                                         ("dense", 9)])
def test_bf16_logits_match_jax_scan(both_params, batch, semantics, k):
    """The bf16 scan: every op rounds to bf16 on both sides, and the logits
    come out of a bf16 head (one ulp of a logit in [2, 4) is 2^-6). The two
    sides' bf16 dots sum in different fp32 orders before rounding, and a
    flipped rounding of h compounds over T. Measured max-abs: 0.066 (npz
    weights, logits up to 2.2: four ulps) and 0.0059 (random weights);
    held to 0.125, with identical argmax on every read whose JAX margin is
    >= 0.25."""
    jp, tp = both_params
    got, ref = _both_bf16(jp, tp, *batch, semantics, k)
    assert got.shape == ref.shape == (B, 2) and got.dtype == np.float32
    assert np.abs(got - ref).max() <= 0.125
    sure = np.abs(ref[:, 1] - ref[:, 0]) >= 0.25
    np.testing.assert_array_equal(got.argmax(1)[sure], ref.argmax(1)[sure])


def test_bf16_differs_from_fp32(both_params, batch):
    """bf16 compute really rounds (the fp32 default is untouched)."""
    jp, tp = both_params
    tok = torch.from_numpy(batch[0])
    fp32 = tb.bilstm_logits(tp, tok)
    assert torch.equal(fp32, tb.bilstm_logits(tp, tok, compute_dtype=torch.float32))
    bf16 = tb.bilstm_logits(tp, tok, compute_dtype=torch.bfloat16)
    assert bf16.dtype == torch.float32
    assert 0 < (bf16 - fp32).abs().max().item() <= 0.5


@pytest.mark.parametrize("k", [0, 1, 7, 36])
def test_zero_prefix_state_bf16_matches_jax(both_params, k):
    """The bf16 backward-carry init. Measured max-abs 2^-7 (k=36: one ulp of
    a c in [1, 2)); held to two such ulps."""
    jp, tp = both_params
    jh, jc = jb.zero_prefix_state(jp, k, compute_dtype=jnp.bfloat16)
    th, tc = tb.zero_prefix_state(tp, k, compute_dtype=torch.bfloat16)
    assert th.dtype == tc.dtype == torch.bfloat16
    assert th.shape == tc.shape == (1, 128)
    for t, j in ((th, jh), (tc, jc)):
        assert np.abs(t.float().numpy() - np.asarray(j, np.float32)).max() <= 2 ** -6


def test_dense_gather_index_rules():
    tok = np.array([[0, 1, 4, 4], [4, 4, 4, 4], [4, 2, 4, 3], [3, 3, 3, 3]],
                   np.uint8)
    got = tb.dense_gather_index(torch.from_numpy(tok)).numpy()
    ref = np.asarray(jb.dense_gather_index(jnp.asarray(tok)))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, [1, 3, 3, 3])  # all-pad -> T-1
    one = np.array([[4], [0]], np.uint8)
    np.testing.assert_array_equal(
        tb.dense_gather_index(torch.from_numpy(one)).numpy(), [0, 0]
    )
    with pytest.raises(ValueError, match="T >= 1"):
        tb.dense_gather_index(torch.zeros((2, 0), dtype=torch.uint8))


def test_packed_length_clamp(both_params, batch):
    """A length > T behaves as T (never bias-only logits), like the JAX
    forward's clamp."""
    _, tp = both_params
    tok, _ = batch
    t = torch.from_numpy(tok)
    at_t = tb.bilstm_logits(tp, t, torch.full((B,), T, dtype=torch.int32),
                            semantics="packed")
    over = tb.bilstm_logits(tp, t, torch.full((B,), T + 50, dtype=torch.int32),
                            semantics="packed")
    torch.testing.assert_close(over, at_t, rtol=0, atol=0)


def test_contract_guards(both_params, batch):
    _, tp = both_params
    tok = torch.from_numpy(batch[0])
    with pytest.raises(ValueError, match="unknown semantics"):
        tb.bilstm_logits(tp, tok, semantics="ragged")
    with pytest.raises(ValueError, match="requires lengths"):
        tb.bilstm_logits(tp, tok, semantics="packed")
    with pytest.raises(ValueError, match="dense-semantics"):
        tb.bilstm_logits(tp, tok, torch.ones(B, dtype=torch.int32),
                         semantics="packed", bwd_init=tb.zero_prefix_state(tp, 3))
    empty = tb.bilstm_logits(tp, torch.zeros((0, T), dtype=torch.uint8))
    assert tuple(empty.shape) == (0, 2)


def test_params_from_numpy_round_trip(ref_params_path):
    jp = jb.load_params(ref_params_path)
    arrays = {k: np.asarray(v) for k, v in jp._asdict().items()}
    tp = tb.params_from_numpy(arrays)
    assert tp._fields == jp._fields
    for k in tp._fields:
        t = getattr(tp, k)
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), arrays[k])
    loaded = tb.load_params(ref_params_path)
    for a, b in zip(loaded, tp):
        assert torch.equal(a, b)
    assert sum(int(p.numel()) for p in tp) == 136706  # stored parameters
