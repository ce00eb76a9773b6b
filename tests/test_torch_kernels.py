"""ribodetector_tpu_torch.ops.lstm_cuda against the Pallas kernels.

On the CPU the wrapper runs each kernel's plain torch version, so these
tests hold the plain versions against the Pallas kernels run in interpret
mode, on the same numpy-seeded inputs:

  "high"  bilstm_logits_high_plain  vs  bilstm_logits_pallas(matmul="x3")
  "exact" models.bilstm.bilstm_logits vs bilstm_logits_pallas(matmul="x6")

Tolerance (as in tests/test_pallas_kernel.py): max-abs <= 1e-4 on the
logits -- the two sides sum the split products in different orders -- and
identical argmax on every read whose reference margin is >= 1e-4.

The two "fast" kernels (the Pallas x1 pass):

  "fast_bf16" bilstm_logits_fast_plain(state_dtype=bf16) vs
              bilstm_logits_pallas(compute_dtype=bf16, precision=DEFAULT)
              -- interpret mode rounds as the TPU does, so this is a
              faithful CPU reference; see test_fast_bf16_plain_matches_pallas
              for the tolerance.
  "fast"      bilstm_logits_fast_plain(state_dtype=fp32) vs
              bilstm_logits_pallas(matmul="x1") -- on the CPU XLA ignores
              Precision.DEFAULT, so the JAX side is the fp32 recurrence and
              only the fast class's argmax bound applies.

Tests of the CUDA kernels themselves need the card and skip here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ribodetector_tpu.models import bilstm as jb
from ribodetector_tpu.ops.lstm_pallas import bilstm_logits_pallas
from ribodetector_tpu_torch.models import bilstm as tb
from ribodetector_tpu_torch.ops import lstm_cuda

TOL = 1e-4
B, T = 13, 23  # ragged batch, odd T


@pytest.fixture(scope="module")
def params(ref_params_path):
    jp = jb.load_params(ref_params_path)
    return jp, tb.params_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()})


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(5)
    tok = rng.integers(0, 5, (B, T)).astype(np.uint8)
    tok[4] = 4
    tok[7, 12:] = 4
    lengths = rng.integers(0, T + 3, B).astype(np.int32)
    return tok, lengths


def _assert_close(got, ref):
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= TOL
    margin = np.abs(ref[:, 1] - ref[:, 0])
    sure = margin >= 1e-4
    np.testing.assert_array_equal(got.argmax(1)[sure], ref.argmax(1)[sure])


@pytest.mark.parametrize("mode,matmul", [("high", "x3"), ("exact", "x6")])
@pytest.mark.parametrize("semantics,k", [("dense", None), ("packed", None),
                                         ("dense", 11)])
def test_plain_matches_pallas(params, batch, mode, matmul, semantics, k):
    jp, tp = params
    tok, lengths = batch
    jinit = tinit = None
    if k is not None:
        jinit = jb.zero_prefix_state(jp, k)
        tinit = tb.zero_prefix_state(tp, k)
    ref = np.asarray(bilstm_logits_pallas(
        jp, jnp.asarray(tok), jnp.asarray(lengths), semantics=semantics,
        matmul=matmul, interpret=True, bwd_init=jinit))
    lstm_cuda.reset_launches()
    got = lstm_cuda.bilstm_logits_cuda(
        tp, torch.from_numpy(tok), torch.from_numpy(lengths),
        semantics=semantics, mode=mode, bwd_init=tinit).numpy()
    _assert_close(got, ref)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert lstm_cuda.LAUNCHES == {m: 0 for m in lstm_cuda.MODES}


def _random_arrays(seed):
    rng = np.random.default_rng(seed)
    u = lambda *shape: rng.uniform(-0.3, 0.3, shape).astype(np.float32)
    return {
        "w_ih_f": u(4, 512), "w_hh_f": u(128, 512), "b_f": u(512),
        "w_ih_b": u(4, 512), "w_hh_b": u(128, 512), "b_b": u(512),
        "w_out": u(256, 2), "b_out": u(2),
    }


@pytest.fixture(scope="module", params=["npz", "random"])
def both_params(request, ref_params_path):
    """The shipped weights and random weights of the same shapes."""
    if request.param == "npz":
        arrays = {k: np.asarray(v)
                  for k, v in jb.load_params(ref_params_path)._asdict().items()}
    else:
        arrays = _random_arrays(17)
    jp = jb.BiLSTMParams(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return jp, tb.params_from_numpy(arrays)


def _fast_pair(jp, tp, tok, lengths, semantics, k, bf16):
    """(port plain fast logits, Pallas x1 interpret logits) on one batch."""
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    jinit = tinit = None
    if k is not None:  # as the pipelines build it: the scan in compute dtype
        jinit = jb.zero_prefix_state(jp, k, compute_dtype=jdt)
        tinit = tb.zero_prefix_state(tp, k, compute_dtype=tdt)
    ref = np.asarray(bilstm_logits_pallas(
        jp, jnp.asarray(tok), jnp.asarray(lengths), semantics=semantics,
        compute_dtype=jdt, precision=jax.lax.Precision.DEFAULT, matmul="x1",
        interpret=True, bwd_init=jinit))
    lstm_cuda.reset_launches()
    got = lstm_cuda.bilstm_logits_cuda(
        tp, torch.from_numpy(tok), torch.from_numpy(lengths),
        semantics=semantics, mode="fast_bf16" if bf16 else "fast",
        bwd_init=tinit).numpy()
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert lstm_cuda.LAUNCHES == {m: 0 for m in lstm_cuda.MODES}
    assert got.shape == ref.shape == (B, 2) and np.isfinite(got).all()
    return got, ref


FAST_SETTINGS = [("dense", None), ("packed", None), ("dense", 11)]


@pytest.mark.parametrize("semantics,k", FAST_SETTINGS)
def test_fast_bf16_plain_matches_pallas(both_params, batch, semantics, k):
    """The bf16-state plain version against the Pallas x1 kernel in bf16
    compute, interpret mode. Both round the gates and every elementwise op
    to bf16, but the Pallas dot sums its 136 products (128 recurrent + the
    one-hot token column) in XLA's order and the plain version in the
    kernel's (k ascending, then the token row): once h is rounded to bf16
    that 1-ulp fp32 difference flips a bf16 rounding now and then, and the
    flips compound over T. Measured max-abs on these inputs: 0.0060 (npz
    weights, dense + bwd_init) and 0.0036 (random weights); held to 0.02,
    with identical argmax on every read whose JAX margin is >= 0.25."""
    jp, tp = both_params
    got, ref = _fast_pair(jp, tp, *batch, semantics, k, bf16=True)
    assert np.abs(got - ref).max() <= 0.02
    sure = np.abs(ref[:, 1] - ref[:, 0]) >= 0.25
    np.testing.assert_array_equal(got.argmax(1)[sure], ref.argmax(1)[sure])


@pytest.mark.parametrize("semantics,k", FAST_SETTINGS)
def test_fast_plain_is_in_the_fast_class(both_params, batch, semantics, k):
    """The fp32-state plain version against Pallas x1 with fp32 compute.
    On the CPU, XLA ignores Precision.DEFAULT: the JAX side is the exact
    fp32 recurrence (equal to x6), not what the TPU's single bf16 pass
    computes, so no logit tolerance tighter than the fast class's can hold
    (bf16 operands move logits by ~1e-2). Held to the class's bound, as
    tests/test_pallas_kernel.py holds x1: argmax concordance >= 0.95 and no
    flip at a JAX margin >= 0.25."""
    jp, tp = both_params
    got, ref = _fast_pair(jp, tp, *batch, semantics, k, bf16=False)
    flipped = got.argmax(1) != ref.argmax(1)
    assert (~flipped).mean() >= 0.95
    assert not flipped[np.abs(ref[:, 1] - ref[:, 0]) >= 0.25].any()


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), rows=st.integers(1, 9),
       scale=st.sampled_from([1e-3, 1.0, 30.0]))
def test_gate_product_is_the_fp32_sum_of_exact_products(seed, rows, scale):
    """The fast plain versions' recurrent product: every product of two
    bf16 values is exact in fp32, and the sum is the fp32 sum over k
    ascending, one rounding per add -- bit for bit."""
    rng = np.random.default_rng(seed)
    h = lstm_cuda.bf16_round(torch.from_numpy(
        rng.uniform(-1, 1, (rows, 128)).astype(np.float32)))
    w = lstm_cuda.bf16_round(torch.from_numpy(
        (scale * rng.standard_normal((128, 16))).astype(np.float32)))
    got = lstm_cuda.gate_product(h, w).numpy()
    hn, wn = h.numpy(), w.numpy()
    prod32 = hn[:, :, None] * wn[None]  # [rows, 128, 16] in fp32
    np.testing.assert_array_equal(
        prod32, (hn[:, :, None].astype(np.float64) * wn[None]).astype(np.float32))
    want = np.zeros((rows, 16), np.float32)
    for k in range(128):
        want = want + prod32[:, k]
    np.testing.assert_array_equal(got, want)


def test_high_plain_is_the_limb_arithmetic(params, batch):
    """The plain high version differs from exact only by the dropped
    Wlo*hlo term and the sigmoid's rounding: close, not identical."""
    _, tp = params
    tok, _ = batch
    t = torch.from_numpy(tok)
    high = lstm_cuda.bilstm_logits_high_plain(tp, t)
    exact = tb.bilstm_logits(tp, t)
    diff = (high - exact).abs().max().item()
    assert 0 < diff <= 1e-3


def test_split_bf16_limbs():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, -3.14159265, 1e-8])
    hi, lo = lstm_cuda.split_bf16(x)
    assert torch.equal(hi, hi.to(torch.bfloat16).float())
    assert torch.equal(lo, lo.to(torch.bfloat16).float())
    assert ((hi + lo) - x).abs().max().item() <= 2 ** -16 * x.abs().max().item()


def test_wrapper_guards(params, batch):
    _, tp = params
    tok = torch.from_numpy(batch[0])
    lens = torch.from_numpy(batch[1])
    narrow = tb.params_from_numpy({
        k: np.zeros(s, np.float32) for k, s in {
            "w_ih_f": (4, 256), "w_hh_f": (64, 256), "b_f": (256,),
            "w_ih_b": (4, 256), "w_hh_b": (64, 256), "b_b": (256,),
            "w_out": (128, 2), "b_out": (2,)}.items()})
    with pytest.raises(ValueError, match="hidden width 128"):
        lstm_cuda.bilstm_logits_cuda(narrow, tok)
    with pytest.raises(ValueError, match="requires lengths"):
        lstm_cuda.bilstm_logits_cuda(tp, tok, semantics="packed")
    with pytest.raises(ValueError, match="dense-semantics"):
        lstm_cuda.bilstm_logits_cuda(tp, tok, lens, semantics="packed",
                                     bwd_init=tb.zero_prefix_state(tp, 2))
    with pytest.raises(ValueError, match="unknown semantics"):
        lstm_cuda.bilstm_logits_cuda(tp, tok, semantics="ragged")
    with pytest.raises(ValueError, match="precision mode"):
        lstm_cuda.bilstm_logits_cuda(tp, tok, mode="turbo")
    with pytest.raises(ValueError, match="state_dtype"):
        lstm_cuda.bilstm_logits_fast_plain(tp, tok, state_dtype=torch.float16)
    for mode in lstm_cuda.MODES:
        empty = lstm_cuda.bilstm_logits_cuda(
            tp, torch.zeros((0, T), dtype=torch.uint8), mode=mode)
        assert tuple(empty.shape) == (0, 2) and empty.dtype == torch.float32


@pytest.mark.parametrize("mode", lstm_cuda.MODES)
def test_wrapper_length_clamp(params, batch, mode):
    _, tp = params
    tok = torch.from_numpy(batch[0])
    at_t = lstm_cuda.bilstm_logits_cuda(
        tp, tok, torch.full((B,), T, dtype=torch.int32), semantics="packed",
        mode=mode)
    over = lstm_cuda.bilstm_logits_cuda(
        tp, tok, torch.full((B,), 10 * T, dtype=torch.int32),
        semantics="packed", mode=mode)
    torch.testing.assert_close(over, at_t, rtol=0, atol=0)


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda_params(ref_params_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return tb.load_params(ref_params_path, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", lstm_cuda.MODES)
@pytest.mark.parametrize("semantics,k", [("dense", None), ("packed", None),
                                         ("dense", 36)])
def test_kernel_matches_plain_on_card(cuda_params, mode, semantics, k):
    rng = np.random.default_rng(9)
    Bc, Tc = 2048 + 37, 64
    tok = torch.from_numpy(rng.integers(0, 5, (Bc, Tc)).astype(np.uint8)).cuda()
    lens = torch.from_numpy(rng.integers(0, Tc + 2, Bc).astype(np.int32)).cuda()
    init = tb.zero_prefix_state(cuda_params, k) if k else None
    plain = lstm_cuda.PLAIN[mode]
    lstm_cuda.reset_launches()
    got = lstm_cuda.bilstm_logits_cuda(cuda_params, tok, lens, semantics=semantics,
                                       mode=mode, bwd_init=init)
    torch.cuda.synchronize()
    assert lstm_cuda.LAUNCHES[mode] == 1
    ref = plain(cuda_params, tok, lens, semantics=semantics, bwd_init=init)
    _assert_close(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_params):
    tok = torch.zeros((8, 10), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="uint8"):
        lstm_cuda.bilstm_logits_cuda(cuda_params, tok)
    tok8 = torch.zeros((10, 8), dtype=torch.uint8, device="cuda").T
    with pytest.raises(ValueError, match="contiguous"):
        lstm_cuda.bilstm_logits_cuda(cuda_params, tok8)
