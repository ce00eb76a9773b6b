"""The CUDA kernels of ribodetector_tpu_torch on the card, each against its
plain torch version (ops/lstm_cuda.py PLAIN) on the same reads.

These tests need a CUDA card and skip without one. They import neither jax
nor the JAX package, and need none of tests/conftest.py (which imports
jax), so they run where the card is:

    python3 -m pytest --noconftest -q tests/test_torch_card_*.py

(chip_smoke.py's card_tests phase runs that command and fails on any skip.)

  exact      within 1e-4 of the plain fp32 recurrence, no argmax flip at a
             plain margin >= 1e-4 (its limbs hold all of h and W_hh, so only
             the order of the sum differs), and on the mean no more than 4x
             as far from it as the yardstick (the six-limb arithmetic
             summed in 16-wide k blocks);
  high, fast, fast_bf16
             within lstm_cuda.TC_GATE of their plain versions, beside the
             yardstick (the plain version summed in 16-wide k blocks) on
             the same reads;
  all four   at T = 64 and 300 (exact at 100 too), dense and packed (and
             with a backward-carry init); bit for bit with W_hh = 0, where no
             summation order changes the product
             (lstm_cuda.zero_product_params), and row-invariant: a read's
             logits are the same bits whatever batch it sits in.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import ribodetector_tpu_torch
from ribodetector_tpu_torch.models import bilstm as tb
from ribodetector_tpu_torch.ops import lstm_cuda

NPZ = Path(ribodetector_tpu_torch.__file__).resolve().parent / "data" / "ribodetector_v1.npz"
TOL = 1e-4
EXACT_MEAN_VS_YARDSTICK = 4.0  # as chip_smoke.py's kernels phase

# the condition is a string: pytest evaluates it when each test is set up,
# not when the module is imported
pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif("not torch.cuda.is_available()",
                                 reason="needs a CUDA card (the kernels have no CPU mode)")]


@pytest.fixture(scope="module")
def cuda_params():
    return tb.load_params(str(NPZ), "cuda")


def _assert_close(got, ref):
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= TOL
    margin = np.abs(ref[:, 1] - ref[:, 0])
    sure = margin >= 1e-4
    np.testing.assert_array_equal(got.argmax(1)[sure], ref.argmax(1)[sure])


def _random_token_reads(rng, n, T):
    """Token rows with pads after a random length and a few interior N
    calls (as the chip's kernel checks make them)."""
    tok = rng.integers(0, 4, (n, T)).astype(np.uint8)
    lengths = rng.integers(1, T + 1, n)
    tok[np.arange(T)[None, :] >= lengths[:, None]] = 4
    tok[rng.random((n, T)) < 0.02] = 4
    return tok


@pytest.mark.parametrize("mode", lstm_cuda.MODES)
@pytest.mark.parametrize("semantics,k", [("dense", None), ("packed", None),
                                         ("dense", 36)])
def test_kernel_matches_plain_on_card(cuda_params, mode, semantics, k):
    _check_kernel_on_card(cuda_params, mode, semantics, k, 64)


@pytest.mark.parametrize("mode", lstm_cuda.MODES)
@pytest.mark.parametrize("semantics,k", [("dense", 44), ("packed", None)])
def test_kernel_matches_plain_at_t300_on_card(cuda_params, mode, semantics, k):
    """The -l 300 grid's full bucket: T = 300 dense with the 44-step
    backward init that the 256 bucket's reads start from, and packed."""
    _check_kernel_on_card(cuda_params, mode, semantics, k, 300)


@pytest.mark.parametrize("semantics", ["dense", "packed"])
def test_exact_kernel_matches_plain_at_t100_on_card(cuda_params, semantics):
    """exact at the -l 100 path's full length (chip_smoke.py's kernels
    phase holds every kernel there, at 16384 + 37 reads)."""
    _check_kernel_on_card(cuda_params, "exact", semantics, None, 100)


def _check_kernel_on_card(cuda_params, mode, semantics, k, Tc):
    rng = np.random.default_rng(9)
    Bc = 2048 + 37
    tok = torch.from_numpy(rng.integers(0, 5, (Bc, Tc)).astype(np.uint8)).cuda()
    lens = torch.from_numpy(rng.integers(0, Tc + 2, Bc).astype(np.int32)).cuda()
    init = None
    if k:
        dt = torch.bfloat16 if mode == "fast_bf16" else torch.float32
        init = tb.zero_prefix_state(cuda_params, k, compute_dtype=dt)
    plain = lstm_cuda.PLAIN[mode]
    lstm_cuda.reset_launches()
    got = lstm_cuda.bilstm_logits_cuda(cuda_params, tok, lens, semantics=semantics,
                                       mode=mode, bwd_init=init)
    torch.cuda.synchronize()
    assert lstm_cuda.LAUNCH_COUNTS == {(tok.device.index, mode, Tc): 1}
    ref = plain(cuda_params, tok, lens, semantics=semantics, bwd_init=init)
    yard = lstm_cuda.YARDSTICK[mode](cuda_params, tok, lens, semantics=semantics,
                                     bwd_init=init).cpu().numpy()
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    if mode not in lstm_cuda.TC_GATE:
        _assert_close(got, ref)
        # 1e-4 cannot see a dropped third-limb product (EXACT_FAULTS in
        # tests/test_torch_exact.py); the mean can: exact is no more than
        # EXACT_MEAN_VS_YARDSTICK times as far from fp32 as its own
        # arithmetic summed in 16-wide k blocks (the yardstick)
        mean = np.abs(got - ref).mean()
        assert mean <= EXACT_MEAN_VS_YARDSTICK * max(np.abs(yard - ref).mean(), 1e-7), mean
    else:
        # the tensor cores sum in their own order, amplified: the stated
        # gate, beside the yardstick on the same reads
        assert np.isfinite(got).all()
        r = lstm_cuda.tc_gate(mode, got, ref, yard)
        assert r["within_gate"], r
    # and bit for bit where no order can change the product (against the
    # yardstick: with W_hh = 0 it equals the plain version bit for bit,
    # tests/test_torch_kernels.py, in a sixteenth of the launches)
    p0 = lstm_cuda.zero_product_params(cuda_params)
    assert torch.equal(
        lstm_cuda.bilstm_logits_cuda(p0, tok, lens, semantics=semantics,
                                     mode=mode, bwd_init=init),
        lstm_cuda.YARDSTICK[mode](p0, tok, lens, semantics=semantics, bwd_init=init))


@pytest.mark.parametrize("mode", lstm_cuda.MODES)
@pytest.mark.parametrize("semantics", ["dense", "packed"])
def test_tc_kernels_are_row_invariant_on_card(cuda_params, mode, semantics):
    """A read's logits depend only on its own tokens, bit for bit: the
    same reads shuffled, and some of them inside a batch of another size."""
    rng = np.random.default_rng(13)
    Bc, Tc = 1024 + 5, 100
    tok = torch.from_numpy(_random_token_reads(rng, Bc, Tc)).cuda()
    lens = torch.from_numpy(rng.integers(1, Tc + 1, Bc).astype(np.int32)).cuda()
    other = torch.from_numpy(_random_token_reads(rng, 77, Tc)).cuda()
    perm = torch.from_numpy(rng.permutation(Bc)).cuda()
    kw = dict(semantics=semantics, mode=mode)
    run = lstm_cuda.bilstm_logits_cuda
    base = run(cuda_params, tok, lens, **kw)
    assert torch.equal(run(cuda_params, tok[perm].contiguous(), lens[perm], **kw),
                       base[perm])
    mixed = run(cuda_params, torch.cat([other, tok[:300]]),
                torch.cat([lens[:77], lens[:300]]), **kw)
    assert torch.equal(mixed[77:], base[:300])


def test_kernel_refuses_what_it_does_not_take(cuda_params):
    tok = torch.zeros((8, 10), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="uint8"):
        lstm_cuda.bilstm_logits_cuda(cuda_params, tok)
    tok8 = torch.zeros((10, 8), dtype=torch.uint8, device="cuda").T
    with pytest.raises(ValueError, match="contiguous"):
        lstm_cuda.bilstm_logits_cuda(cuda_params, tok8)
