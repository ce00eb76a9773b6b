"""Device glue of the port against the JAX package: token unpacking (every
byte value, so the t2 clamp is covered) and on-device pair reconciliation
(all four ensure modes). Both are integer results: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ribodetector_tpu.ops import dispatch as jd
from ribodetector_tpu.runtime.ensure import paired_final_labels_jnp
from ribodetector_tpu_torch import native
from ribodetector_tpu_torch.models import bilstm as tb
from ribodetector_tpu_torch.ops import dispatch as td
from ribodetector_tpu_torch.runtime.ensure import (
    ENSURE_MODES,
    paired_final_labels,
    paired_final_labels_torch,
)

ALL_BYTES = np.arange(256, dtype=np.uint8)


@pytest.mark.parametrize("max_len", [1, 3, 7, 9])
def test_unpack_b5_all_bytes(max_len):
    pl = native.b5_packed_len(max_len)
    packed = np.stack([np.roll(ALL_BYTES, s) for s in range(pl)], axis=1)
    ref = np.asarray(jd.unpack_b5_tokens(jnp.asarray(packed), max_len))
    got = td.unpack_b5_tokens(torch.from_numpy(packed), max_len)
    assert got.dtype == torch.uint8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.max().item() <= 4  # corrupt bytes > 124 clamp to the pad token


@pytest.mark.parametrize("max_len", [1, 4, 6, 10])
def test_unpack_b2_all_bytes(max_len):
    pl = native.b2_packed_len(max_len)
    packed = np.stack([np.roll(ALL_BYTES, 3 * s) for s in range(pl)], axis=1)
    ref = np.asarray(jd.unpack_b2_tokens(jnp.asarray(packed), max_len))
    got = td.unpack_b2_tokens(torch.from_numpy(packed), max_len)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_unpack_inverts_the_native_packers():
    rng = np.random.default_rng(2)
    tok = rng.integers(0, 5, (9, 11)).astype(np.uint8)
    np.testing.assert_array_equal(
        td.unpack_b5_tokens(torch.from_numpy(native.pack_b5(tok)), 11).numpy(), tok
    )
    clean = rng.integers(0, 4, (9, 11)).astype(np.uint8)
    np.testing.assert_array_equal(
        td.unpack_b2_tokens(torch.from_numpy(native.pack_b2(clean)), 11).numpy(),
        clean,
    )


@pytest.mark.parametrize("ensure", ENSURE_MODES)
def test_pair_labels_match_jax(ensure):
    rng = np.random.default_rng(4)
    l1 = rng.normal(size=(64, 2)).astype(np.float32)
    l2 = rng.normal(size=(64, 2)).astype(np.float32)
    l1[:4] = 0.5  # argmax ties pick the first index on both sides
    l2[2:6] = -1.0
    ref = np.asarray(paired_final_labels_jnp(jnp.asarray(l1), jnp.asarray(l2), ensure))
    got = paired_final_labels_torch(torch.from_numpy(l1), torch.from_numpy(l2), ensure)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), paired_final_labels(l1, l2, ensure))


def test_pair_labels_unknown_mode():
    with pytest.raises(ValueError, match="unknown ensure mode"):
        paired_final_labels_torch(torch.zeros((1, 2)), torch.zeros((1, 2)), "all")


def test_kernel_choice_follows_the_device(ref_params_path):
    assert td.resolve_kernel("auto", "cpu") == "plain"
    assert td.resolve_kernel("auto", "cuda") == "cuda"
    assert td.resolve_kernel("plain", "cpu") == "plain"
    with pytest.raises(ValueError, match="needs the card"):
        td.resolve_kernel("cuda", "cpu")
    with pytest.raises(ValueError, match="on the card"):
        td.resolve_kernel("plain", "cuda:0")
    with pytest.raises(ValueError, match="unknown kernel"):
        td.resolve_kernel("pallas", "cpu")
    params = tb.load_params(ref_params_path)
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, 5, (5, 12)).astype(np.uint8))
    got = td.classify_logits(params, tok, kernel="auto")
    torch.testing.assert_close(got, tb.bilstm_logits(params, tok), rtol=0, atol=0)
    with pytest.raises(ValueError, match="needs the card"):
        td.classify_logits(params, tok, kernel="cuda")


@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_custom_width_kernel_choice_on_the_card(device):
    """A hidden width other than 128 runs the plain recurrence on the card
    (auto), as the JAX package runs its scan where its Pallas kernel cannot;
    an explicit cuda kernel at that width raises, and plain at 128 on the
    card still raises. Decided from the device's type: no card needed."""
    assert td.resolve_kernel("auto", device, 64) == "plain"
    assert td.resolve_kernel("plain", device, 64) == "plain"
    assert td.resolve_kernel("auto", device, 128) == "cuda"
    assert td.resolve_kernel("cuda", device, 128) == "cuda"
    with pytest.raises(ValueError, match="hidden width 128 only"):
        td.resolve_kernel("cuda", device, 64)
    with pytest.raises(ValueError, match="on the card"):
        td.resolve_kernel("plain", device, 128)
    assert td.resolve_kernel("auto", "cpu", 64) == "plain"
    with pytest.raises(ValueError, match="needs the card"):
        td.resolve_kernel("cuda", "cpu", 64)


def test_kernel_mode_table():
    """Which CUDA kernel each precision runs under each compute dtype, as
    the JAX pipeline maps them onto the Pallas modes (x3 -> x1 under bf16;
    x6 refused under bf16)."""
    f32, bf16 = torch.float32, torch.bfloat16
    for mode in ("exact", "high", "fast"):
        assert td.kernel_mode(mode, f32) == mode
    assert td.kernel_mode("high", bf16) == "fast_bf16"
    assert td.kernel_mode("fast", bf16) == "fast_bf16"
    with pytest.raises(ValueError, match="requires float32"):
        td.kernel_mode("exact", bf16)
    with pytest.raises(ValueError, match="unknown precision"):
        td.kernel_mode("turbo", f32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        td.kernel_mode("fast", torch.float16)


@pytest.mark.parametrize("mode", td.PRECISIONS)
def test_cpu_classify_runs_the_scan_in_the_compute_dtype(ref_params_path, mode):
    """On the CPU the precision does not change the plain recurrence, as the
    JAX package's CPU scan ignores its precision mode; the compute dtype
    does (exact under bf16 included: only the card refuses it)."""
    params = tb.load_params(ref_params_path)
    tok = torch.from_numpy(np.random.default_rng(3).integers(0, 5, (6, 15)).astype(np.uint8))
    for dt in (torch.float32, torch.bfloat16):
        got = td.classify_logits(params, tok, mode=mode, compute_dtype=dt)
        torch.testing.assert_close(got, tb.bilstm_logits(params, tok, compute_dtype=dt),
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown precision"):
        td.classify_logits(params, tok, mode="fast_bf16")
