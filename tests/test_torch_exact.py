"""The exact kernel's arithmetic on the CPU: the three-limb bf16 split, the
six limb products (lstm_cuda.exact_product, bilstm_logits_exact_plain)
against the fp32 recurrence and the Pallas x6 kernel in interpret mode on
the same numpy-seeded inputs, the planted faults that show what exact's
gate sees, and the wrapper's weight layouts.

The kernel itself needs the card: tests/test_torch_card_kernels.py holds
it there to the fp32 recurrence (max-abs <= 1e-4, no argmax flip at a
margin >= 1e-4) and, bit for bit, with W_hh = 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ribodetector_tpu.models import bilstm as jb
from ribodetector_tpu.ops.lstm_pallas import bilstm_logits_pallas
from ribodetector_tpu_torch.models import bilstm as tb
from ribodetector_tpu_torch.ops import lstm_cuda

TOL = 1e-4  # exact's gate on the card


@pytest.fixture(scope="module")
def params(ref_params_path):
    jp = jb.load_params(ref_params_path)
    return jp, tb.params_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()})


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: the plain versions are many small ops a step,
    which a shared, oversubscribed CPU slows many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _values(kind, rng):
    if kind == "normal":
        return rng.standard_normal(4096)
    if kind == "near_powers_of_two":  # 2^e and up to 3 ulps either side
        bits = np.ldexp(1.0, rng.integers(-60, 60, 1024)).astype(np.float32).view(np.int32)
        return (bits + rng.integers(-3, 4, 1024).astype(np.int32)).view(np.float32)
    if kind == "huge":  # up to 3e38, under bf16's largest finite value
        return rng.uniform(1, 3, 1024) * 10.0 ** rng.integers(30, 39, 1024)
    return rng.uniform(1, 10, 1024) * 10.0 ** -rng.integers(20, 30, 1024)  # tiny


@pytest.mark.parametrize("kind", ["normal", "near_powers_of_two", "huge", "tiny"])
def test_split_bf16x3_reconstructs_fp32(kind):
    """x1 + x2 + x3 == x exactly (summed in float64), each limb a bf16
    value, on random normals, values a few ulps from powers of two, and
    magnitudes from 1e-29 to 3e38, both signs."""
    rng = np.random.default_rng(3)
    v = _values(kind, rng)
    x = torch.from_numpy((v * rng.choice([-1.0, 1.0], v.shape)).astype(np.float32))
    assert torch.isfinite(x).all() and (x != 0).all()
    limbs = lstm_cuda.split_bf16x3(x)
    for limb in limbs:
        assert torch.equal(limb, limb.to(torch.bfloat16).float())
    total = limbs[0].double() + limbs[1].double() + limbs[2].double()
    assert torch.equal(total, x.double())
    # each limb is at most 2^-8 of the one before: the tail holds what is left
    assert (limbs[1].abs() <= 2.0 ** -8 * limbs[0].abs()).all()
    assert (limbs[2].abs() <= 2.0 ** -8 * limbs[1].abs()).all()


@pytest.fixture(scope="module")
def batches():
    out = {}
    for T in (100, 300):
        rng = np.random.default_rng(5)
        tok = rng.integers(0, 5, (13, T)).astype(np.uint8)
        tok[4] = 4
        tok[7, T // 2:] = 4
        out[T] = tok, rng.integers(0, T + 3, 13).astype(np.int32)
    return out


@pytest.mark.parametrize("T", [100, 300])
@pytest.mark.parametrize("semantics,k", [("dense", None), ("packed", None), ("dense", 11)])
def test_exact_plain_matches_fp32_and_pallas_x6(params, batches, T, semantics, k):
    """bilstm_logits_exact_plain (the six limb products summed k
    ascending) against the fp32 recurrence and the Pallas x6 kernel
    (precision HIGHEST) in interpret mode, dense, packed and with a
    backward-carry init: within exact's 1e-4 with the same argmax at every
    margin >= 1e-4, and within 2e-5 (measured: at most 3.5e-6 against
    fp32, 7.6e-6 against Pallas, which is itself 8.2e-6 from fp32)."""
    jp, tp = params
    tok, lengths = batches[T]
    jinit = tinit = None
    if k is not None:
        jinit, tinit = jb.zero_prefix_state(jp, k), tb.zero_prefix_state(tp, k)
    pallas = np.asarray(bilstm_logits_pallas(
        jp, jnp.asarray(tok), jnp.asarray(lengths), semantics=semantics, matmul="x6",
        interpret=True, bwd_init=jinit))
    kw = dict(semantics=semantics, bwd_init=tinit)
    t, n = torch.from_numpy(tok), torch.from_numpy(lengths)
    got = lstm_cuda.bilstm_logits_exact_plain(tp, t, n, **kw).numpy()
    fp32 = tb.bilstm_logits(tp, t, n, **kw).numpy()
    for ref in (fp32, pallas):
        assert got.shape == ref.shape == (13, 2) and np.isfinite(got).all()
        assert np.abs(got - ref).max() <= 2e-5
        sure = np.abs(ref[:, 1] - ref[:, 0]) >= TOL
        np.testing.assert_array_equal(got.argmax(1)[sure], ref.argmax(1)[sure])


def _random_token_reads(rng, n, T):
    tok = rng.integers(0, 4, (n, T)).astype(np.uint8)
    lengths = rng.integers(1, T + 1, n)
    tok[np.arange(T)[None, :] >= lengths[:, None]] = 4
    tok[rng.random((n, T)) < 0.02] = 4
    return tok


def test_exact_plain_is_closer_to_fp32_than_high_plain(params):
    """On the same reads (npz weights, T = 100), the six-limb arithmetic
    sits closer to the fp32 recurrence than high's three products do, in
    the max and on the mean: high drops W2*h2 (2^-18 of the product) and
    rounds h's low limb, exact only ~2^-26 of it."""
    _, tp = params
    tok = torch.from_numpy(_random_token_reads(np.random.default_rng(47), 128, 100))
    fp32 = tb.bilstm_logits(tp, tok)
    exact = (lstm_cuda.bilstm_logits_exact_plain(tp, tok) - fp32).abs()
    high = (lstm_cuda.bilstm_logits_high_plain(tp, tok) - fp32).abs()
    assert exact.max() < high.max() / 4 and exact.mean() < high.mean() / 4
    assert exact.max() > 0  # another order of the sum: close, not identical


SMALL = dict(zip(("w1h2", "w2h1", "w1h3", "w3h1", "w2h2"), lstm_cuda.EXACT_SMALL_PRODUCTS))


def _faulty_exact_plain(tp, tokens, fault):
    """bilstm_logits_exact_plain summed in 16-wide k blocks as the kernel
    sums (the yardstick), with one planted fault (None: none): a limb
    product dropped, all six products in one accumulator, the third h limb
    taken as bf16(h - h1) (the second's), the tanh form of the sigmoid, two
    gates swapped, or the token row of the next step."""
    limbs = [lstm_cuda.split_bf16x3(w) for w in (tp.w_hh_f, tp.w_hh_b)]
    small = [p for name, p in SMALL.items() if fault != f"{name}_dropped"]

    def product(hl, wl):
        big = torch.zeros((hl[0].shape[0], wl[0].shape[1]))
        sm = torch.zeros_like(big)
        for k0 in range(0, wl[0].shape[0], 16):
            k = slice(k0, k0 + 16)
            big = big + hl[0][:, k] @ wl[0][k]
            for a, b in small:
                if fault == "one_accumulator":
                    big = big + hl[a][:, k] @ wl[b][k]
                else:
                    sm = sm + hl[a][:, k] @ wl[b][k]
        return big + sm

    def sig(x):
        if fault == "tanh_sigmoid":
            return 0.5 * torch.tanh(0.5 * x) + 0.5
        return torch.sigmoid(x)

    def cell(h, c, gates_x, d):
        hl = lstm_cuda.split_bf16x3(h)
        if fault == "h3_as_h2":
            hl = (hl[0], hl[1], lstm_cuda.bf16_round(h - hl[0]))
        i, f, g, o = (product(hl, limbs[d]) + gates_x).chunk(4, dim=-1)
        if fault == "i_f_swapped":
            i, f = f, i
        c_new = sig(f) * c + sig(i) * torch.tanh(g)
        return sig(o) * torch.tanh(c_new), c_new

    if fault == "next_token_row":
        tokens = tokens.roll(-1, dims=1)
    last_out = tb.bilstm_last_out(tp, tokens, None, semantics="dense", bwd_init=None,
                                  cell=cell)
    return tb.head(tp, last_out).numpy()


@pytest.fixture(scope="module")
def exact_fault_reads(params):
    """Reads for the planted exact faults (npz weights, T = 100), the fp32
    logits, the yardstick's, and the fp32 logits with W_hh = 0; the
    fault-free copy is checked against the yardstick bit for bit."""
    _, tp = params
    tok = torch.from_numpy(_random_token_reads(np.random.default_rng(43), 256, 100))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yard = lstm_cuda.YARDSTICK["exact"](tp, tok).numpy()
        np.testing.assert_array_equal(_faulty_exact_plain(tp, tok, None), yard)
        fp32 = tb.bilstm_logits(tp, tok).numpy()
        fp32_0 = tb.bilstm_logits(lstm_cuda.zero_product_params(tp), tok).numpy()
    finally:
        torch.set_num_threads(n)
    return tok, fp32, yard, fp32_0


# planted exact faults -> (exact's gate sees it: max-abs > 1e-4 or a flip
# at a margin >= 1e-4 against the fp32 recurrence; a mean-abs above 4x the
# yardstick's sees it; bit identity with W_hh = 0 sees it), on 256 reads
# with the npz weights at T = 100. Dropping W1*h2 or W2*h1 (2^-9 of the
# product) moves the logits by up to 0.025-0.054; dropping one of the
# three smallest products (2^-17 of it) by 4.6e-5 to 6.8e-5 at most,
# inside the 1e-4 gate, but 10-21x the yardstick's mean-abs (6.1e-7). All
# six products in one fp32 accumulator is another order of the sum (the
# accumulators matter only under the tensor cores' truncating sums), and
# the tanh form of the sigmoid an ulp a step: the gate sees neither, the
# latter breaks bit identity with W_hh = 0, where every product fault
# vanishes
EXACT_FAULTS = {
    "w1h2_dropped": (True, True, False), "w2h1_dropped": (True, True, False),
    "w1h3_dropped": (False, True, False), "w3h1_dropped": (False, True, False),
    "w2h2_dropped": (False, True, False), "one_accumulator": (False, False, False),
    "h3_as_h2": (True, True, False), "tanh_sigmoid": (False, False, True),
    "i_f_swapped": (True, True, True), "next_token_row": (True, True, True),
}


@pytest.mark.parametrize("fault", list(EXACT_FAULTS))
def test_exact_gate_against_a_planted_fault(params, exact_fault_reads, fault):
    """Which limb product dropped or mis-ordered, or which cell fault,
    exact's checks see (EXACT_FAULTS): the 1e-4 gate against the fp32
    recurrence, a mean-abs of 4x the yardstick's, and bit identity with
    W_hh = 0."""
    _, tp = params
    tok, fp32, yard, fp32_0 = exact_fault_reads
    got = _faulty_exact_plain(tp, tok, fault)
    margin = np.abs(fp32[:, 1] - fp32[:, 0])
    diff = np.abs(got - fp32)
    flips = (got.argmax(1) != fp32.argmax(1))[margin >= TOL].sum()
    gate_sees = bool(diff.max() > TOL or flips > 0)
    mean_sees = bool(diff.mean() > 4 * np.abs(yard - fp32).mean())
    zero = _faulty_exact_plain(lstm_cuda.zero_product_params(tp), tok, fault)
    zero_sees = not np.array_equal(zero, fp32_0)
    assert (gate_sees, mean_sees, zero_sees) == EXACT_FAULTS[fault], \
        (diff.max(), diff.mean(), np.abs(yard - fp32).mean(), flips)


def test_wrapper_refuses_a_wrong_limb_layout(params):
    """kernel_weights lays W_hh out as each kernel reads it (exact: its
    three limbs, transposed, one bf16 [3, 2, G, H] whose limbs add up to
    W_hh^T exactly); check_weight_layout, which holds it to WEIGHT_SHAPES
    (kernel_weights applies it to what it builds, before every launch),
    passes that and refuses another shape, order, type, stride or limb
    count."""
    _, tp = params
    whh = torch.stack([tp.w_hh_f, tp.w_hh_b])
    for mode in lstm_cuda.MODES:
        lstm_cuda.check_weight_layout(mode, lstm_cuda.kernel_weights(mode, whh))
    (wl,) = lstm_cuda.kernel_weights("exact", whh)
    assert wl.shape == (3, 2, 512, 128) and wl.dtype == torch.bfloat16
    assert torch.equal(wl.double().sum(0), whh.transpose(1, 2).double())
    wrong = {
        "directions before limbs": (wl.transpose(0, 1).contiguous(),),
        "not transposed": (wl.transpose(2, 3).contiguous(),),
        "fp32": (wl.float(),),
        "strided": (wl.transpose(2, 3).contiguous().transpose(2, 3),),
        "two limbs": (wl[:2].contiguous(),),
        "high's layout": lstm_cuda.kernel_weights("high", whh),
    }
    for name, w in wrong.items():
        with pytest.raises(ValueError, match="takes W_hh as contiguous bf16"):
            lstm_cuda.check_weight_layout("exact", w)
    with pytest.raises(ValueError, match="takes W_hh as contiguous bf16"):
        lstm_cuda.check_weight_layout("high", (wl,))
    with pytest.raises(ValueError, match="takes W_hh as contiguous bf16"):
        lstm_cuda.check_weight_layout("fast", lstm_cuda.kernel_weights("high", whh))
