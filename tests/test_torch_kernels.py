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

The three tensor-core kernels (high, fast, fast_bf16) sum their product
in the tensor cores' own order, so on the card they are held to their
plain versions by lstm_cuda.TC_GATE (test_high_gate_holds_a_summation_order
and test_fast_gate_holds_a_summation_order ground it; the planted-fault
tests show what it catches) and, bit for bit, with W_hh = 0
(lstm_cuda.zero_product_params, where no summation order changes the
product);
exact is held to 1e-4 there. The plain high version summed in 16-wide k
blocks (the yardstick) is held to the Pallas x3 kernel like the plain one.

Tests of the CUDA kernels themselves need the card and skip here.
"""

import os

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


@pytest.mark.parametrize("mode,matmul,k_block", [
    pytest.param("high", "x3", 1, id="high-x3"),
    pytest.param("exact", "x6", 1, id="exact-x6"),
    pytest.param("high", "x3", 16, id="high-x3-k16"),  # TC_GATE's yardstick
])
@pytest.mark.parametrize("semantics,k", [("dense", None), ("packed", None),
                                         ("dense", 11)])
def test_plain_matches_pallas(params, batch, mode, matmul, k_block, semantics, k):
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
    if k_block == 1:
        got = lstm_cuda.bilstm_logits_cuda(
            tp, torch.from_numpy(tok), torch.from_numpy(lengths),
            semantics=semantics, mode=mode, bwd_init=tinit).numpy()
    else:
        got = lstm_cuda.YARDSTICK[mode](
            tp, torch.from_numpy(tok), torch.from_numpy(lengths),
            semantics=semantics, bwd_init=tinit).numpy()
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


def _random_token_reads(rng, n, T):
    """Token rows with pads after a random length and a few interior N
    calls (as the chip's kernel checks make them)."""
    tok = rng.integers(0, 4, (n, T)).astype(np.uint8)
    lengths = rng.integers(1, T + 1, n)
    tok[np.arange(T)[None, :] >= lengths[:, None]] = 4
    tok[rng.random((n, T)) < 0.02] = 4
    return tok


@pytest.fixture
def one_thread():
    """torch on one thread: the plain fast versions are ~25600 small ops a
    call, which a shared, oversubscribed CPU slows many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", ["fast", "fast_bf16"])
def test_fast_gate_holds_a_summation_order(params, mode, one_thread):
    """TC_GATE against what a change of summation order alone does: the
    plain version with its recurrent product summed in 16-wide k blocks
    (the mma's k-step) stays inside the gate around the plain version as
    it is (npz weights, T = 100), and the gate's mean-abs lies well under
    the plain version's distance to exact, where a wrong rounding, gate or
    token would show."""
    _, tp = params
    tok = torch.from_numpy(_random_token_reads(np.random.default_rng(23), 2048, 100))
    dt = torch.bfloat16 if mode == "fast_bf16" else torch.float32
    plain = lstm_cuda.bilstm_logits_fast_plain(tp, tok, state_dtype=dt).numpy()
    blocked = lstm_cuda.bilstm_logits_fast_plain(tp, tok, state_dtype=dt,
                                                 k_block=16).numpy()
    exact = tb.bilstm_logits(tp, tok).numpy()
    r = lstm_cuda.tc_gate(mode, blocked, plain, blocked)
    assert r["max_abs"] > 0 and r["within_gate"], r
    assert np.abs(plain - exact).mean() >= 2 * lstm_cuda.TC_GATE[mode]["mean_abs"]


def _faulty_fast_plain(tp, tokens, mode, fault):
    """bilstm_logits_fast_plain with one planted fault (None: none), as a
    kernel might get one wrong: a rounding left out, the token row of the
    next step, or two gates swapped."""
    r = lstm_cuda.bf16_round
    bf16 = mode == "fast_bf16"
    w = (r(tp.w_hh_f), r(tp.w_hh_b))
    if bf16:
        def sig(x):
            return r(r(0.5 * r(torch.tanh(r(0.5 * x)))) + 0.5)

        def tanh(x):
            return r(torch.tanh(x))
    else:
        def sig(x):
            return torch.reciprocal(1.0 + torch.exp(-x))

        tanh = torch.tanh

    def cell(h, c, gates_x, d):
        h_in = h if bf16 or fault == "h_unrounded_in_product" else r(h)
        gx = gates_x if fault == "token_row_unrounded" else r(gates_x)
        gates = lstm_cuda.gate_product(h_in, w[d]) + gx
        if bf16 and fault != "gates_unrounded":
            gates = r(gates)
        i, f, g, o = gates.chunk(4, dim=-1)
        if fault == "i_f_swapped":
            i, f = f, i
        fc, ig = sig(f) * c, sig(i) * tanh(g)
        if not bf16:
            c_new = fc + ig
        else:
            c_new = r(r(fc) + (ig if fault == "ig_unrounded" else r(ig)))
        h_new = sig(o) * tanh(c_new)
        return (r(h_new) if bf16 and fault != "h_unrounded" else h_new), c_new

    if fault == "next_token_row":
        tokens = tokens.roll(-1, dims=1)
    last_out = tb.bilstm_last_out(tp, tokens, None, semantics="dense",
                                  bwd_init=None, cell=cell)
    return lstm_cuda.head_default(tp, last_out).numpy()


@pytest.fixture(scope="module")
def fault_reads(params):
    """Reads for the planted faults (T = 100, as the gate is stated), with
    each fast mode's plain and yardstick logits; the fault-free copy of the
    plain version is checked against the real one bit for bit."""
    _, tp = params
    tok = torch.from_numpy(_random_token_reads(np.random.default_rng(29), 512, 100))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = {}
        for mode, dt in (("fast", torch.float32), ("fast_bf16", torch.bfloat16)):
            plain = lstm_cuda.bilstm_logits_fast_plain(tp, tok, state_dtype=dt).numpy()
            np.testing.assert_array_equal(_faulty_fast_plain(tp, tok, mode, None), plain)
            ref[mode] = (plain, lstm_cuda.bilstm_logits_fast_plain(
                tp, tok, state_dtype=dt, k_block=16).numpy())
    finally:
        torch.set_num_threads(n)
    return tok, ref


@pytest.mark.parametrize("mode,fault", [
    ("fast", "token_row_unrounded"), ("fast", "h_unrounded_in_product"),
    ("fast", "next_token_row"), ("fast", "i_f_swapped"),
    ("fast_bf16", "token_row_unrounded"), ("fast_bf16", "gates_unrounded"),
    ("fast_bf16", "ig_unrounded"), ("fast_bf16", "h_unrounded"),
    ("fast_bf16", "next_token_row"), ("fast_bf16", "i_f_swapped"),
])
def test_fast_gate_rejects_a_planted_fault(params, fault_reads, mode, fault,
                                           one_thread):
    """TC_GATE's power: the plain version with one op wrong falls outside
    the gate around the plain version as it is. A single bf16 rounding left
    out, or fp32 h fed to the product, shows in the mean-abs."""
    _, tp = params
    tok, ref = fault_reads
    plain, yard = ref[mode]
    r = lstm_cuda.tc_gate(mode, _faulty_fast_plain(tp, tok, mode, fault), plain, yard)
    assert not r["within_gate"], r
    assert r["mean_abs"] > lstm_cuda.TC_GATE[mode]["mean_abs"], r


def test_high_gate_holds_a_summation_order(params, one_thread):
    """TC_GATE["high"] against what a change of summation order alone does:
    the plain high version with its three products summed in 16-wide k
    blocks (the kernel's mma k-step, its yardstick) stays inside the gate
    around the plain version as it is (npz weights, T = 100). Measured on
    these reads: mean-abs ~8e-6, max-abs ~6e-5 -- the limb split's chaos
    floor, which an order change cannot go under."""
    _, tp = params
    tok = torch.from_numpy(_random_token_reads(np.random.default_rng(31), 2048, 100))
    plain = lstm_cuda.bilstm_logits_high_plain(tp, tok).numpy()
    blocked = lstm_cuda.bilstm_logits_high_plain(tp, tok, k_block=16).numpy()
    r = lstm_cuda.tc_gate("high", blocked, plain, blocked)
    assert r["max_abs"] > 0 and r["within_gate"], r


def _faulty_high_plain(tp, tokens, fault, k_block=16):
    """bilstm_logits_high_plain with one planted fault (None: none), summed
    in 16-wide k blocks as a kernel sums: a limb product dropped, hlo left
    unrounded, the exp form of the sigmoid, a bf16-rounded token row, the
    token row of the next step, or two gates swapped."""
    limbs = [lstm_cuda.split_bf16(w) for w in (tp.w_hh_f, tp.w_hh_b)]

    def sig(x):
        if fault == "exp_sigmoid":
            return torch.sigmoid(x)
        return 0.5 * torch.tanh(0.5 * x) + 0.5

    def cell(h, c, gates_x, d):
        hhi, hlo = lstm_cuda.split_bf16(h)
        if fault == "hlo_unrounded":
            hlo = h - hhi
        if fault == "whi_hlo_dropped":
            hlo = torch.zeros_like(hlo)
        whi, wlo = limbs[d]
        if fault == "wlo_hhi_dropped":
            wlo = torch.zeros_like(wlo)
        if fault == "token_row_bf16":
            gates_x = lstm_cuda.bf16_round(gates_x)
        gates = lstm_cuda.high_product(hhi, hlo, whi, wlo, k_block) + gates_x
        i, f, g, o = gates.chunk(4, dim=-1)
        if fault == "i_f_swapped":
            i, f = f, i
        c_new = sig(f) * c + sig(i) * torch.tanh(g)
        return sig(o) * torch.tanh(c_new), c_new

    if fault == "next_token_row":
        tokens = tokens.roll(-1, dims=1)
    last_out = tb.bilstm_last_out(tp, tokens, None, semantics="dense",
                                  bwd_init=None, cell=cell)
    return tb.head(tp, last_out).numpy()


@pytest.fixture(scope="module")
def high_fault_reads(params):
    """Reads for the planted high faults (T = 100), the plain high logits
    and the yardstick's on the npz weights, and the plain logits with
    W_hh = 0; the fault-free copy of the plain version is checked against
    the real one bit for bit (at k_block 1 and 16)."""
    _, tp = params
    tok = torch.from_numpy(_random_token_reads(np.random.default_rng(37), 512, 100))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain = lstm_cuda.bilstm_logits_high_plain(tp, tok).numpy()
        yard = lstm_cuda.bilstm_logits_high_plain(tp, tok, k_block=16).numpy()
        np.testing.assert_array_equal(_faulty_high_plain(tp, tok, None, 1), plain)
        np.testing.assert_array_equal(_faulty_high_plain(tp, tok, None), yard)
        plain0 = lstm_cuda.bilstm_logits_high_plain(
            lstm_cuda.zero_product_params(tp), tok).numpy()
    finally:
        torch.set_num_threads(n)
    return tok, plain, yard, plain0


# planted high faults -> (TC_GATE["high"] sees it on the npz weights at
# T = 100, bit identity with W_hh = 0 sees it). A fault that moves each step
# by about an ulp, as a change of summation order does, lies under the limb
# split's chaos floor (exp_sigmoid: mean-abs ~8e-6 against the order's
# ~8e-6), and one in the product vanishes with W_hh = 0
HIGH_FAULTS = {
    "wlo_hhi_dropped": (True, False), "whi_hlo_dropped": (True, False),
    "exp_sigmoid": (False, True), "token_row_bf16": (True, True),
    "next_token_row": (True, True), "i_f_swapped": (True, True),
}


def _high_checks(tp, high_fault_reads, fault):
    """(the tolerance's readings, bit identity with W_hh = 0) of the plain
    high version with `fault` planted, summed in 16-wide k blocks as a
    kernel sums."""
    tok, plain, yard, plain0 = high_fault_reads
    r = lstm_cuda.tc_gate("high", _faulty_high_plain(tp, tok, fault), plain, yard)
    zero = _faulty_high_plain(lstm_cuda.zero_product_params(tp), tok, fault)
    return r, np.array_equal(zero, plain0)


@pytest.mark.parametrize("fault", list(HIGH_FAULTS))
def test_high_gate_rejects_a_planted_fault(params, high_fault_reads, fault,
                                           one_thread):
    """The high kernel's two checks against a plain version with one op
    wrong: each fault falls outside TC_GATE["high"] (by its mean-abs: a
    dropped limb product or a bf16 token row reads 4.6e-3 to 7.7e-3 against
    the gate's 5e-5) or breaks bit identity with W_hh = 0, which a right
    kernel keeps; the table HIGH_FAULTS says which, and the test holds both
    to it."""
    _, tp = params
    r, same0 = _high_checks(tp, high_fault_reads, fault)
    tolerance_sees, zero_sees = HIGH_FAULTS[fault]
    assert r["within_gate"] is not tolerance_sees, r
    if tolerance_sees:
        assert r["mean_abs"] > lstm_cuda.TC_GATE["high"]["mean_abs"], r
    assert same0 is not zero_sees


def test_high_gate_cannot_see_hlo_rounding(params, high_fault_reads, one_thread):
    """hlo left unrounded (fp32 h - hhi in the product) moves the low limb
    by less than 2^-17 of h: on the npz weights it reads like a change of
    summation order (mean-abs ~6e-6) and lies inside TC_GATE["high"], and
    with W_hh = 0 the product it feeds is gone. Neither check sees it; a
    tensor-core kernel cannot make this fault as such, since the mma takes
    hlo as a bf16 operand (only its rounding could differ)."""
    _, tp = params
    r, same0 = _high_checks(tp, high_fault_reads, "hlo_unrounded")
    assert r["within_gate"] and r["mean_abs"] <= 2 * r["yardstick"]["mean_abs"], r
    assert same0


@pytest.mark.parametrize("mode", ["high", "fast", "fast_bf16"])
def test_zero_product_weights_make_the_order_irrelevant(params, mode, one_thread):
    """With W_hh = 0 the plain version summed in 16-wide k blocks equals
    the one summed k ascending, bit for bit (on the npz weights they
    differ): the product is exactly zero in any order, so the tensor-core
    kernels must match their plain versions bit for bit there."""
    _, tp = params
    tok = torch.from_numpy(_random_token_reads(np.random.default_rng(41), 256, 100))
    p0 = lstm_cuda.zero_product_params(tp)
    np.testing.assert_array_equal(lstm_cuda.YARDSTICK[mode](p0, tok).numpy(),
                                  lstm_cuda.PLAIN[mode](p0, tok).numpy())
    assert not np.array_equal(lstm_cuda.YARDSTICK[mode](tp, tok).numpy(),
                              lstm_cuda.PLAIN[mode](tp, tok).numpy())


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


def test_probe_marker_keys_on_the_kernel_source(ref_params_path, tmp_path,
                                               monkeypatch):
    """The startup probe's pass marker changes with the kernel library's
    build key: an edited kernel source runs the probe again."""
    import shutil

    from ribodetector_tpu_torch.ops import build
    from ribodetector_tpu_torch.runtime.pipeline import Predictor

    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "a card")
    monkeypatch.setenv("RIBODETECTOR_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    pred = Predictor.__new__(Predictor)
    pred.state_file, pred.len, pred.semantics = ref_params_path, 100, "dense"
    pred.device = torch.device("cpu")
    before = pred._probe_marker()
    assert before == pred._probe_marker()
    src = tmp_path / "bilstm.cu"
    shutil.copy(build.KERNEL_SRC, src)
    monkeypatch.setattr(build, "KERNEL_SRC", str(src))
    assert pred._probe_marker() == before  # same bytes, same key
    with open(src, "a") as fh:
        fh.write("// edited\n")
    after = pred._probe_marker()
    assert after != before
    assert os.path.dirname(after) == os.path.dirname(before) == str(tmp_path / "cache")


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
    init = None
    if k:
        dt = torch.bfloat16 if mode == "fast_bf16" else torch.float32
        init = tb.zero_prefix_state(cuda_params, k, compute_dtype=dt)
    plain = lstm_cuda.PLAIN[mode]
    lstm_cuda.reset_launches()
    got = lstm_cuda.bilstm_logits_cuda(cuda_params, tok, lens, semantics=semantics,
                                       mode=mode, bwd_init=init)
    torch.cuda.synchronize()
    assert lstm_cuda.LAUNCHES[mode] == 1
    ref = plain(cuda_params, tok, lens, semantics=semantics, bwd_init=init)
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    if mode not in lstm_cuda.TC_GATE:
        _assert_close(got, ref)
        return
    # the tensor cores sum in their own order: the stated gate, beside the
    # yardstick on the same reads
    yard = lstm_cuda.YARDSTICK[mode](cuda_params, tok, lens, semantics=semantics,
                                     bwd_init=init)
    assert np.isfinite(got).all()
    r = lstm_cuda.tc_gate(mode, got, ref, yard.cpu().numpy())
    assert r["within_gate"], r
    # and bit for bit where no order can change the product
    p0 = lstm_cuda.zero_product_params(cuda_params)
    assert torch.equal(
        lstm_cuda.bilstm_logits_cuda(p0, tok, lens, semantics=semantics,
                                     mode=mode, bwd_init=init),
        plain(p0, tok, lens, semantics=semantics, bwd_init=init))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["high", "fast", "fast_bf16"])
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


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_params):
    tok = torch.zeros((8, 10), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="uint8"):
        lstm_cuda.bilstm_logits_cuda(cuda_params, tok)
    tok8 = torch.zeros((10, 8), dtype=torch.uint8, device="cuda").T
    with pytest.raises(ValueError, match="contiguous"):
        lstm_cuda.bilstm_logits_cuda(cuda_params, tok8)
