"""The port's training path against the JAX package's, on the same inputs.

Losses, metrics, gradients, the optimizer and a short fit run through both
packages from numpy-seeded data and from the same npz (the two random
inits differ, so every comparison of training starts from one file).
Tolerances, from the measured gaps:

- losses 1e-6 (1e-5 for the T=100 loss of the gradient test); the
  confusion counts, recall, precision, F1 and MCC exactly (integer counts
  and the same float32 operations), accuracy to one float32 ulp;
- gradients at T=100, 64 reads: max-abs <= 1e-5 * max(1, max|g_jax|) per
  leaf (the worst measured is 4.5e-6 relative);
- 3 optimizer steps on the same gradients: max-abs <= 2e-6 (read: 0; after
  50 steps the params, moments and count are optax's bit for bit);
- fit: per-epoch train loss to 1e-4 relative; parameters to max-abs <= lr,
  because Adam's first steps move each weight by about lr * sign(g), and a
  gradient near zero whose sign differs by rounding moves it one lr step.

Then the twins of tests/test_train.py (the planted motif, fit's checkpoints,
the CLI, a custom width) and a port-trained best.npz through both detect
CLIs, byte for byte.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ribodetector_tpu.models import bilstm as jb
from ribodetector_tpu.train import loss as jloss
from ribodetector_tpu.train import metrics as jmetrics
from ribodetector_tpu.train import trainer as jt
from ribodetector_tpu_torch.models import bilstm as tb
from ribodetector_tpu_torch.train import loss as tloss
from ribodetector_tpu_torch.train import metrics as tmetrics
from ribodetector_tpu_torch.train import trainer as tt
from ribodetector_tpu_torch.train.__main__ import main as train_main
from ribodetector_tpu_torch.train.__main__ import main_cpu as train_main_cpu
from ribodetector_tpu_torch.train.optim import Adam, leaf_views

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one intra-op thread for the module's tests and fixtures:
    the plain recurrence is thousands of small ops, whose per-op thread
    barriers stall when the test workers oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MOTIF = "GGAACCTTGGAACC"
BASES = np.array(list("ACGT"))


def leaf_params(path):
    """The port's params from an npz, as autograd leaves."""
    return tb.BiLSTMParams(*(p.requires_grad_(True) for p in tb.load_params(path)))


# ---------------------------------------------------------------- loss, metrics


def test_cross_entropy_matches_hand():
    logits = torch.tensor([[2.0, 0.0], [0.0, 3.0]])
    labels = torch.tensor([0, 0])
    p0 = np.exp(2) / (np.exp(2) + 1)
    p1 = 1 / (1 + np.exp(3))
    want = -(np.log(p0) + np.log(p1)) / 2
    assert abs(float(tloss.cross_entropy_loss(logits, labels)) - want) < 1e-6


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_losses_match_jax(seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 3, (257, 2)).astype(np.float32)
    labels = rng.integers(0, 2, 257).astype(np.int32)
    logp = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    for jf, tf, x in ((jloss.cross_entropy_loss, tloss.cross_entropy_loss, logits),
                      (jloss.nll_loss, tloss.nll_loss, logp)):
        want = float(jf(jnp.asarray(x), jnp.asarray(labels)))
        got = float(tf(torch.from_numpy(x), torch.from_numpy(labels)))
        assert abs(got - want) <= 1e-6


def test_metrics_hand_computed():
    pred = torch.tensor([1, 1, 1, 1, 0, 0, 0, 0, 0, 0])
    true = torch.tensor([1, 1, 1, 0, 0, 0, 0, 0, 1, 1])
    tp, fp, tn, fn = map(int, tmetrics.confusion_counts(pred, true))
    assert (tp, fp, tn, fn) == (3, 1, 4, 2)
    assert abs(float(tmetrics.accuracy(pred, true)) - 0.7) < 1e-6
    assert abs(float(tmetrics.recall(pred, true)) - 3 / 5) < 1e-6
    assert abs(float(tmetrics.precision(pred, true)) - 3 / 4) < 1e-6
    p, r = 3 / 4, 3 / 5
    assert abs(float(tmetrics.f1(pred, true)) - 2 * p * r / (p + r)) < 1e-6
    want_mcc = (3 * 4 - 1 * 2) / np.sqrt((3 + 1) * (3 + 2) * (4 + 1) * (4 + 2))
    assert abs(float(tmetrics.mcc(pred, true)) - want_mcc) < 1e-5


@pytest.mark.parametrize("case", ["random", "all_negative", "all_right"])
def test_metrics_match_jax_exactly(case):
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 2, 1001).astype(np.int32)
    pred = {"random": rng.integers(0, 2, 1001).astype(np.int32),
            "all_negative": np.zeros(1001, np.int32),
            "all_right": labels.copy()}[case]
    for name in ("recall", "precision", "f1", "mcc"):
        want = np.float32(getattr(jmetrics, name)(jnp.asarray(pred), jnp.asarray(labels)))
        got = getattr(tmetrics, name)(torch.from_numpy(pred), torch.from_numpy(labels))
        assert np.float32(got.item()) == want, name
    # accuracy is the correctly rounded count ratio; XLA's mean multiplies
    # the count by 1/n, which can land one float32 ulp away
    got = np.float32(tmetrics.accuracy(torch.from_numpy(pred), torch.from_numpy(labels)).item())
    assert got == np.float32((pred == labels).sum()) / np.float32(len(pred))
    want = np.float32(jmetrics.accuracy(jnp.asarray(pred), jnp.asarray(labels)))
    assert abs(got - want) <= np.spacing(want)
    want = [int(x) for x in jmetrics.confusion_counts(jnp.asarray(pred), jnp.asarray(labels))]
    got = [int(x) for x in tmetrics.confusion_counts(torch.from_numpy(pred),
                                                     torch.from_numpy(labels))]
    assert got == want


# ---------------------------------------------------------------- data


def test_synthetic_dataset_matches_jax():
    for n, max_len in ((300, 100), (50, 40), (20, 8)):
        got = tt.synthetic_dataset(np.random.default_rng(n), n, max_len=max_len)
        want = jt.synthetic_dataset(np.random.default_rng(n), n, max_len=max_len)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------- gradients


@pytest.fixture(scope="module")
def batch100():
    return tt.synthetic_dataset(np.random.default_rng(0), 64, max_len=100)


@pytest.mark.parametrize("semantics", ["dense", "packed"])
def test_gradients_match_jax(ref_params_path, batch100, semantics):
    tok, ln, lab = batch100
    (jl, _), jg = jax.value_and_grad(jt._loss_fn, has_aux=True)(
        jb.load_params(ref_params_path), jnp.asarray(tok), jnp.asarray(ln),
        jnp.asarray(lab), semantics, jnp.float32)
    params = leaf_params(ref_params_path)
    loss, _ = tt._loss_fn(params, torch.from_numpy(tok), torch.from_numpy(ln),
                          torch.from_numpy(lab), semantics, torch.float32)
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5
    for name in tb.BiLSTMParams._fields:
        want = np.asarray(getattr(jg, name))
        got = getattr(params, name).grad.numpy()
        assert got.shape == want.shape
        gap = np.abs(got - want).max()
        assert gap <= 1e-5 * max(1.0, np.abs(want).max()), (name, gap)
    if semantics == "packed":
        # the backward direction starts from the zero state at L-1: its
        # recurrent product never sees a nonzero h before the capture
        assert not params.w_hh_b.grad.any()


# ---------------------------------------------------------------- optimizer


def _optax_and_port(weight_decay, make_optimizer, steps, lr):
    """optax and make_optimizer's update after `steps` updates fed the same
    gradients, from standard-normal parameters -> (optax's params and
    state, the port's params and optimizer)."""
    rng = np.random.default_rng(11)
    shapes = [(4, 64), (16, 64), (64,), (32, 2), (2,)]
    start = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(steps)]
    opt = (optax.adamw(lr, weight_decay=weight_decay) if weight_decay
           else optax.adam(lr))
    jp = [jnp.asarray(p) for p in start]
    state = opt.init(jp)
    for g in grads:
        updates, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
    tp = [torch.from_numpy(p.copy()).requires_grad_(True) for p in start]
    topt = make_optimizer(tt.TrainConfig(learning_rate=lr, weight_decay=weight_decay), tp)
    for g in grads:
        topt.update(torch.cat([torch.from_numpy(x).reshape(-1) for x in g]))
    return (jp, state), (tp, topt)


def _optimizer_gap(weight_decay, make_optimizer, steps=3, lr=1e-3):
    """max-abs between optax and make_optimizer after `steps` updates."""
    (jp, _), (tp, _) = _optax_and_port(weight_decay, make_optimizer, steps, lr)
    return max(float(np.abs(np.asarray(j) - t.detach().numpy()).max())
               for j, t in zip(jp, tp))


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_optimizer_matches_optax(weight_decay):
    assert _optimizer_gap(weight_decay, tt.make_optimizer) <= 2e-6


@pytest.mark.parametrize("weight_decay,lr", [(0.0, 1e-3), (0.0, 5e-3), (1e-2, 1e-3),
                                             (1e-2, 5e-3)])
def test_optimizer_is_optax_bit_for_bit(weight_decay, lr):
    """The port's update (optim.Adam, the one the card captures) runs
    optax's ops in optax's order, on device state: after 50 updates the
    params, both moments and the step count are optax's bit for bit."""
    (jp, state), (tp, topt) = _optax_and_port(weight_decay, tt.make_optimizer, 50, lr)
    adam = state[0]  # ScaleByAdamState, first in adamw's chain too
    assert topt.steps() == int(adam.count) == 50
    for j, t, mu, nu, tmu, tnu in zip(jp, tp, adam.mu, adam.nu, leaf_views(topt.mu, tp),
                                      leaf_views(topt.nu, tp)):
        np.testing.assert_array_equal(t.detach().numpy(), np.asarray(j))
        np.testing.assert_array_equal(tmu.numpy(), np.asarray(mu))
        np.testing.assert_array_equal(tnu.numpy(), np.asarray(nu))


def test_optimizer_check_catches_torch_default_decay():
    """A planted fault: AdamW with torch's default decay (1e-2) where the
    config asks for none must fail the comparison above."""

    def faulty(cfg, params):
        return Adam(params, cfg.learning_rate, weight_decay=1e-2)

    assert _optimizer_gap(0.0, faulty) > 2e-6


# ---------------------------------------------------------------- fit


def _epoch_losses(ckdir, epochs):
    return [tb.load_params_meta(str(ckdir / f"epoch{e:03d}.npz"))["metrics"]["train_loss"]
            for e in range(epochs)]


@pytest.mark.parametrize("start,max_len", [("shipped", 40), ("random", 100)])
def test_fit_matches_jax(tmp_path, ref_params_path, start, max_len):
    """From the shipped weights at T=40, and from the port's random init
    (seed 0, the training CLI's) at T=100, where the motif task's loss
    stays near ln 2 for many steps: the trainers step alike in both."""
    lr, epochs = 5e-3, 3
    init = ref_params_path
    if start == "random":
        init = str(tmp_path / "init.npz")
        tb.save_params(init, tb.init_params(torch.Generator().manual_seed(0)), {})
    data = tt.synthetic_dataset(np.random.default_rng(3), 256, max_len=max_len)
    jp = jt.fit(jb.load_params(init), data,
                jt.TrainConfig(learning_rate=lr), epochs=epochs, batch_size=32,
                log_fn=lambda m: None, checkpoint_dir=str(tmp_path / "jax"))
    tp = tt.fit(tb.load_params(init), data,
                tt.TrainConfig(learning_rate=lr), epochs=epochs, batch_size=32,
                log_fn=lambda m: None, checkpoint_dir=str(tmp_path / "torch"))
    want = _epoch_losses(tmp_path / "jax", epochs)
    got = _epoch_losses(tmp_path / "torch", epochs)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    assert got[-1] < got[0]
    assert isinstance(tp, tb.BiLSTMParams)
    for name in tb.BiLSTMParams._fields:
        gap = np.abs(getattr(tp, name).numpy() - np.asarray(getattr(jp, name))).max()
        assert gap <= lr, (name, gap)


def test_trainer_learns_planted_motif():
    rng = np.random.default_rng(7)
    data = tt.synthetic_dataset(rng, 512, max_len=32)
    cfg = tt.TrainConfig(learning_rate=5e-3, semantics="dense")
    logs = []
    params = tt.fit(tb.init_params(torch.Generator().manual_seed(0)), data, cfg,
                    epochs=8, batch_size=64, eval_data=data, log_fn=logs.append)
    metrics = tt.evaluate(tt.make_eval_step(cfg), params, data, batch_size=100)
    assert float(metrics["acc"]) > 0.8, logs


def test_evaluate_batches_do_not_change_the_result(ref_params_path):
    """The tail batch runs at its own size (no padding): the metrics over
    any batch size equal those of one whole-set batch."""
    data = tt.synthetic_dataset(np.random.default_rng(8), 203, max_len=30)
    params = tb.load_params(ref_params_path)
    step = tt.make_eval_step(tt.TrainConfig())
    whole = tt.evaluate(step, params, data, batch_size=4096)
    for bs in (1, 64, 100):
        got = tt.evaluate(step, params, data, batch_size=bs)
        assert {k: v for k, v in got.items() if k != "loss"} == \
            {k: v for k, v in whole.items() if k != "loss"}
        assert got["loss"] == pytest.approx(whole["loss"], rel=1e-6)
    want = jt.evaluate(jt.make_eval_step(jt.TrainConfig()), jb.load_params(ref_params_path),
                       data, batch_size=64)
    assert {k: v for k, v in whole.items() if k != "loss"} == \
        {k: v for k, v in want.items() if k != "loss"}
    assert whole["loss"] == pytest.approx(want["loss"], rel=1e-5)
    with pytest.raises(ValueError, match="non-empty eval set"):
        tt.evaluate(step, params, tuple(x[:0] for x in data))


def test_checkpoint_metrics_recorded():
    # the port's copy of the shipped artifact keeps the reference
    # checkpoint's val metrics
    from ribodetector_tpu_torch.runtime.pipeline import PACKAGE_DIR

    meta = tb.load_params_meta(f"{PACKAGE_DIR}/data/ribodetector_v1.npz")
    assert meta["metrics"]["val_acc"] == pytest.approx(0.99300, abs=1e-4)
    assert meta["epoch"] == 47


def test_fit_checkpoints_and_best(tmp_path):
    data = tt.synthetic_dataset(np.random.default_rng(288), 192, max_len=40)
    params = tb.init_params(torch.Generator().manual_seed(0))
    ckdir = tmp_path / "ck"
    tt.fit(params, data, tt.TrainConfig(learning_rate=1e-2), epochs=2,
           batch_size=64, eval_data=data, log_fn=lambda m: None,
           checkpoint_dir=str(ckdir))
    files = sorted(f.name for f in ckdir.iterdir())
    assert files == ["best.npz", "epoch000.npz", "epoch001.npz"]
    meta = tb.load_params_meta(str(ckdir / "epoch001.npz"))
    assert meta["epoch"] == 1 and "mcc" in meta["metrics"]
    assert meta["arch"] == "BiLSTM 4x128x2 bidirectional" and meta["batch_size"] == 64
    tb.load_params(str(ckdir / "best.npz"))  # loads back into the engine
    jb.load_params(str(ckdir / "best.npz"))  # and into the JAX package's


def test_fit_contract_errors():
    data = tt.synthetic_dataset(np.random.default_rng(1), 16, max_len=20)
    params = tb.init_params(torch.Generator().manual_seed(0), hidden=8)
    with pytest.raises(ValueError, match="batch_size must be >= 1"):
        tt.fit(params, data, batch_size=0)
    with pytest.raises(ValueError, match="monitor='bogus'"):
        tt.fit(params, data, monitor="bogus")
    with pytest.raises(ValueError, match="empty dataset"):
        tt.fit(params, tuple(x[:0] for x in data))
    logs = []
    tt.fit(params, data, batch_size=64, log_fn=logs.append)
    assert logs[0] == "batch_size 64 > dataset size 16; using 16"


# ---------------------------------------------------------------- the CLI


def mkfile(rng, path, n, with_motif, lmin=20, lmax=32):
    with open(path, "w") as fh:
        for i in range(n):
            L = int(rng.integers(lmin, lmax + 1))
            s = "".join(rng.choice(BASES, size=L))
            if with_motif:
                pos = int(rng.integers(0, L - len(MOTIF)))
                s = s[:pos] + MOTIF + s[pos + len(MOTIF):]
            fh.write(f">s{i}\n{s}\n")


def heldout(rng, n, max_len=32):
    seqs, labels = [], []
    for i in range(n):
        L = int(rng.integers(20, 33))
        s = "".join(rng.choice(BASES, size=L))
        y = i % 2
        if y:
            pos = int(rng.integers(0, L - len(MOTIF)))
            s = s[:pos] + MOTIF + s[pos + len(MOTIF):]
        seqs.append(s)
        labels.append(y)
    return seqs, np.asarray(labels)


def held_out_accuracy(path, rng):
    from ribodetector_tpu_torch.encode import encode_batch

    params = tb.load_params(path)
    seqs, labels = heldout(rng, 100)
    tokens, _ = encode_batch(seqs, 32)
    with torch.no_grad():
        pred = tb.bilstm_logits(params, torch.from_numpy(tokens)).argmax(1).numpy()
    return params, (pred == labels).mean()


def test_train_cli_end_to_end(tmp_path, capsys):
    rng = np.random.default_rng(5)
    for name, n, motif in (("rrna", 300, True), ("norrna", 300, False),
                           ("val_rrna", 60, True), ("val_norrna", 60, False)):
        mkfile(rng, tmp_path / f"{name}.fa", n, motif)
    out = tmp_path / "ckpt"
    train_main_cpu([
        "--rrna", str(tmp_path / "rrna.fa"),
        "--norrna", str(tmp_path / "norrna.fa"),
        "--val-rrna", str(tmp_path / "val_rrna.fa"),
        "--val-norrna", str(tmp_path / "val_norrna.fa"),
        "-l", "32", "--epochs", "8", "--batch", "64", "--lr", "1e-2",
        "--out", str(out),
    ])
    printed = capsys.readouterr().out
    assert "loaded 600 training reads (300 rRNA / 300 non-rRNA)" in printed
    assert "loaded 120 validation reads" in printed
    assert "best.npz tracks eval mcc" in printed
    assert sorted(f.name for f in out.iterdir()) == \
        ["best.npz"] + [f"epoch{e:03d}.npz" for e in range(8)]
    _, acc = held_out_accuracy(str(out / "best.npz"), rng)
    assert acc > 0.8


def test_train_cli_custom_hidden_width(tmp_path):
    rng = np.random.default_rng(11)
    mkfile(rng, tmp_path / "rrna.fa", 300, True)
    mkfile(rng, tmp_path / "norrna.fa", 300, False)
    out = tmp_path / "ckpt32"
    train_main_cpu([
        "--rrna", str(tmp_path / "rrna.fa"),
        "--norrna", str(tmp_path / "norrna.fa"),
        "-l", "32", "--epochs", "8", "--batch", "64", "--lr", "1e-2",
        "--hidden", "32", "--out", str(out),
    ])
    params, acc = held_out_accuracy(str(out / "best.npz"), rng)
    assert params.w_hh_f.shape == (32, 128)  # genuinely hidden=32
    assert acc > 0.8
    assert tb.load_params_meta(str(out / "best.npz"))["arch"] == \
        "BiLSTM 4x32x2 bidirectional"


def test_train_cli_refusals(tmp_path, capsys):
    rng = np.random.default_rng(2)
    mkfile(rng, tmp_path / "r.fa", 4, True)
    base = ["--rrna", str(tmp_path / "r.fa"), "--norrna", str(tmp_path / "r.fa"),
            "-l", "32", "--out", str(tmp_path / "ck")]
    # --tp on one device is accepted and has no effect, as in the JAX CLI
    # (which builds no mesh there): no mesh, no batch rounding
    one = str(tmp_path / "one_device")
    train_main_cpu([*base[:-1], one, "--tp", "2", "--epochs", "1", "--batch", "3"])
    printed = capsys.readouterr().out
    assert "mesh" not in printed and "rounded" not in printed
    assert tb.load_params_meta(f"{one}/best.npz")["batch_size"] == 3
    with pytest.raises(SystemExit):
        train_main_cpu([*base, "--monitor", "bogus"])
    with pytest.raises(SystemExit):
        train_main_cpu([*base, "--val-rrna", str(tmp_path / "r.fa")])
    with pytest.raises(SystemExit):
        train_main_cpu([*base, "--init", str(tmp_path / "x.npz"), "--hidden", "8"])
    assert not (tmp_path / "ck").exists()


def test_train_main_needs_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: main trains on it")
    rng = np.random.default_rng(2)
    mkfile(rng, tmp_path / "r.fa", 4, True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--rrna", str(tmp_path / "r.fa"), "--norrna",
                    str(tmp_path / "r.fa"), "-l", "32", "--out", str(tmp_path / "ck")])
    assert not (tmp_path / "ck").exists()


# ------------------------------------------ a port-trained best.npz in detect


@pytest.fixture(scope="module", params=[128, 32], ids=["hidden128", "hidden32"])
def trained(request, tmp_path_factory):
    """best.npz of a short port fit on the planted motif at this width."""
    hidden = request.param
    data = tt.synthetic_dataset(np.random.default_rng(21), 256, max_len=50)
    ckdir = tmp_path_factory.mktemp(f"ck{hidden}")
    tt.fit(tb.init_params(torch.Generator().manual_seed(1), hidden=hidden), data,
           tt.TrainConfig(learning_rate=1e-2), epochs=2, batch_size=64,
           eval_data=data, log_fn=lambda m: None, checkpoint_dir=str(ckdir))
    return str(ckdir / "best.npz"), hidden


def test_trained_checkpoint_runs_in_both_detect_clis(tmp_path, trained):
    """The same FASTQ through the port's main_cpu and the JAX CLI (--kernel
    scan), each with best.npz as its state_file: byte-identical outputs."""
    from ribodetector_tpu.encode import encode_batch as jencode
    from tests.conftest import random_reads
    from tests.test_torch_cli import (
        COMMON,
        LEN,
        assert_identical,
        run_both,
        runtime_configs,
        write_fastq,
    )

    path, hidden = trained
    rng = np.random.default_rng(hidden)
    seqs = random_reads(rng, 60, lmin=20, lmax=70)
    seqs[::3] = [s[:10] + MOTIF + s[10:] for s in seqs[::3]]
    tok, _ = jencode(seqs, LEN)
    logits = np.asarray(jb.bilstm_logits(jb.load_params(path), jnp.asarray(tok)))
    # byte identity is well defined only away from the decision boundary
    assert np.abs(logits[:, 1] - logits[:, 0]).min() >= 1e-4
    assert 0 < (logits.argmax(1) == 1).sum() < len(seqs)
    inp = tmp_path / "in.fq"
    write_fastq(inp, [f"r{i}" for i in range(len(seqs))], seqs)
    configs = runtime_configs(tmp_path)
    for flags in configs:
        cfg_path = flags[1]
        with open(cfg_path) as fh:
            cfg = json.load(fh)
        cfg["state_file"] = {"mcc": path, "recall": path}
        with open(cfg_path, "w") as fh:
            json.dump(cfg, fh)
    jfiles, tfiles = run_both(tmp_path, [str(inp)], common=COMMON, configs=configs)
    assert_identical(jfiles, tfiles)
