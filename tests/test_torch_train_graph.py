"""The port's graph-ready train step against its eager step.

On the card at tp = 1 the train step captures its forward and backward
once per input shape as a CUDA graph and replays it every step
(train/trainer.py, TrainStep). Capture needs a card, so here on the CPU
the step's graph-ready body runs in place of the replay
(make_train_step(graph=True)): the static input buffers that each batch
is gathered into, the flat gradient buffer bound as the leaves' .grad,
the in-place dp average and the copies of the static loss. It is held
against the eager step (graph=False, what CPU training runs, and the
reference of tests/test_torch_train.py), bit for bit, since the
arithmetic is the same: the per-step losses, the parameters after fit,
Adam's step count (epochs x whole batches: no update added by a capture,
none dropped) and the losses that fit logs (the per-step ones, not one
static tensor repeated). Torch runs on one intra-op thread: two CPU runs
of the same step agree bit for bit only then. tests/test_torch_card_train.py
holds the captured graph against the eager step on the card.
"""

import json

import numpy as np
import pytest
import torch

from ribodetector_tpu_torch.models import bilstm as tb
from ribodetector_tpu_torch.parallel.mesh import Grid, make_dp_tp_mesh
from ribodetector_tpu_torch.train import trainer as tt
from tests.test_torch_train_dist import _finish, _start

LR, BATCH, N, LEN = 5e-3, 32, 128, 24


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Recording:
    """A train step that keeps every loss it returns (the tensors fit
    stacks) and the optimizer it updates."""

    def __init__(self, step, optimizer):
        self.step, self.optimizer, self.losses = step, optimizer, []

    def __call__(self, *args):
        loss = self.step(*args)
        self.losses.append(loss)
        return loss

    def release(self):
        self.step.release()


def fit_with(monkeypatch, graph, *args, **kw):
    """tt.fit with make_train_step(graph=graph) -> (params, Recording,
    step counts of the run)."""
    make, made = tt.make_train_step, []

    def spy(cfg, optimizer, grid=None):
        made.append(Recording(make(cfg, optimizer, grid, graph=graph), optimizer))
        return made[-1]

    monkeypatch.setattr(tt, "make_train_step", spy)
    tt.reset_step_counts()
    params = tt.fit(*args, log_fn=lambda m: None, **kw)
    monkeypatch.setattr(tt, "make_train_step", make)
    return params, made[0], tt.step_counts()


def _data(n=N, max_len=LEN, seed=5):
    return tt.synthetic_dataset(np.random.default_rng(seed), n, max_len=max_len)


def _assert_same_params(a, b):
    for name, x, y in zip(tb.BiLSTMParams._fields, a, b):
        assert torch.equal(x, y), name


CASES = {  # name: (init, TrainConfig, batch, epochs, data)
    "dense": ("shipped", tt.TrainConfig(learning_rate=LR), BATCH, 2, _data()),
    "packed": ("shipped", tt.TrainConfig(learning_rate=LR, semantics="packed"), BATCH, 2,
               _data()),
    "bfloat16": ("shipped", tt.TrainConfig(learning_rate=LR, compute_dtype="bfloat16"), BATCH,
                 1, _data()),
    "adamw": ("shipped", tt.TrainConfig(learning_rate=LR, weight_decay=1e-2), BATCH, 1,
              _data()),
    "hidden64_random_init": (64, tt.TrainConfig(learning_rate=LR), BATCH, 2, _data()),
    "batch_shrunk_to_set": ("shipped", tt.TrainConfig(learning_rate=LR), 4 * N, 3,
                            _data(n=40)),
}


@pytest.mark.parametrize("case", CASES)
def test_fit_graph_ready_matches_eager(monkeypatch, tmp_path, ref_params_path, case):
    start, cfg, batch, epochs, data = CASES[case]
    init = (tb.load_params(ref_params_path) if start == "shipped"
            else tb.init_params(torch.Generator().manual_seed(0), hidden=start))
    n = len(data[2])
    steps = n // min(batch, n)  # whole batches an epoch
    runs = {}
    for graph in (False, True):
        out = tmp_path / str(graph)
        runs[graph] = fit_with(monkeypatch, graph, init, data, cfg, epochs=epochs,
                               batch_size=batch, checkpoint_dir=str(out))
        params, rec, counts = runs[graph]
        assert len(rec.losses) == epochs * steps
        # every update Adam made: epochs x whole batches
        assert {int(s["step"]) for s in rec.optimizer.state.values()} == {epochs * steps}
        # each step returned a tensor of its own, and fit logged their mean
        assert len({x.data_ptr() for x in rec.losses}) == len(rec.losses)
        for e in range(epochs):
            meta = tb.load_params_meta(str(out / f"epoch{e:03d}.npz"))
            want = float(torch.stack(rec.losses[e * steps:(e + 1) * steps]).double().mean())
            assert meta["metrics"]["train_loss"] == want
    eager, graphed = runs[False], runs[True]
    assert torch.equal(torch.stack(graphed[1].losses), torch.stack(eager[1].losses))
    assert len(set(float(x) for x in graphed[1].losses)) > 1
    _assert_same_params(graphed[0], eager[0])
    want = epochs * steps
    assert eager[2] == {"captures": 0, "replays": 0, "eager": want, "released": 0}
    # one capture for the run's one shape, released when fit returned
    assert graphed[2] == {"captures": 1, "replays": want, "eager": 0, "released": 1}


SHAPES = [(32, 24), (16, 24), (32, 24), (24, 16), (16, 24), (24, 16), (32, 24)]


def test_shapes_share_one_step_and_match_eager(ref_params_path):
    """One step object over batches of three (B, T) shapes in turn: one
    capture each, and every update reads the gradients of its own shape's
    buffer (the leaves' .grad are bound again after each replay, even when
    zero_grad set them to None in between), bit for bit as the eager step;
    release() frees every shape's buffers."""
    rng = np.random.default_rng(8)
    batches = []
    for B, T in SHAPES:
        tok, lengths, labels = tt.synthetic_dataset(rng, B, max_len=T)
        batches.append((torch.from_numpy(tok), torch.from_numpy(lengths),
                        torch.from_numpy(labels).long()))
    cfg = tt.TrainConfig(learning_rate=LR)
    got = {}
    for graph in (False, True):
        model = tb.BiLSTM(tb.load_params(ref_params_path))
        opt = tt.make_optimizer(cfg, model.parameters())
        step = tt.make_train_step(cfg, opt, graph=graph)
        tt.reset_step_counts()
        losses = []
        for batch in batches:
            losses.append(step(model.params(), *batch))
            opt.zero_grad(set_to_none=True)
        step.release()
        assert all(p.grad is None for p in model.params())
        got[graph] = (torch.stack(losses), model.params(), tt.step_counts())
    assert torch.equal(got[True][0], got[False][0])
    _assert_same_params(got[True][1], got[False][1])
    assert got[True][2] == {"captures": 3, "replays": len(SHAPES), "eager": 0, "released": 3}


def test_rows_gather_into_the_buffers(ref_params_path):
    """step(..., rows) gathers its batch from the whole set into the input
    buffers: the same losses and params as the eager step given the rows'
    batch, and the buffers hold the last batch's rows."""
    data = [torch.from_numpy(x) for x in _data()]
    data[2] = data[2].long()
    cfg = tt.TrainConfig(learning_rate=LR)
    perm = torch.from_numpy(np.random.default_rng(1).permutation(N))
    got = {}
    for graph in (False, True):
        model = tb.BiLSTM(tb.load_params(ref_params_path))
        step = tt.make_train_step(cfg, tt.make_optimizer(cfg, model.parameters()), graph=graph)
        losses = [step(model.params(), *data, perm[s: s + BATCH]) for s in range(0, N, BATCH)]
        got[graph] = (torch.stack(losses), model.params(), step)
    assert torch.equal(got[True][0], got[False][0])
    _assert_same_params(got[True][1], got[False][1])
    (static,) = got[True][2].static.values()
    for buf, x in zip(static.inputs, data):
        assert torch.equal(buf, x[perm[N - BATCH:]])


def _grid(world, tp, rank=0):
    return Grid(make_dp_tp_mesh(world, tp=tp, devices=range(world)), rank, None, None)


@pytest.mark.parametrize("device,grid,graph,want", [
    ("cpu", None, None, "eager"),       # CPU training: the eager step
    ("cuda", None, None, "graph"),      # one card: captured
    ("cuda", (2, 1), None, "graph"),    # dp ranks: captured, the average after it
    ("cuda", (4, 2), None, "eager"),    # tp: collectives inside the recurrence
    ("cuda", None, False, "eager"),     # asked for: chip_smoke's side-by-side check
    ("cpu", None, True, "graph"),       # asked for: the tests' graph-ready body
    ("cpu", (2, 1), True, "graph"),
])
def test_step_kind(device, grid, graph, want):
    assert tt.step_kind(device, grid and _grid(*grid), graph) == want


def test_graph_at_tp_refused():
    model = tb.BiLSTM(tb.init_params(torch.Generator().manual_seed(0), hidden=16))
    cfg = tt.TrainConfig()
    with pytest.raises(ValueError, match="tp > 1 runs eagerly"):
        tt.make_train_step(cfg, tt.make_optimizer(cfg, model.parameters()), _grid(4, 2),
                           graph=True)


# One dp rank: fit eagerly, then with the graph-ready step, each step's
# loss (hex, bit for bit), the returned params, Adam's step counts and the
# step counts.
DP_FIT = r"""
import json, sys
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist
from ribodetector_tpu_torch.models import bilstm as tb
from ribodetector_tpu_torch.parallel.mesh import make_grid
from ribodetector_tpu_torch.train import trainer as tt

spec, rank = json.loads(sys.argv[1]), int(sys.argv[2])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=spec["init_method"], world_size=spec["world"],
                        rank=rank, timeout=timedelta(seconds=60))
grid = make_grid(1)
data = tt.synthetic_dataset(np.random.default_rng(5), spec["n"], max_len=spec["len"])
make, report = tt.make_train_step, {}
for graph in (False, True):
    made = []

    def spy(cfg, optimizer, grid=None):
        step = make(cfg, optimizer, grid, graph=graph)
        losses = []

        class Recording:
            def __call__(self, *a):
                losses.append(step(*a))
                return losses[-1]

            def release(self):
                step.release()
        made.append((optimizer, losses))
        return Recording()

    tt.make_train_step = spy
    tt.reset_step_counts()
    params = tt.fit(tb.load_params(spec["init"]), data, tt.TrainConfig(learning_rate=spec["lr"]),
                    epochs=spec["epochs"], batch_size=spec["batch"], grid=grid,
                    log_fn=lambda m: None)
    opt, losses = made[0]
    report[str(graph)] = {
        "losses": [float(x).hex() for x in losses],
        "params": [np.asarray(p).tobytes().hex() for p in params],
        "adam_steps": sorted({int(s["step"]) for s in opt.state.values()}),
        "counts": tt.step_counts()}
print(json.dumps({"rank": rank, **report}))
dist.destroy_process_group()
"""


def test_dp2_graph_ready_matches_eager(ref_params_path):
    """Two ranks over gloo at dp = 2: the graph-ready step (its flat
    gradient buffer averaged in place by one all_reduce) against the eager
    step (which averages a new flat tensor and rebinds .grad), bit for bit
    on every rank: each step's loss over the rank's rows and the params."""
    epochs = 2
    spec = {"n": N, "len": LEN, "lr": LR, "batch": BATCH, "epochs": epochs,
            "init": ref_params_path}
    reports = [json.loads(out.strip().splitlines()[-1])
               for out in _finish(_start(DP_FIT, 2, spec))]
    steps = epochs * (N // BATCH)
    for r in reports:
        eager, graphed = r["False"], r["True"]
        assert graphed["losses"] == eager["losses"] and len(eager["losses"]) == steps
        assert len(set(graphed["losses"])) > 1
        assert graphed["params"] == eager["params"]
        assert eager["adam_steps"] == graphed["adam_steps"] == [steps]
        assert eager["counts"] == {"captures": 0, "replays": 0, "eager": steps, "released": 0}
        assert graphed["counts"] == {"captures": 1, "replays": steps, "eager": 0,
                                     "released": 1}
    # the ranks' losses are over their own rows; the params are the same
    assert reports[0]["True"]["losses"] != reports[1]["True"]["losses"]
    assert reports[0]["True"]["params"] == reports[1]["True"]["params"]
