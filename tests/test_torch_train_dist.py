"""The port's training over a (dp, tp) grid of processes, against JAX and
against one process.

Each rank is a subprocess in a gloo group on 127.0.0.1 (one intra-op
thread each), as the training CLI runs one process per card in an NCCL
group. Three grids train the shipped weights on
synthetic_dataset(np.random.default_rng(3), 256, max_len=40), batch 32,
lr 5e-3, 2 epochs: dp = 2, tp = 2 and dp = 2 x tp = 2. Each is held:

- against JAX's fit on a (4, 2) mesh of the virtual 8-device CPU
  (make_dp_tp_mesh(4, tp=2), which runs there), as test_fit_matches_jax
  holds the one-process fit: per-epoch train loss to 1e-4 relative,
  parameters to max-abs <= lr (Adam moves a weight whose gradient is near
  zero by up to lr on rounding);
- against the port's one-process fit, to the same tolerances (measured:
  tp = 2 alone bit for bit on the CPU, the dp grids 8e-7 on the losses
  and 4e-6 on the parameters: a dp split sums the gradient in another
  order);
- one step's gradients, gathered over tp and averaged over dp, against
  one process's within 1e-6 relative: a gather whose backward summed
  over the tp ranks would double every gate gradient here.
"""

import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from ribodetector_tpu.models import bilstm as jb
from ribodetector_tpu.parallel import make_dp_tp_mesh as jax_mesh
from ribodetector_tpu.train import trainer as jt
from ribodetector_tpu.train.__main__ import main as jax_train_main
from ribodetector_tpu_torch.models import bilstm as tb
from ribodetector_tpu_torch.parallel.mesh import Grid, make_dp_tp_mesh
from ribodetector_tpu_torch.train import trainer as tt
from ribodetector_tpu_torch.train.__main__ import main as train_main
from tests.test_torch_train import mkfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, EPOCHS, BATCH, N, LEN = 5e-3, 2, 32, 256, 40
GRIDS = {"dp2": (2, 1), "tp2": (2, 2), "dp2xtp2": (4, 2)}  # name: (world, tp)
TIMEOUT = 240  # seconds for a whole group; a hang fails the test, not the run

# One rank: one step's gradients from the init on epoch 0's first batch
# (this rank's dp rows), gathered over tp; with init64, one step at hidden
# 64 and the Adam state's shapes; then fit from the init with every
# rank's checkpoint writes counted.
FIT = r"""
import json, sys
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist
from ribodetector_tpu_torch.models import bilstm as tb
from ribodetector_tpu_torch.parallel.mesh import batch_sharded, make_grid
from ribodetector_tpu_torch.train import trainer as tt
from ribodetector_tpu_torch.train.optim import leaf_views

spec, rank = json.loads(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", init_method=spec["init_method"], world_size=spec["world"],
                        rank=rank, timeout=timedelta(seconds=60))
grid = make_grid(spec["tp"])
data = tt.synthetic_dataset(np.random.default_rng(3), spec["n"], max_len=spec["len"])
cfg = tt.TrainConfig(learning_rate=spec["lr"])
init = tb.load_params(spec["init"])
model = tb.BiLSTM(tt.shard_params(init, grid))
leaves = model.params()
opt = tt.make_optimizer(cfg, model.parameters())
idx = np.random.default_rng(0).permutation(spec["n"])[:spec["batch"]]
idx = batch_sharded(grid.mesh, "dp")(idx, grid.dp_index)
tok, ln, lab = (torch.from_numpy(x[idx]) for x in data)
tt.make_train_step(cfg, opt, grid)(leaves, tok, ln, lab.long())
grads = tt.gather_params(tb.BiLSTMParams(*(p.grad for p in leaves)), grid)
if rank == 0:
    np.savez(spec["out"] + "/grads.npz",
             **{k: g.numpy() for k, g in zip(tb.BiLSTMParams._fields, grads)})
shapes = None
if spec.get("init64"):  # one more step, at hidden 64: the Adam state's shapes
    model64 = tb.BiLSTM(tt.shard_params(tb.load_params(spec["init64"]), grid))
    opt64 = tt.make_optimizer(cfg, model64.parameters())
    tt.make_train_step(cfg, opt64, grid)(model64.params(), tok, ln, lab.long())
    leaves64 = model64.params()
    shapes = {k: [list(p.shape), list(mu.shape), list(nu.shape)]
              for k, p, mu, nu in zip(tb.BiLSTMParams._fields, leaves64,
                                      leaf_views(opt64.mu, leaves64),
                                      leaf_views(opt64.nu, leaves64))}
saves, logs = [], []
save = tt.save_params
tt.save_params = lambda path, *a: saves.append(path) or save(path, *a)
if spec["epochs"]:
    tt.fit(init, data, cfg, epochs=spec["epochs"], batch_size=spec["batch"], grid=grid,
           eval_data=tuple(x[:64] for x in data), log_fn=logs.append,
           checkpoint_dir=spec["out"] + "/ck")
print(json.dumps({"rank": rank, "at": [grid.dp_index, grid.tp_index], "shapes": shapes,
                  "saves": saves, "logs": logs}))
dist.destroy_process_group()
"""

# One rank of the training CLI, through the worker that main spawns.
CLI = (
    "import json, sys\n"
    "from ribodetector_tpu_torch.train.__main__ import worker\n"
    "a = json.loads(sys.argv[1])\n"
    "worker(int(sys.argv[2]), a['world'], a['tp'], 'gloo', 'cpu', a['argv'], a['init_method'])\n"
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one intra-op thread here, as in the ranks (the plain
    recurrence's small ops stall on thread barriers when the test workers
    oversubscribe the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(code, world, spec):
    spec = {**spec, "world": world, "init_method": f"tcp://127.0.0.1:{_free_port()}"}
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen([sys.executable, "-c", code, json.dumps(spec), str(r)],
                             cwd=REPO, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for r in range(world)]


def _finish(procs):
    """Each rank's stdout; every rank must exit 0 within TIMEOUT."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [out for out, _ in outs]


def _data():
    return tt.synthetic_dataset(np.random.default_rng(3), N, max_len=LEN)


def _epoch_losses(ckdir):
    return [tb.load_params_meta(os.path.join(ckdir, f"epoch{e:03d}.npz"))
            ["metrics"]["train_loss"] for e in range(EPOCHS)]


def _params(path):
    with np.load(path) as z:
        return {k: z[k] for k in tb.BiLSTMParams._fields}


@pytest.fixture(scope="module")
def hidden64_init(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("h64") / "init64.npz")
    tb.save_params(path, tb.init_params(torch.Generator().manual_seed(0), hidden=64), {})
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory, ref_params_path, hidden64_init):
    """Every grid's group, started together: {name: (out dir, [rank's
    report])}; the tp = 2 group also takes a step at hidden 64."""
    groups = {}
    for name, (world, tp) in GRIDS.items():
        out = str(tmp_path_factory.mktemp(name))
        spec = {"tp": tp, "n": N, "len": LEN, "lr": LR, "batch": BATCH, "out": out,
                "init": ref_params_path, "epochs": EPOCHS,
                "init64": hidden64_init if name == "tp2" else None}
        groups[name] = (out, _start(FIT, world, spec))
    return {name: (out, [json.loads(o.strip().splitlines()[-1]) for o in _finish(procs)])
            for name, (out, procs) in groups.items()}


@pytest.fixture(scope="module")
def one_process(tmp_path_factory, ref_params_path):
    """The port's fit in one process, and one step's gradients there."""
    out = str(tmp_path_factory.mktemp("one"))
    data = _data()
    tt.fit(tb.load_params(ref_params_path), data, tt.TrainConfig(learning_rate=LR),
           epochs=EPOCHS, batch_size=BATCH, eval_data=tuple(x[:64] for x in data),
           log_fn=lambda m: None, checkpoint_dir=out)
    leaves = tb.BiLSTMParams(*(p.requires_grad_(True) for p in tb.load_params(ref_params_path)))
    idx = np.random.default_rng(0).permutation(N)[:BATCH]
    loss, _ = tt._loss_fn(leaves, *(torch.from_numpy(x[idx]) for x in data), "dense",
                          torch.float32)
    loss.backward()
    return out, {k: p.grad.numpy() for k, p in zip(tb.BiLSTMParams._fields, leaves)}


@pytest.fixture(scope="module")
def jax_fit(tmp_path_factory, ref_params_path):
    """JAX's fit on a (dp=4, tp=2) mesh of the virtual CPU devices."""
    out = str(tmp_path_factory.mktemp("jax"))
    params = jt.fit(jb.load_params(ref_params_path), _data(), jt.TrainConfig(learning_rate=LR),
                    epochs=EPOCHS, batch_size=BATCH, mesh=jax_mesh(4, tp=2),
                    log_fn=lambda m: None, checkpoint_dir=out)
    return out, {k: np.asarray(getattr(params, k)) for k in tb.BiLSTMParams._fields}


def _assert_fit_close(out, want_dir, want_params):
    np.testing.assert_allclose(_epoch_losses(os.path.join(out, "ck")),
                               _epoch_losses(want_dir), rtol=1e-4, atol=0)
    got = _params(os.path.join(out, "ck", f"epoch{EPOCHS - 1:03d}.npz"))
    for k, w in want_params.items():
        gap = np.abs(got[k] - w).max()
        assert gap <= LR, (k, gap)


@pytest.mark.parametrize("name", GRIDS)
def test_grid_fit_matches_jax(runs, jax_fit, name):
    _assert_fit_close(runs[name][0], *jax_fit)


@pytest.mark.parametrize("name", GRIDS)
def test_grid_fit_matches_one_process(runs, one_process, name):
    want_dir = one_process[0]
    _assert_fit_close(runs[name][0], want_dir,
                      _params(os.path.join(want_dir, f"epoch{EPOCHS - 1:03d}.npz")))


@pytest.mark.parametrize("name", GRIDS)
def test_one_step_gradients_match_one_process(runs, one_process, name):
    got = _params(os.path.join(runs[name][0], "grads.npz"))
    for k, want in one_process[1].items():
        assert got[k].shape == want.shape
        gap = np.abs(got[k] - want).max() / np.abs(want).max()
        assert gap <= 1e-6, (k, gap)


@pytest.mark.parametrize("name", GRIDS)
def test_rank0_writes_the_only_checkpoints(runs, name):
    out, reports = runs[name]
    world, tp = GRIDS[name]
    assert sorted(r["at"] for r in reports) == \
        [[r // tp, r % tp] for r in range(world)]  # rank r at (r // tp, r % tp)
    ck = os.path.join(out, "ck")
    files = sorted(os.listdir(ck))
    assert files == ["best.npz"] + [f"epoch{e:03d}.npz" for e in range(EPOCHS)]
    by_rank = {r["rank"]: r["saves"] for r in reports}
    assert {os.path.basename(p) for p in by_rank[0]} == set(files)
    assert not any(by_rank[r] for r in range(1, world))
    for f in files:  # full widths, loadable by both packages
        assert tuple(tb.load_params(os.path.join(ck, f)).w_hh_f.shape) == (128, 512)
        assert jb.load_params(os.path.join(ck, f)).w_ih_b.shape == (4, 512)


@pytest.mark.parametrize("name", GRIDS)
def test_every_rank_logs_the_same_metrics(runs, name):
    logs = [r["logs"] for r in runs[name][1]]
    assert len(logs[0]) == EPOCHS and "mcc" in logs[0][0]
    assert all(lg == logs[0] for lg in logs)


def test_tp_shards_follow_custom_width(runs):
    """Twin of test_opt_state_tp_sharding_follows_custom_width: at hidden
    64 and tp = 2 each rank holds 128 of the 256 gate columns, and Adam's
    moments follow its slice; w_out/b_out stay whole."""
    for r in runs["tp2"][1]:
        for k in tt.GATE_LEAVES:
            param, mu, nu = r["shapes"][k]
            assert param[-1] == 128 and mu == param and nu == param, (k, r["shapes"][k])
        assert r["shapes"]["w_out"] == [[128, 2]] * 3
        assert r["shapes"]["b_out"] == [[2]] * 3


def test_param_shardings_and_shards():
    params = tb.init_params(torch.Generator().manual_seed(0), hidden=64)
    mesh = make_dp_tp_mesh(8, tp=2, devices=range(8))
    cut = tt.param_shardings(Grid(mesh, 3, None, None))
    assert {k for k, a in cut._asdict().items() if a is not None} == set(tt.GATE_LEAVES)
    assert all(a is None for a in tt.param_shardings(None))
    one = Grid(make_dp_tp_mesh(4, tp=1, devices=range(4)), 2, None, None)
    assert all(a is None for a in tt.param_shardings(one))
    parts = [tt.shard_params(params, Grid(mesh, r, None, None)) for r in (0, 1)]
    assert parts[0].w_hh_f.shape == (64, 128) and parts[0].w_out.shape == (128, 2)
    # the tp slices, in tp order, are the whole leaf
    assert torch.equal(torch.cat([p.b_b for p in parts]), params.b_b)
    assert torch.equal(tt.shard_params(params, one).w_ih_f, params.w_ih_f)


# ---------------------------------------------------------------- the CLI


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(9)
    mkfile(rng, d / "rrna.fa", 60, True)
    mkfile(rng, d / "norrna.fa", 60, False)
    return d


def _cli_argv(d, out, extra=()):
    return ["--rrna", str(d / "rrna.fa"), "--norrna", str(d / "norrna.fa"), "-l", "32",
            "--epochs", "1", "--batch", "33", "--out", str(out), *extra]


@pytest.fixture(scope="module")
def jax_cli_lines(cli_files):
    """The JAX CLI's two mesh lines on the 8 virtual devices at --tp 2
    (printed before fit; no epoch runs)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_train_main(_cli_argv(cli_files, cli_files / "jax_ck", ["--tp", "2", "--epochs", "0"]))
    return [ln for ln in buf.getvalue().splitlines()
            if ln.startswith(("--batch rounded", "training on"))]


def _shape_of(line):
    return re.sub(r"\d+", "N", line)


def test_cli_prints_the_jax_mesh_lines(cli_files, jax_cli_lines):
    """Two ranks at --tp 3: tp falls back to 1 (3 does not divide 2), as
    make_dp_tp_mesh does, and the batch of 33 rounds to dp = 2. Rank 0
    alone prints; the batch-rounding and mesh lines are the JAX CLI's
    (whose 8 devices at --tp 2 make another mesh)."""
    out = cli_files / "port_ck"
    stdouts = _finish(_start(CLI, 2, {"tp": 3, "argv": _cli_argv(cli_files, out, ["--tp", "3"])}))
    lines = stdouts[0].splitlines()
    want = ["--batch rounded to 32 (divisible by dp=2)",
            "training on 2 devices, mesh {'dp': 2, 'tp': 1}"]
    assert [ln for ln in lines if ln.startswith(("--batch rounded", "training on"))] == want
    assert [_shape_of(ln) for ln in want] == [_shape_of(ln) for ln in jax_cli_lines]
    assert jax_cli_lines[1] == "training on 8 devices, mesh {'dp': 4, 'tp': 2}"
    assert "loaded 120 training reads (60 rRNA / 60 non-rRNA)" in lines
    assert not any(s.strip() for s in stdouts[1:])
    assert (out / "best.npz").exists()
    assert tb.load_params_meta(str(out / "epoch000.npz"))["batch_size"] == 32


def test_main_raises_when_a_worker_fails(cli_files):
    """`python -m ribodetector_tpu_torch.train` with several cards visible
    (two, faked here) spawns one worker per card; here every worker fails
    to take its card (a CPU-only torch), and main exits non-zero instead of
    training elsewhere. The workers got as far as the card: the spawned
    processes could import the worker, which under -m lives in __main__."""
    out = cli_files / "never"
    code = ("import runpy, sys, torch\n"
            "torch.cuda.device_count = lambda: 2\n"
            "sys.argv = ['train', *sys.argv[1:]]\n"
            "runpy.run_module('ribodetector_tpu_torch.train', run_name='__main__',"
            " alter_sys=True)\n")
    proc = subprocess.run([sys.executable, "-c", code, *_cli_argv(cli_files, out)],
                          cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
                          capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode != 0
    assert "ProcessRaisedException" in proc.stderr, proc.stderr[-3000:]
    # the worker itself ran, and failed taking its card
    assert "in worker" in proc.stderr and "set_device" in proc.stderr, proc.stderr[-3000:]
    assert not out.exists()
