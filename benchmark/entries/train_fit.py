"""Entry: a retrain, one ``ribodetector_tpu_torch.train.trainer.fit`` call
on one card from the shipped weights, as a user who retrains on their own
reads runs it: batch 200, the validation set evaluated and a checkpoint
written each epoch.

Set-up makes the motif task from the seed and runs a short fit (the
allocator, cuBLAS, the exact eval kernel). The window is one fit with more
epochs than it can finish; the benchmark ends it at the first epoch end
past ``--seconds`` (and after two epochs at least), so the window holds one
graph capture and whole epochs. A traced run profiles a slice of whole
graphed steps inside one epoch (``trace_from``, ``trace_steps`` in the
mix), which the device's idle share is read over from the first device
event to the last.

The check follows the window's first three steps with the plain
reference (the same weights, the same rows by fit's batch rule: the
permutation np.random.default_rng(epoch) of the rows, in whole batches):
each step's loss, each leaf's first gradient as Adam got it (worked out
from its first moment after one step, mu = (1 - b1) g) and each leaf's
change over the three steps; and it holds the first checkpoint's eval
metrics to the reference's eval of that checkpoint's weights.
"""

import json
import os
import time

import numpy as np

from harness import hooks, traffic, work
from harness.trace import Slice
from reference import model as ref

B1 = 0.9  # Adam's b1 (optax's default, train/optim.py)
FIRST_STEPS = 3


class StopWindow(Exception):
    pass


def make_inputs(run):
    """(train (tokens, lengths, labels), val (tokens, lengths, labels))."""
    L, mix = run.cfg["len"], run.mix
    rng = run.rng("motif")
    sets = []
    for n in (mix["train_reads"], mix["val_reads"]):
        bases, lengths, labels = traffic.motif_task(rng, n, L, mix["motif"])
        sets.append((ref.encode(bases, lengths, L, False), lengths.astype(np.int32), labels))
    return sets[0], sets[1]


def train_config(run):
    from ribodetector_tpu_torch.train import trainer

    return trainer.TrainConfig(learning_rate=run.cfg["learning_rate"],
                               weight_decay=run.cfg["weight_decay"],
                               semantics=run.cfg["semantics"],
                               compute_dtype=run.cfg["compute_dtype"])


def setup(run):
    import torch

    from ribodetector_tpu_torch.models import load_params
    from ribodetector_tpu_torch.train import trainer

    data, val = make_inputs(run)
    device = torch.device("cuda", 0) if run.device == "cuda" else torch.device("cpu")
    params = load_params(run.weights, device)
    warm = tuple(x[: run.mix["warmup_reads"]] for x in data)
    trainer.fit(params, warm, train_config(run), epochs=1,
                batch_size=run.cfg["batch_size"], device=device, eval_data=val,
                log_fn=lambda msg: None, checkpoint_dir=os.path.dirname(run.path("warm", "x")))
    return {"data": data, "val": val, "device": device, "params": params,
            "ck": os.path.dirname(run.path("ck", "x"))}


def window(run, state):
    from ribodetector_tpu_torch.train import trainer

    B = run.cfg["batch_size"]
    sl = Slice(run.tmp, run.device) if run.trace else None
    epochs = []
    with hooks.train_steps(run, run.mix["trace_from"], run.mix["trace_steps"]) as steps:
        steps.slice = sl
        t0 = time.perf_counter()

        def log_fn(msg):
            epochs.append(msg)
            if len(epochs) >= 2 and time.perf_counter() - t0 >= run.seconds:
                raise StopWindow

        try:
            trainer.fit(state["params"], state["data"], train_config(run), epochs=10**6,
                        batch_size=B, device=state["device"], eval_data=state["val"],
                        log_fn=log_fn, checkpoint_dir=state["ck"])
        except StopWindow:
            pass
        run.sync()
        # the profiler's own start and stop are not the program's time
        wall = time.perf_counter() - t0 - (sl.overhead_s if sl else 0.0)
        if sl is not None and steps.slice_steps == 0 and steps.steps > steps.trace_from:
            sl.stop()  # the window closed inside the slice
            steps.slice_steps = steps.steps - steps.trace_from
        if sl is not None and steps.slice_steps:
            sl.finish()
    L = run.cfg["len"]
    lengths = state["data"][1]
    n, per_epoch = len(lengths), len(lengths) // B
    train_bases = sum(
        work.bases(lengths[np.random.default_rng(e).permutation(n)[: per_epoch * B]], L)
        for e in range(len(epochs)))
    state["steps"], state["epochs"] = steps, len(epochs)
    val_lengths = state["val"][1]
    return {
        "wall_s": wall, "attempted": steps.steps, "failed": 0,
        "train_reads": steps.steps * B, "train_bases": train_bases,
        "eval_reads": len(epochs) * len(val_lengths),
        "eval_bases": len(epochs) * work.bases(val_lengths, L),
        "epochs": len(epochs), "slice_steps": steps.slice_steps,
        "trace": sl.summary if sl else None,
    }


def leaf_gap(got, want):
    """The worst leaf's gap of norms, |norm(got) - norm(want)|, over the
    larger of the reference leaf's norm and the median leaf's; leaves
    whose reference norm is under a thousandth of the median leaf's are
    left out (they move by round-off alone)."""
    norms = {k: float(v.norm()) for k, v in want.items()}
    median = float(np.median(list(norms.values())))
    gaps = [abs(float(got[k].norm()) - norms[k]) / max(norms[k], median)
            for k in want if norms[k] >= 1e-3 * median]
    return max(gaps)


def reference_run(run, state):
    """The reference's first steps from the npz weights over fit's first
    batches -> (losses, first gradient per leaf, change per leaf)."""
    import torch

    B = run.cfg["batch_size"]
    tokens, _, labels = state["data"]
    dev = "cuda" if run.device == "cuda" else "cpu"
    w0 = ref.load_weights(run.weights, dev)
    rows = np.random.default_rng(0).permutation(len(labels))
    batches = [(torch.from_numpy(tokens[rows[i * B:(i + 1) * B]]).to(dev),
                torch.from_numpy(labels[rows[i * B:(i + 1) * B]]).to(dev))
               for i in range(FIRST_STEPS)]
    losses, g1, w3 = ref.train_steps(w0, batches, run.cfg["learning_rate"])
    return losses, g1, {k: w3[k] - w0[k] for k in w0}


def compare(got, want):
    """The numbers a run is held to: (losses, first gradients, changes) of
    the side judged against the reference's."""
    (l_got, g_got, d_got), (l_want, g_want, d_want) = got, want
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(l_got, l_want)),
        "grad_gap": leaf_gap(g_got, g_want),
        "delta_gap": leaf_gap(d_got, d_want),
    }


def eval_gap(run, state):
    """The first checkpoint's eval loss against the reference's eval of its
    weights, relative; None without that checkpoint."""
    path = os.path.join(state["ck"], "epoch000.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as z:  # the metrics fit wrote beside the weights
        written = json.loads(z["_meta_json"].tobytes().decode())["metrics"]["loss"]
    dev = "cuda" if run.device == "cuda" else "cpu"
    w = ref.load_weights(path, dev)
    tokens, _, labels = state["val"]
    loss, _ = ref.evaluate(w, tokens, labels)
    return abs(written - loss) / loss


def check(run, state, rec):
    steps = state["steps"]
    want = reference_run(run, state)
    fields = list(ref.FIELDS)
    sizes = [v.numel() for v in ref.load_weights(run.weights).values()]
    g1 = dict(zip(fields, (steps.mu1 / (1 - B1)).cpu().split(sizes)))
    w0 = ref.load_weights(run.weights)
    g1 = {k: v.reshape(w0[k].shape) for k, v in g1.items()}
    delta = {k: p.cpu() - w0[k] for k, p in zip(fields, steps.params3)}
    got = ([float(x) for x in steps.losses], g1, delta)
    want = tuple(want[0:1]) + tuple({k: v.cpu() for k, v in d.items()} for d in want[1:])
    numbers = compare(got, want)
    # checkpoints: one an epoch but the last (the window closed in its log),
    # and best.npz
    ck = state["ck"]
    expected = [f"epoch{e:03d}.npz" for e in range(state["epochs"] - 1)]
    faults = sum(not os.path.exists(os.path.join(ck, f)) for f in expected + ["best.npz"])
    gap = eval_gap(run, state)
    numbers["eval_loss_gap"] = 1.0 if gap is None else gap
    numbers["layout_faults"] = faults
    return numbers

