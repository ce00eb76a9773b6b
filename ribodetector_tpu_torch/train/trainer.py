"""Trainer for the BiLSTM read classifier, on one device or a (dp, tp) grid.

Counterpart of ``ribodetector_tpu/train/trainer.py``. The JAX trainer
differentiates its ``lax.scan`` recurrence; this one trains through autograd
over the port's plain recurrence (models/bilstm.bilstm_logits), never
``torch.nn.LSTM`` or cuDNN: no kernel of the port has a backward pass, as
no Pallas kernel of the JAX package has one. The eval step runs the
classify dispatch instead, which on the card at hidden 128 is the exact
CUDA kernel (the same fp32 function as the training forward).

On several devices the JAX trainer shards over a (dp, tp) mesh and XLA
inserts the collectives. Here one process runs per device, placed on a
parallel.mesh.Grid of the ranks of a ``torch.distributed`` group, and the
collectives are explicit:

- dp: each rank takes its contiguous rows of every batch (P("dp")), and
  the gradients are averaged over the dp group after the backward pass,
  so the update is that of the mean loss over the whole batch;
- tp: the 512 gate columns of w_ih_*, w_hh_* and b_* are cut over the tp
  group (param_shardings) and w_out/b_out are whole on every rank. Each
  rank computes its [B, 512/tp] slice of gates_x + h @ w_hh, the slices
  are gathered to [B, 512], and the cell and the head run in full on
  every tp rank. Adam's state lives with each rank's slice;
- collectives are all_reduce (a gather is an all_reduce of a zero-filled
  buffer) and barrier only: gloo has no all_gather of CUDA tensors, and
  two ranks that share one card need gloo.

The JAX trainer jits its step, so forward, backward, the collectives and
the update go out as one program a step. Here, on the card, each input
shape's step is captured once as a CUDA graph over static input buffers
and replayed every step (make_train_step): forward and backward, the dp
average of the gradients and the Adam update (train/optim.py, optax's
arithmetic on device state), with tp's collectives inside the recurrence
when the group is NCCL. About 8,800 small kernels a step at T = 100 go
out as one graph launch. gloo's collectives cannot be captured: over gloo
on the card (ranks that share one card) the dp average and the update run
eagerly after the replay, and tp > 1 runs the eager step. The CPU runs the
eager step.

Differences from the JAX trainer, by design:

- an explicit ``device`` and ``grid`` take the place of the mesh;
- the optimizer (optim.Adam) holds its own state and updates the
  parameters in place, so a train step takes the parameters and a batch
  and returns the loss;
- matmuls run in fp32 (torch's default matmul precision, no TF32), where
  the JAX trainer asks for ``Precision.DEFAULT``, one bf16 pass on a TPU.

Checkpoint metadata mirrors the reference's (.pth keys
arch/epoch/batch_size/metrics), and the npz artifacts are the JAX
package's format.
"""

import collections
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ribodetector_tpu_torch.models.bilstm import (
    BiLSTM,
    BiLSTMParams,
    bilstm_last_out,
    bilstm_logits,
    head_in,
    lstm_update,
    save_params,
)
from ribodetector_tpu_torch.parallel.mesh import RowSplit, batch_sharded
from ribodetector_tpu_torch.runtime.profiling import span
from ribodetector_tpu_torch.train.loss import cross_entropy_loss
from ribodetector_tpu_torch.train.metrics import confusion_counts
from ribodetector_tpu_torch.train.optim import Adam, leaf_views


@dataclass
class TrainConfig:
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    semantics: str = "dense"
    compute_dtype: str = "float32"


def make_optimizer(cfg: TrainConfig, params):
    """optim.Adam over `params` (an iterable of leaf tensors): optax.adam, or
    optax.adamw with cfg.weight_decay when the decay is non-zero."""
    return Adam(params, cfg.learning_rate, cfg.weight_decay)


GATE_LEAVES = ("w_ih_f", "w_hh_f", "b_f", "w_ih_b", "w_hh_b", "b_b")


def param_shardings(grid=None) -> BiLSTMParams:
    """Tensor-parallel layout over the grid's tp axis: for each leaf the
    axis cut into tp contiguous slices, or None where every rank holds
    the whole leaf. The 512-wide gate dimension (the last axis of the six
    gate leaves) is cut, so each tp rank owns 512/tp gate columns;
    w_out/b_out are whole. Without a grid, or with tp = 1, nothing is cut."""
    tp = grid is not None and grid.tp > 1
    return BiLSTMParams(*(-1 if tp and k in GATE_LEAVES else None
                          for k in BiLSTMParams._fields))


def _columns(grid, width):
    return RowSplit(grid.tp).rows(width, grid.tp_index)


def shard_params(params, grid) -> BiLSTMParams:
    """This rank's part of the full params (param_shardings)."""
    return BiLSTMParams(*(p if axis is None else p[..., _columns(grid, p.shape[-1])]
                          for p, axis in zip(params, param_shardings(grid))))


def _gather_columns(x, grid):
    """[..., c] on each tp rank -> [..., tp * c], slices in tp order: an
    all_reduce of a zero-filled buffer (exact: every other term is 0)."""
    c = x.shape[-1]
    out = x.new_zeros(*x.shape[:-1], grid.tp * c)
    out[..., _columns(grid, grid.tp * c)] = x
    dist.all_reduce(out, group=grid.tp_group)
    return out


def gather_params(part, grid) -> BiLSTMParams:
    """The full params (or gradients) from every tp rank's part: the
    inverse of shard_params. Every rank of the tp group must call it."""
    with torch.no_grad():
        return BiLSTMParams(*(p if axis is None else _gather_columns(p, grid)
                              for p, axis in zip(part, param_shardings(grid))))


class _GatherColumns(torch.autograd.Function):
    """Forward: gather the tp ranks' column slices. Backward: this rank's
    own slice of the gradient. What follows the gather runs identically on
    every tp rank, so each holds the whole gradient already; summing it
    over the ranks (all_gather's backward) would scale it by tp."""

    @staticmethod
    def forward(ctx, x, grid):
        ctx.grid, ctx.width = grid, grid.tp * x.shape[-1]
        return _gather_columns(x, grid)

    @staticmethod
    def backward(ctx, grad):
        return grad[..., _columns(ctx.grid, ctx.width)], None


class _SumGradOverTP(torch.autograd.Function):
    """Forward: identity. Backward: the gradient summed over the tp group.
    h enters each rank's slice of h @ w_hh, so each rank's gradient of h
    through the product covers its own gate columns only."""

    @staticmethod
    def forward(ctx, x, grid):
        ctx.grid = grid
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.grid.tp_group)
        return grad, None


def tp_logits(part, tokens, lengths=None, *, semantics="dense",
              compute_dtype=torch.float32, grid):
    """bilstm_logits with the gate columns cut over the grid's tp group:
    `part` is this rank's shard_params. Each step each rank computes its
    [B, 512/tp] slice of gates_x + h @ w_hh in both directions, the slices
    are gathered to [B, 512] (one collective for the two directions), and
    the cell (models/bilstm.lstm_update) and the head run in full on every
    tp rank."""
    cd = compute_dtype
    w_hh = (part.w_hh_f.to(cd), part.w_hh_b.to(cd))
    hidden, g = w_hh[0].shape

    def step(f, b):
        h = _SumGradOverTP.apply(torch.cat([f[0], b[0]], dim=-1), grid)
        own = torch.cat([f[2] + h[:, :hidden] @ w_hh[0],
                         b[2] + h[:, hidden:] @ w_hh[1]], dim=-1)
        # [B, tp * 2g], rank by rank -> per direction [B, tp * g]
        gates = _GatherColumns.apply(own, grid).unflatten(-1, (grid.tp, 2, g))
        return (lstm_update(gates[:, :, 0].flatten(1), f[1]),
                lstm_update(gates[:, :, 1].flatten(1), b[1]))

    last_out = bilstm_last_out(part, tokens, lengths, semantics=semantics,
                               bwd_init=None, step=step, dtype=cd)
    return head_in(part, last_out, cd)


def _loss_fn(params, tokens, lengths, labels, semantics, compute_dtype, grid=None):
    if grid is not None and grid.tp > 1:
        logits = tp_logits(params, tokens, lengths, semantics=semantics,
                           compute_dtype=compute_dtype, grid=grid)
    else:
        logits = bilstm_logits(params, tokens, lengths, semantics=semantics,
                               compute_dtype=compute_dtype)
    return cross_entropy_loss(logits, labels), logits


# Train steps by kind, counted as ops/lstm_cuda.LAUNCH_COUNTS counts kernel
# launches: "captures" (a graph-ready step built for a new input shape),
# "replays" (one a graph-ready step), "eager" (one an eager step) and
# "released" (graph-ready steps freed; fit frees its own when it returns).
# The updates are the optimizer's own count (optim.Adam.steps).
STEP_COUNTS = collections.Counter()


def step_counts():
    return {k: STEP_COUNTS[k] for k in ("captures", "replays", "eager", "released")}


def reset_step_counts():
    STEP_COUNTS.clear()


def _average_over_dp(flat, grid):
    """The flat gradient buffer averaged over the dp group, in place: one
    all_reduce."""
    dist.all_reduce(flat, group=grid.dp_group)
    flat /= grid.dp


# device index -> the side stream every capture on that card warms up and
# captures on: cuBLAS keeps a workspace for each stream it has run on, for
# the life of the process, so one stream a card keeps that to one. The
# collectives captured there are enqueued on it too: NCCL's stream waits
# on it and joins the capture.
_CAPTURE_STREAMS = {}


def _capture_stream(index):
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
    return _CAPTURE_STREAMS[index]


class _StaticStep:
    """The graph-ready step at one input shape.

    It owns static input buffers, one flat gradient buffer whose per-leaf
    views become the leaves' .grad, and a static loss. Without rows the
    input buffers hold the first batch, and every later batch is copied
    into them. With rows (an index tensor into the whole sets `batch`, which
    must keep their storage while the step lives: fit's device-resident
    set), a static index buffer takes each step's rows, and the body
    gathers the batch into the input buffers itself. `replay` runs the
    body: forward and backward over the buffers, the gradients and the
    loss written into theirs, then `finish(flat, update)` when given one
    (the dp average and the optimizer's update). On the card `replay` is a
    CUDA graph captured once; on the CPU, which has no graphs, the body
    itself.

    Before the capture the body runs once as a warm-up with update=False,
    on the card on the capture stream: it initializes what runs lazily on
    a first call (cuBLAS's handle and workspace there, the allocator's
    blocks, NCCL's communicators, which cannot be created under capture)
    and adds no update. The capture runs nothing. So the first replay makes
    the first update: a step's updates equal its replays. The CPU runs the
    same warm-up.
    """

    def __init__(self, params, batch, rows, loss_fn, finish=None):
        self.params, self.loss_fn, self.finish = params, loss_fn, finish
        if rows is None:
            self.sources, self.rows = None, None
            self.inputs = tuple(None if x is None else x.clone() for x in batch)
        else:
            self.sources, self.rows = batch, rows.clone()
            self.inputs = tuple(None if x is None else x[rows] for x in batch)
        dev = self.params[0].device
        self.flat = torch.zeros(sum(p.numel() for p in params), dtype=params[0].dtype,
                                device=dev)
        self.grads = leaf_views(self.flat, self.params)
        self.loss = torch.zeros((), dtype=torch.float32, device=dev)
        self.graph = None
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                self.replay = self._capture()
        else:
            self.body(update=False)
            self.replay = self.body
        STEP_COUNTS["captures"] += 1

    def body(self, update=True):
        if self.rows is not None:
            for buf, x in zip(self.inputs, self.sources):
                if x is not None:
                    torch.index_select(x, 0, self.rows, out=buf)
        loss, _ = self.loss_fn(self.params, *self.inputs)
        grads = torch.autograd.grad(loss, self.params)
        torch.cat([g.reshape(-1) for g in grads], out=self.flat)
        self.loss.copy_(loss.detach())
        if self.finish is not None:
            self.finish(self.flat, update)

    def _capture(self):
        stream = _capture_stream(torch.cuda.current_device())
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            self.body(update=False)
        torch.cuda.current_stream().wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        # "thread_local": NCCL's watchdog thread goes on querying the events
        # of earlier collectives during a capture, which "global" forbids
        with torch.cuda.graph(self.graph, stream=stream, capture_error_mode="thread_local"):
            self.body()
        return self.graph.replay

    def load(self, batch, rows):
        """Take the next batch: its rows into the index buffer, or the batch
        itself into the input buffers (copies, no kernel launch)."""
        if rows is not None:
            self.rows.copy_(rows)
            return
        for buf, x in zip(self.inputs, batch):
            if x is not None:
                buf.copy_(x)

    def release(self):
        if self.graph is not None:
            self.graph.reset()
        self.sources = None
        for p in self.params:
            p.grad = None


def step_kind(device, grid=None, graph=None, backend=None):
    """How make_train_step's step runs on `device`, in a process group of
    `backend` ("nccl" or "gloo"; unused without a grid):

    - "graph": the whole step graph-ready, one replay a step: forward,
      backward, the dp average and the update, with tp's collectives
      inside the recurrence. On the card without a grid or over NCCL (or
      on a grid of one rank); on the CPU when asked for (graph=True), where
      its body runs in place of a replay.
    - "graph_grads": forward and backward replayed, then the dp average
      and the update eagerly: on the card at dp > 1 and tp = 1 over gloo,
      whose collectives a CUDA graph cannot capture.
    - "eager": graph=False, the CPU by default, and tp > 1 over gloo on
      the card, where graph=True raises.
    """
    if graph is False:
        return "eager"
    if torch.device(device).type != "cuda":
        return "graph" if graph else "eager"
    if grid is None or backend == "nccl" or grid.dp * grid.tp == 1:
        return "graph"
    if grid.tp > 1:
        if graph:
            raise ValueError("the train step at tp > 1 over gloo runs eagerly: its "
                             "collectives run inside the recurrence, and a CUDA graph "
                             "cannot capture gloo's")
        return "eager"
    return "graph_grads"


class TrainStep:
    """step(params, tokens, lengths, labels, rows=None) -> loss; see
    make_train_step. release() frees the captured graphs and their memory
    (and unbinds the leaves' .grad from their buffers)."""

    def __init__(self, cfg, optimizer, grid, graph):
        self.cfg, self.optimizer, self.grid, self.want_graph = cfg, optimizer, grid, graph
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.dp = grid.dp if grid is not None else 1
        self.backend = None if grid is None else dist.get_backend(grid.dp_group)
        self.static = {}

    def _loss(self, params, tokens, lengths, labels):
        return _loss_fn(params, tokens, lengths, labels, self.cfg.semantics,
                        self.compute_dtype, self.grid)

    def _finish(self, flat, update=True):
        """The flat gradient averaged over dp, then the optimizer's update."""
        if self.dp > 1:
            _average_over_dp(flat, self.grid)
        if update:
            self.optimizer.update(flat)

    def __call__(self, params, tokens, lengths, labels, rows=None):
        # the host's part of a step: the replay (or the eager step) is
        # launched inside it, so the device's gaps that fall in it are the
        # host's time within a step and those outside it the time between
        with span("train.step"):
            return self._step(params, tokens, lengths, labels, rows)

    def _step(self, params, tokens, lengths, labels, rows):
        if len(params) != len(self.optimizer.params) or any(
                p is not q for p, q in zip(params, self.optimizer.params)):
            raise ValueError("the train step's params must be the optimizer's, in its order")
        batch = (tokens, lengths, labels)
        kind = step_kind(params[0].device, self.grid, self.want_graph, self.backend)
        if kind == "eager":
            if rows is not None:
                batch = tuple(None if x is None else x[rows] for x in batch)
            return self._eager(params, *batch)
        n = len(tokens) if rows is None else len(rows)
        # with rows the graph gathers from the whole sets: they are its own
        key = (tuple(map(id, params)), n,
               *((None,) if x is None else (tuple(x.shape[1:]), x.dtype) for x in batch),
               None if rows is None else tuple(map(id, batch)))
        static = self.static.get(key)
        if static is None:
            static = self.static[key] = _StaticStep(
                params, batch, rows, self._loss, self._finish if kind == "graph" else None)
        else:
            static.load(batch, rows)
        static.replay()
        STEP_COUNTS["replays"] += 1
        if kind == "graph_grads":
            self._finish(static.flat)
        # the leaves' .grad are the (averaged) gradients the update read,
        # bound again each step: another shape's step may have rebound them
        for p, g in zip(params, static.grads):
            p.grad = g
        # a copy: the static loss is overwritten by the next replay
        return static.loss.clone()

    def _eager(self, params, tokens, lengths, labels):
        STEP_COUNTS["eager"] += 1
        loss, _ = self._loss(params, tokens, lengths, labels)
        flat = torch.cat([g.reshape(-1) for g in torch.autograd.grad(loss, params)])
        self._finish(flat)
        for p, g in zip(params, leaf_views(flat, params)):
            p.grad = g
        return loss.detach()

    def release(self):
        for static in self.static.values():
            static.release()
        STEP_COUNTS["released"] += len(self.static)
        self.static.clear()


def make_train_step(cfg: TrainConfig, optimizer, grid=None, *, graph=None):
    """step(params, tokens, lengths, labels, rows=None) -> loss (a detached
    scalar on the params' device, a tensor of its own each step): one
    forward and backward of the plain recurrence in cfg.compute_dtype, then
    one update of `optimizer` (make_optimizer's optim.Adam), which updates
    the leaf tensors of `params` (the ones it holds, in its order) in
    place; after the step each leaf's .grad is the gradient the update
    read. With rows (an index tensor), the batch is those rows of tokens,
    lengths and labels (fit's device-resident set), gathered by the step
    itself into its input buffers (on the card inside the graph).

    On the card the step is graph-ready (step_kind): for each (params,
    batch, T, input dtypes) it first sees, it captures the whole step once
    as a CUDA graph over static input buffers (one warm-up run first, which
    adds no update), and every step copies its batch into the buffers and
    replays the graph: one graph launch a step. Over gloo the dp average
    and the update run eagerly after the replay, and tp > 1 runs the eager
    step. A failed capture raises. The eager step runs the same update, so
    the two give the same numbers. On the CPU the step runs eagerly. graph
    (an internal argument): False runs the eager step anywhere
    (chip_smoke.py's side-by-side check); True runs the graph-ready step on
    any device (on the CPU its body stands in for the replay: the tests'
    view of the card's step).

    With a grid, `params` is this rank's shard_params and the batch its dp
    rows: the forward runs tp_logits when tp > 1, the gradients are
    averaged over the dp group before the update (one all_reduce of a flat
    buffer, in place), and the loss returned is the mean over this rank's
    rows."""
    return TrainStep(cfg, optimizer, grid, graph)


def make_eval_step(cfg: TrainConfig):
    """step(params, tokens, lengths, labels) -> (per-example losses,
    predictions), under torch.no_grad().

    The logits come from ops.dispatch.classify_logits with kernel="auto":
    on the card at hidden 128 that is the exact CUDA kernel (under bf16
    compute, the one-pass bf16 kernel, as exact refuses bf16), and
    elsewhere (the CPU, or another width on the card) the plain recurrence
    in cfg.compute_dtype. Kept per-example so evaluation runs in bounded
    mini-batches."""
    from ribodetector_tpu_torch.ops.dispatch import classify_logits

    compute_dtype = getattr(torch, cfg.compute_dtype)
    mode = "exact" if compute_dtype == torch.float32 else "fast"

    def step(params, tokens, lengths, labels):
        with torch.no_grad():
            logits = classify_logits(params, tokens, lengths,
                                     semantics=cfg.semantics, kernel="auto",
                                     mode=mode, compute_dtype=compute_dtype)
            losses = F.cross_entropy(logits, labels.long(), reduction="none")
            return losses, logits.argmax(-1)

    return step


def _on(device, tokens, lengths, labels):
    return (torch.from_numpy(np.ascontiguousarray(tokens, np.uint8)).to(device),
            torch.from_numpy(np.ascontiguousarray(lengths, np.int32)).to(device),
            torch.from_numpy(np.ascontiguousarray(labels, np.int64)).to(device))


def evaluate(eval_step, params, eval_data, batch_size=4096):
    """Mini-batched evaluation: metrics over the WHOLE set (the confusion
    counts come from the concatenated predictions, so F1/MCC are exact, not
    batch-averaged). Each batch goes to the params' device; the tail batch
    runs at its own size."""
    tokens, lengths, labels = (np.asarray(x) for x in eval_data)
    n = len(labels)
    if n == 0 or batch_size < 1:
        # fail up front with the contract, not after a full epoch of
        # training (empty --val-* inputs)
        raise ValueError(
            f"evaluate() needs a non-empty eval set (got {n} rows) and "
            f"batch_size >= 1 (got {batch_size})"
        )
    device = params.w_hh_f.device
    eb = min(batch_size, n)
    preds, loss_sum = [], 0.0
    for start in range(0, n, eb):
        sl = slice(start, min(start + eb, n))
        losses, pred = eval_step(params, *_on(device, tokens[sl], lengths[sl],
                                              labels[sl]))
        preds.append(pred)
        loss_sum += float(losses.sum())
    # confusion counts ONCE; the four derived metrics come from the same
    # (tp, fp, tn, fn)
    tp, fp, tn, fn = (
        float(x) for x in confusion_counts(torch.cat(preds).cpu(),
                                           torch.from_numpy(labels))
    )
    eps = 1e-12  # same max(denom, eps) guard as train/metrics.py
    rec = tp / max(tp + fn, eps)
    prec = tp / max(tp + fp, eps)
    denom = ((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)) ** 0.5
    return {
        "loss": loss_sum / n,
        "acc": (tp + tn) / n,
        "recall": rec,
        "precision": prec,
        "F1": 2 * prec * rec / max(prec + rec, eps),
        "mcc": (tp * tn - fp * fn) / max(denom, eps),
    }


def synthetic_dataset(rng, n, max_len=100, motif="GGAACCTTGGAACC"):
    """Labeled toy reads: label 1 iff the motif was planted. The same
    arrays as the JAX package's for the same numpy rng state."""
    from ribodetector_tpu_torch.encode import encode_batch

    motif = motif[: max(1, max_len // 2)]
    # lmin must leave room to place the motif (rng.integers needs high > low)
    lmin = min(max(len(motif) + 2, max_len // 2), max_len)
    lmin = max(lmin, min(len(motif) + 1, max_len))
    seqs, labels = [], []
    bases = np.array(list("ACGT"))
    for i in range(n):
        L = int(rng.integers(lmin, max_len + 1))
        s = "".join(rng.choice(bases, size=L))
        y = int(rng.integers(0, 2))
        if y:
            pos = int(rng.integers(0, max(1, L - len(motif))))
            s = s[:pos] + motif + s[pos + len(motif):]
        seqs.append(s)
        labels.append(y)
    tokens, lengths = encode_batch(seqs, max_len)
    return tokens, lengths, np.asarray(labels, np.int32)


VALID_MONITORS = ("train_loss", "loss", "acc", "recall", "precision", "F1", "mcc")


def fit(
    params: BiLSTMParams,
    data,
    cfg: TrainConfig | None = None,
    *,
    epochs=1,
    batch_size=128,
    device=None,
    grid=None,
    eval_data=None,
    log_fn=print,
    checkpoint_dir=None,
    monitor="mcc",
):
    """Minimal in-memory training loop. data = (tokens, lengths, labels).

    Trains a copy of `params` on `device` (default: the device of params)
    and returns the trained BiLSTMParams (detached). Each epoch takes the
    JAX trainer's batches: the permutation np.random.default_rng(epoch) of
    the rows, in whole batches (the last fractional batch is dropped),
    each gathered on the device from the set put there once. On the card
    the step is graph-ready (make_train_step): one capture per input
    shape and one replay per batch, the update inside it; its graphs are
    freed when fit returns.

    grid: this process's parallel.mesh.Grid (make_grid) in a group of one
    process per device, every rank calling fit with the same arguments.
    Each rank trains its shard_params on its dp rows of every batch
    (batch_size must divide by dp); the logged train_loss is the mean over
    the whole batches, as without a grid. Every rank evaluates the full
    params (gathered over tp) and computes the same metrics; rank 0 alone
    writes the checkpoints, and the others wait at a barrier. Every rank
    returns the full params.

    checkpoint_dir: save an npz artifact per epoch (epoch{NNN}.npz; meta
    carries arch/epoch/batch_size/metrics, mirroring the reference
    checkpoint's keys) plus `best.npz` tracking the best `monitor` metric on
    eval_data (or the train loss without one). Artifacts load with
    models.load_params in either package and export to torch via
    models.convert.
    """
    cfg = cfg or TrainConfig()
    if not isinstance(params, BiLSTMParams):
        raise ValueError(f"fit trains BiLSTMParams only (got {type(params).__name__}: "
                         "a Caduceus is not trained)")
    if int(batch_size) < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    if monitor not in VALID_MONITORS:
        # fail BEFORE an epoch of work
        raise ValueError(f"monitor={monitor!r} not one of {sorted(VALID_MONITORS)}")
    device = torch.device(device) if device is not None else params.w_hh_f.device
    model = BiLSTM(params if grid is None else shard_params(params, grid)).to(device)
    leaves = model.params()
    optimizer = make_optimizer(cfg, model.parameters())
    train_step = make_train_step(cfg, optimizer, grid)
    eval_step = make_eval_step(cfg)

    def whole():
        return leaves if grid is None else gather_params(leaves, grid)

    tokens, lengths, labels = data
    n = len(labels)
    if n == 0:
        raise ValueError("fit() received an empty dataset")
    if batch_size > n:
        # a zero-step epoch would 'train' nothing yet still checkpoint
        log_fn(f"batch_size {batch_size} > dataset size {n}; using {n}")
        batch_size = n
    rows = None
    if grid is not None:
        if batch_size % grid.dp:
            raise ValueError(f"batch_size {batch_size} does not split over dp={grid.dp}")
        rows = batch_sharded(grid.mesh, "dp")
    writer = grid is None or grid.rank == 0
    # the whole training set on the device once; batches are gathered there
    tokens_d, lengths_d, labels_d = _on(device, tokens, lengths, labels)
    try:
        best = None
        for epoch in range(epochs):
            perm = torch.from_numpy(np.random.default_rng(epoch).permutation(n)).to(device)
            losses = []
            for start in range(0, n - batch_size + 1, batch_size):
                idx = perm[start: start + batch_size]
                if rows is not None:
                    idx = rows(idx, grid.dp_index)
                losses.append(train_step(leaves, tokens_d, lengths_d, labels_d, idx))
            losses = torch.stack(losses)
            if grid is not None and grid.dp > 1:
                # each step's loss over the whole batch: the mean of its dp parts
                dist.all_reduce(losses, group=grid.dp_group)
                losses /= grid.dp
            # one host sync an epoch: the mean of the per-step losses
            metrics = {"train_loss": float(losses.double().mean())}
            msg = f"epoch {epoch}: loss {metrics['train_loss']:.4f}"
            full = whole()
            if eval_data is not None:
                with span("train.eval"):
                    m = evaluate(eval_step, full, eval_data)
                metrics.update(m)
                msg += " " + " ".join(f"{k} {v:.4f}" for k, v in m.items())
            log_fn(msg)
            if checkpoint_dir is not None:
                with span("train.checkpoint"):
                    hidden = full.w_hh_f.shape[0]
                    meta = {
                        "arch": f"BiLSTM 4x{hidden}x2 bidirectional",
                        "epoch": epoch,
                        "batch_size": batch_size,
                        "metrics": metrics,
                    }
                    if writer:
                        os.makedirs(checkpoint_dir, exist_ok=True)
                        save_params(os.path.join(checkpoint_dir, f"epoch{epoch:03d}.npz"),
                                    full, meta)
                    if monitor in metrics:
                        # loss-like monitors are minimized; everything else maximized
                        sign = -1.0 if "loss" in monitor else 1.0
                        score = sign * metrics[monitor]
                    else:
                        if eval_data is not None:
                            raise ValueError(
                                f"monitor={monitor!r} not in metrics {sorted(metrics)}"
                            )
                        score = -metrics["train_loss"]
                    if best is None or score > best:
                        best = score
                        if writer:
                            save_params(os.path.join(checkpoint_dir, "best.npz"),
                                        full, meta)
                    if grid is not None:
                        dist.barrier()
    finally:
        # the step's graphs and their memory go back before fit returns
        train_step.release()
    return BiLSTMParams(*(p.detach() for p in whole()))

