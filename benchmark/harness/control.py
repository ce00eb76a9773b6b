"""The control: the plain reference, computed at the precision just below
the float32 that every configuration states (TF32 products,
``reference/model.py``), put in the program's place under the timed path,
so that a whole run of the cell (``core.run_cell``) judges it by the
cell's own check. ``benchmark/tests/test_bench_control.py`` runs it; the
benchmark's measured runs never do.

What is swapped: the program's classify calls (``ops.classify_logits``:
the detect path's kernels, and training's eval) return the reference's
logits of the same tokens at full length, and the train step's forward and
backward (``trainer._loss_fn``) are the reference's. What the program does
around them (parse, bucketing, ensure, write; the graphed step, Adam,
checkpoints) runs as it is. The weights are the program's leaves as it
holds them, in the reference's field order.
"""

from contextlib import ExitStack, contextmanager

from harness.hooks import patched
from reference import model as ref


@contextmanager
def reference_in_place(max_len, precision="tf32"):
    import torch

    import ribodetector_tpu_torch.ops as ops
    import ribodetector_tpu_torch.ops.dispatch as dispatch
    from ribodetector_tpu_torch.train import trainer

    def weights(params):
        return {k: v.float() for k, v in zip(ref.FIELDS, params)}

    def classify_logits(params, tokens, *a, **kw):
        full = torch.full((tokens.shape[0], max_len), ref.PAD, dtype=tokens.dtype,
                          device=tokens.device)
        full[:, : tokens.shape[1]] = tokens
        with torch.no_grad():
            return ref.forward(weights(params), full, precision)

    def loss_fn(params, tokens, lengths, labels, *a, **kw):
        logits = ref.forward(dict(zip(ref.FIELDS, params)), tokens, precision)
        return ref.cross_entropy(logits, labels), logits

    with ExitStack() as stack:
        for owner in (ops, dispatch):
            stack.enter_context(patched(owner, "classify_logits", classify_logits))
        stack.enter_context(patched(trainer, "_loss_fn", loss_fn))
        yield
