"""The port's captured train step against its eager step on the card.

On the card at tp = 1 the train step captures its forward and backward
once per input shape as a CUDA graph and replays it every step
(train/trainer.py, TrainStep); tests/test_torch_train_graph.py holds the
graph-ready body against the eager step on the CPU. These tests need a
CUDA card and skip without one; they import neither jax nor the JAX
package, and need none of tests/conftest.py:

    python3 -m pytest --noconftest -q tests/test_torch_card_*.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import ribodetector_tpu_torch
from ribodetector_tpu_torch.models import bilstm as tb
from ribodetector_tpu_torch.train import trainer as tt

NPZ = Path(ribodetector_tpu_torch.__file__).resolve().parent / "data" / "ribodetector_v1.npz"
LR = 5e-3

# the condition is a string: pytest evaluates it when each test is set up,
# not when the module is imported
pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")]


def _assert_same_params(a, b):
    for name, x, y in zip(tb.BiLSTMParams._fields, a, b):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("semantics,compute_dtype,T", [
    ("dense", "float32", 100), ("packed", "float32", 100), ("dense", "bfloat16", 100),
    ("dense", "float32", 40)])
def test_captured_step_matches_eager_on_card(semantics, compute_dtype, T):
    """On the card at batch 200: the captured graph (one capture, a replay
    a step) against the eager step over 12 batches, bit for bit (the same
    kernels in the same order); fit frees its graph when it returns."""
    tok, lengths, labels = (torch.from_numpy(x).cuda() for x in tt.synthetic_dataset(
        np.random.default_rng(2), 12 * 200, max_len=T))
    labels = labels.long()
    cfg = tt.TrainConfig(learning_rate=LR, semantics=semantics, compute_dtype=compute_dtype)
    got = {}
    for graph in (False, None):
        model = tb.BiLSTM(tb.load_params(str(NPZ), "cuda"))
        step = tt.make_train_step(cfg, tt.make_optimizer(cfg, model.parameters()), graph=graph)
        tt.reset_step_counts()
        losses = [step(model.params(), tok, lengths, labels,
                       torch.arange(i, i + 200, device="cuda")) for i in range(0, 2400, 200)]
        step.release()
        got[graph] = (torch.stack(losses).cpu(), [p.detach().cpu() for p in model.params()],
                      tt.step_counts())
    assert torch.equal(got[None][0], got[False][0])
    _assert_same_params(got[None][1], got[False][1])
    assert got[None][2] == {"captures": 1, "replays": 12, "eager": 0, "released": 1}
    assert got[False][2]["eager"] == 12
