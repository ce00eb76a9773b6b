"""The port's kernel choice on the card (the Predictor's decision for a
custom-width checkpoint). Needs a CUDA card and skips without one; imports
neither jax nor the JAX package, and needs none of tests/conftest.py:

    python3 -m pytest --noconftest -q tests/test_torch_card_*.py
"""

import json

import pytest
import torch

from ribodetector_tpu_torch.models import bilstm as tb

# the condition is a string: pytest evaluates it when each test is set up,
# not when the module is imported
pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")]


def test_custom_width_predictor_on_card(tmp_path):
    """The whole Predictor decision on the card for a hidden-64 checkpoint:
    kernel plain, recorded as such, no probe and no kernel launch; an
    explicit --kernel cuda refuses the width."""
    from ribodetector_tpu_torch.cli import build_arg_parser
    from ribodetector_tpu_torch.config import DEFAULT_CONFIG, ConfigParser
    from ribodetector_tpu_torch.ops import lstm_cuda
    from ribodetector_tpu_torch.runtime import Predictor
    from ribodetector_tpu_torch.runtime.native_pipeline import resolved_kernel

    npz = str(tmp_path / "h64.npz")
    tb.save_params(npz, tb.init_params(torch.Generator().manual_seed(0), hidden=64))
    with open(DEFAULT_CONFIG) as fh:
        cfg = json.load(fh)
    cfg["state_file"] = {"mcc": npz, "recall": npz}
    args = build_arg_parser().parse_args(["-l", "50", "-i", "x.fq", "-o", "y.fq"])
    lstm_cuda.reset_launches()
    p = Predictor(ConfigParser(cfg), args, device="cuda")
    p.load_model()
    assert p.kernel == "plain" and p.device.type == "cuda"
    assert resolved_kernel(p)["kernel"] == "plain"
    assert not lstm_cuda.LAUNCH_COUNTS
    cfg["runtime"]["kernel"] = "cuda"
    with pytest.raises(ValueError, match="hidden width 128 only"):
        Predictor(ConfigParser(cfg), args, device="cuda").load_model()
