from ribodetector_tpu_torch.runtime.ensure import paired_final_labels
from ribodetector_tpu_torch.runtime.batching import auto_batch_size
from ribodetector_tpu_torch.runtime.pipeline import Predictor

__all__ = [
    "paired_final_labels",
    "auto_batch_size",
    "Predictor",
]
