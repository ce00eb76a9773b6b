from ribodetector_tpu_torch.train.loss import cross_entropy_loss, nll_loss
from ribodetector_tpu_torch.train.metrics import (
    accuracy,
    recall,
    precision,
    f1,
    mcc,
    confusion_counts,
)
from ribodetector_tpu_torch.train.trainer import (
    TrainConfig,
    make_optimizer,
    make_train_step,
    make_eval_step,
    evaluate,
    fit,
    synthetic_dataset,
)

__all__ = [
    "cross_entropy_loss",
    "nll_loss",
    "accuracy",
    "recall",
    "precision",
    "f1",
    "mcc",
    "confusion_counts",
    "TrainConfig",
    "make_optimizer",
    "make_train_step",
    "make_eval_step",
    "evaluate",
    "fit",
    "synthetic_dataset",
]
