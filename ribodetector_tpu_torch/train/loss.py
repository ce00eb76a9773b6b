"""Training losses (counterpart of the reference's model/loss.py:4-9)."""

import torch


def nll_loss(log_probs, labels):
    """Mean negative log likelihood of already-log-softmaxed outputs."""
    return -torch.gather(log_probs, 1, labels.long()[:, None]).mean()


def cross_entropy_loss(logits, labels):
    """Mean softmax cross entropy from raw logits (torch F.cross_entropy)."""
    return nll_loss(torch.log_softmax(logits, dim=-1), labels)
