"""Classification metrics.

Counterpart of the reference's model/metric.py:5-82 with the same metric set
(accuracy / recall / precision / F1 / MCC, positive class = label 1 = rRNA).
NOTE: the reference's F1() and mcc() return the wrong tuple indices
(metric.py:77-82 index pr[2]/pr[3] of a 3-tuple slice); these are the
corrected formulas, the same as the JAX package's, with the same eps guards.
"""

import torch


def confusion_counts(pred_labels, labels):
    """(tp, fp, tn, fn) with positive class = 1, as int64 tensors."""
    pos = labels == 1
    pred_pos = pred_labels == 1
    tp = torch.sum(pos & pred_pos)
    fp = torch.sum(~pos & pred_pos)
    tn = torch.sum(~pos & ~pred_pos)
    fn = torch.sum(pos & ~pred_pos)
    return tp, fp, tn, fn


def accuracy(pred_labels, labels):
    return torch.mean((pred_labels == labels).to(torch.float32))


def recall(pred_labels, labels, eps=1e-12):
    tp, fp, tn, fn = confusion_counts(pred_labels, labels)
    return tp / torch.clamp(tp + fn, min=eps)


def precision(pred_labels, labels, eps=1e-12):
    tp, fp, tn, fn = confusion_counts(pred_labels, labels)
    return tp / torch.clamp(tp + fp, min=eps)


def f1(pred_labels, labels, eps=1e-12):
    p = precision(pred_labels, labels)
    r = recall(pred_labels, labels)
    return 2 * p * r / torch.clamp(p + r, min=eps)


def mcc(pred_labels, labels, eps=1e-12):
    tp, fp, tn, fn = (x.to(torch.float32)
                      for x in confusion_counts(pred_labels, labels))
    num = tp * tn - fp * fn
    den = torch.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    return num / torch.clamp(den, min=eps)
