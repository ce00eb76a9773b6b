"""Paired-end ensure-mode reconciliation, vectorized.

Truth-table parity with the reference (reference: ribodetector/detect.py:600-663,
numpy twin detect_cpu.py:617-684). Label 0 = non-rRNA, 1 = rRNA (quirk #10);
-1 marks discordant pairs under ensure="both" (written to
`<output>.unclassified.gz`, quirk #5).

The reference loops read-by-read in Python; here the decision is one
vectorized expression over the batch logits (numpy, or torch on the
device).
"""

import numpy as np

ENSURE_MODES = ("rrna", "norrna", "both", "none")


def paired_final_labels(r1_logits, r2_logits, ensure: str):
    """Final per-pair labels from the two ends' [B, 2] logits.

    - "rrna":   1 iff both ends argmax to 1, else 0 (detect.py:620-630)
    - "norrna": 0 iff both ends argmax to 0, else 1 (detect.py:631-641)
    - "both":   concordant label, else -1            (detect.py:642-654)
    - "none":   argmax(r1_logits + r2_logits) -- raw logit SUM, not mean of
                probabilities (quirk #4, detect.py:657)
    """
    r1_logits = np.asarray(r1_logits)
    r2_logits = np.asarray(r2_logits)
    if ensure == "none" or ensure is None:
        return np.argmax(r1_logits + r2_logits, axis=1).astype(np.int64)
    a1 = np.argmax(r1_logits, axis=1)
    a2 = np.argmax(r2_logits, axis=1)
    if ensure == "rrna":
        return np.where((a1 == 1) & (a2 == 1), 1, 0).astype(np.int64)
    if ensure == "norrna":
        return np.where((a1 == 0) & (a2 == 0), 0, 1).astype(np.int64)
    if ensure == "both":
        return np.where(a1 == a2, a1, -1).astype(np.int64)
    raise ValueError(f"unknown ensure mode: {ensure}")


def paired_final_labels_torch(r1_logits, r2_logits, ensure: str):
    """Device-side (torch) twin of paired_final_labels: lets the native
    runtime reconcile pairs on the card and ship back one int8 label per
    pair instead of [2B, 2] fp32 logits (8x less device->host traffic)."""
    import torch

    if ensure == "none" or ensure is None:
        return torch.argmax(r1_logits + r2_logits, dim=1).to(torch.int8)
    a1 = torch.argmax(r1_logits, dim=1)
    a2 = torch.argmax(r2_logits, dim=1)
    if ensure == "rrna":
        return ((a1 == 1) & (a2 == 1)).to(torch.int8)
    if ensure == "norrna":
        return ((a1 == 1) | (a2 == 1)).to(torch.int8)
    if ensure == "both":
        return torch.where(a1 == a2, a1, torch.full_like(a1, -1)).to(torch.int8)
    raise ValueError(f"unknown ensure mode: {ensure}")
