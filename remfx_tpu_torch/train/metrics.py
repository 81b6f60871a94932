"""Classification metrics (``remfx_tpu/train/metrics.py``): binary
accuracy and multilabel F1, per class and macro — the torchmetrics
surface the reference uses (remfx/models.py:445-488)."""

from __future__ import annotations

import torch


def binary_accuracy(probs, targets, threshold: float = 0.5):
    return ((probs > threshold) == (targets > threshold)).float().mean()


def multilabel_f1(probs, targets, threshold: float = 0.5, average: str | None = None):
    """probs/targets: (N, C). average=None -> per-class (C,); "macro" ->
    scalar mean. Matches torchmetrics MultilabelF1Score (global multidim)."""
    preds = probs > threshold
    t = targets > 0.5
    tp = (preds & t).sum(0).float()
    fp = (preds & ~t).sum(0).float()
    fn = (~preds & t).sum(0).float()
    denom = 2 * tp + fp + fn
    f1 = torch.where(denom > 0, 2 * tp / torch.clamp(denom, min=1e-12),
                     torch.zeros_like(denom))
    if average == "macro":
        return f1.mean()
    return f1
