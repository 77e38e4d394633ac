"""Metrics by task, computed on the device (counterpart of
``tpu_sage/train/metrics.py``). For single-label tasks micro-F1 equals
accuracy, which is what is reported there."""

from __future__ import annotations

import torch


def accuracy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == targets.long()).float().mean()


def multilabel_micro_f1(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Micro-F1 over thresholded logits (> 0 ⇔ sigmoid > 0.5)."""
    preds = (logits > 0).float()
    t = targets.float()
    tp = torch.sum(preds * t)
    fp = torch.sum(preds * (1.0 - t))
    fn = torch.sum((1.0 - preds) * t)
    return 2.0 * tp / torch.clamp(2.0 * tp + fp + fn, min=1e-12)


def neg_mse(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return -torch.mean(torch.square(preds - targets.to(preds.dtype)))


def neg_mae(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return -torch.mean(torch.abs(preds - targets.to(preds.dtype)))


metric_lookup = {
    "classification": accuracy,
    "multilabel_classification": multilabel_micro_f1,
    "regression": neg_mse,
    "regression_mae": neg_mae,
}
