"""Losses by task name (counterpart of ``tpu_sage/train/losses.py``).

All are mean-reduced over the batch and compute in f32 where the reference
casts (cross-entropy and BCE cast the logits to f32 first).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Integer-target softmax CE; targets ``(B,)`` int, logits ``(B, C)``."""
    return F.cross_entropy(logits.float(), targets.long())


def multilabel_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-class sigmoid BCE; targets ``(B, C)`` in {0, 1}."""
    logits = logits.float()
    return F.binary_cross_entropy_with_logits(logits, targets.to(logits.dtype))


def mse(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(preds - targets.to(preds.dtype)))


def mae(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(preds - targets.to(preds.dtype)))


loss_lookup = {
    "classification": cross_entropy,
    "multilabel_classification": multilabel_bce,
    "regression": mse,
    "regression_mae": mae,
}
