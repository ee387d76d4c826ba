"""Segmentation metrics as confusion-matrix accumulators (counterpart of
``beach_seg_tpu/train/metrics.py``), torchmetrics macro-F1 semantics:
pixels whose target is ``ignore_index`` are dropped; per-class F1 is 0 where
its denominator is 0; classes with no support and no predictions are left
out of the macro mean."""

from __future__ import annotations

import torch

from beach_seg_tpu_torch.utils.profiling import host_sync


def confusion_update(pred: torch.Tensor, target: torch.Tensor, num_classes: int, ignore_index: int | None = 0) -> torch.Tensor:
    """(…) int preds/targets → (C, C) int32 confusion matrix [target, pred]."""
    p = pred.reshape(-1).to(torch.int64)
    t = target.reshape(-1).to(torch.int64)
    idx = t * num_classes + p
    if ignore_index is not None:
        with host_sync(idx.device):  # a boolean index waits for its count
            idx = idx[t != ignore_index]
    with host_sync(idx.device):  # bincount waits for the ids' range
        counts = torch.bincount(idx, minlength=num_classes * num_classes)
    return counts.to(torch.int32).reshape(num_classes, num_classes)


def f1_from_confusion(cm: torch.Tensor) -> torch.Tensor:
    """Macro F1 from a (C, C) confusion matrix (torchmetrics semantics)."""
    cm = cm.float()
    tp = torch.diagonal(cm)
    fp = cm.sum(0) - tp
    fn = cm.sum(1) - tp
    denom = 2 * tp + fp + fn
    f1 = torch.where(denom > 0, 2 * tp / denom.clamp(min=1), torch.zeros_like(tp))
    seen = (cm.sum(1) > 0) | (cm.sum(0) > 0)
    n = seen.sum()
    return (f1 * seen).sum() / n.clamp(min=1) if n > 0 else torch.zeros((), device=cm.device)


def iou_from_confusion(cm: torch.Tensor) -> torch.Tensor:
    """Per-class IoU (C,)."""
    cm = cm.float()
    tp = torch.diagonal(cm)
    union = cm.sum(0) + cm.sum(1) - tp
    return torch.where(union > 0, tp / union.clamp(min=1), torch.zeros_like(tp))
