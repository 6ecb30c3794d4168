"""Segmentation metrics from a confusion matrix: the port of
``floodplanet_code_tpu/ops/metrics.py``.

``confusion_from_*`` return an f32 ``[C, C]`` matrix, rows = target, columns
= prediction, additive across steps. Pixels whose target is
``ignore_index`` or outside ``[0, C)`` are dropped; a prediction of the
ignored class on a counted pixel still counts as an error. The metrics
follow torchmetrics' micro averaging (see ``compute_metrics``). Logits are
NCHW.
"""

from __future__ import annotations

import torch


def confusion_from_preds(
    preds: torch.Tensor,
    target: torch.Tensor,
    n_classes: int,
    ignore_index: int | None = None,
    sample_weight: torch.Tensor | None = None,
) -> torch.Tensor:
    """Confusion matrix [n_classes, n_classes] (rows=target, cols=pred).

    ``sample_weight``: optional 0/1 weight broadcastable to target (the
    batch padding mask); weight 0 drops the pixel.
    """
    valid = torch.ones(target.shape, dtype=torch.float32, device=target.device)
    if sample_weight is not None:
        valid = valid * torch.broadcast_to(sample_weight, target.shape).float()
    preds, target, valid = preds.reshape(-1), target.reshape(-1), valid.reshape(-1)
    if ignore_index is not None:
        valid = valid * (target != ignore_index).float()
    valid = valid * ((target >= 0) & (target < n_classes)).float()
    t = target.clamp(0, n_classes - 1).long()
    p = preds.clamp(0, n_classes - 1).long()
    # Weighted counts of 0/1 weights are exact integers in f32 up to 2^24
    # pixels per cell.
    cells = torch.zeros(n_classes * n_classes, dtype=torch.float32, device=valid.device)
    cells.index_add_(0, t * n_classes + p, valid)
    return cells.view(n_classes, n_classes)


def confusion_from_logits(
    logits: torch.Tensor,
    target: torch.Tensor,
    ignore_index: int | None = None,
    sample_weight: torch.Tensor | None = None,
) -> torch.Tensor:
    """Confusion matrix from NCHW logits [B, n_classes, H, W]."""
    return confusion_from_preds(
        logits.argmax(dim=1), target, logits.shape[1], ignore_index, sample_weight
    )


def compute_metrics(
    confusion: torch.Tensor, prefix: str = "", ignore_index: int | None = None
) -> dict:
    """Micro-averaged multiclass F1 / Jaccard (IoU) / Accuracy.

    F1 == Accuracy == trace / total. The Jaccard index follows torchmetrics'
    ``_jaccard_index_reduce``: per class num = TP, denom = row + col - TP,
    both zeroed for ``ignore_index`` when it names a class; micro =
    sum(num) / sum(denom). An empty matrix gives 0, not NaN.
    """
    correct = torch.trace(confusion)
    total = confusion.sum()
    zero = torch.zeros_like(total)
    accuracy = torch.where(total > 0, correct / torch.clamp_min(total, 1.0), zero)
    num = torch.diag(confusion).clone()
    denom = confusion.sum(dim=0) + confusion.sum(dim=1) - num
    if ignore_index is not None and 0 <= ignore_index < confusion.shape[0]:
        num[ignore_index] = 0.0
        denom[ignore_index] = 0.0
    num_sum, denom_sum = num.sum(), denom.sum()
    iou = torch.where(denom_sum > 0, num_sum / torch.clamp_min(denom_sum, 1.0), zero)
    return {
        prefix + "F1Score": accuracy,
        prefix + "JaccardIndex": iou,
        prefix + "Accuracy": accuracy,
    }


def compute_binary_class_metrics(
    confusion: torch.Tensor, positive_class: int = 1, prefix: str = ""
) -> dict:
    """Per-class (water) precision / recall / F1 / IoU from the matrix."""
    tp = confusion[positive_class, positive_class]
    fp = confusion[:, positive_class].sum() - tp
    fn = confusion[positive_class, :].sum() - tp
    zero = torch.zeros_like(tp)

    def ratio(num, den):
        return torch.where(den > 0, num / torch.clamp_min(den, 1.0), zero)

    return {
        prefix + "water_precision": ratio(tp, tp + fp),
        prefix + "water_recall": ratio(tp, tp + fn),
        prefix + "water_F1": ratio(2 * tp, 2 * tp + fp + fn),
        prefix + "water_IoU": ratio(tp, tp + fp + fn),
    }


def torchmetrics_key_names(prefix: str) -> dict:
    """Our metric keys -> the reference's torchmetrics names (checkpoints
    monitor ``val_MulticlassJaccardIndex``; metrics.json uses
    ``test_Multiclass*``)."""
    return {
        prefix + "F1Score": prefix + "MulticlassF1Score",
        prefix + "JaccardIndex": prefix + "MulticlassJaccardIndex",
        prefix + "Accuracy": prefix + "MulticlassAccuracy",
    }
