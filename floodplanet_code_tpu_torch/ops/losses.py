"""Segmentation losses: the port of ``floodplanet_code_tpu/ops/losses.py``.

Logits come in NCHW, ``[B, n_classes, H, W]`` (the JAX package's are NHWC);
targets are integer class maps ``[B, H, W]``. Every loss is computed in f32
and drops the pixels whose target is ``ignore_index`` or lies outside
``[0, n_classes)`` (e.g. the raw -1 nodata sentinel), and is 0, not NaN,
when no pixel is left.

``group``: the losses of a data-parallel step (``parallel/shard_step.py``).
Each rank holds its rows of the batch; the sums a loss divides (numerator,
pixel count or weight, Dice's intersection and union) are summed over the
group through ``global_with_local_grad`` (``group=None``: no sum), so every rank gets the loss of the
whole batch, exactly, even when ranks hold unequal numbers of ignored
pixels (JAX ``ops/losses.py:73-76``), and its backward reaches only this
rank's pixels. The step sums the gradients over the group once.
"""

from __future__ import annotations

import torch

from floodplanet_code_tpu_torch.parallel.collectives import global_with_local_grad


def _global(local: torch.Tensor, group) -> torch.Tensor:
    """``local`` summed over ``group`` (None: this rank alone), with the
    gradient of ``local``."""
    return local if group is None else global_with_local_grad(local, group)


def _valid_and_target(logits, target, ignore_index, sample_weight):
    """(f32 weight per pixel, target clipped into range) (losses.py:58-69)."""
    n_classes = logits.shape[1]
    valid = torch.ones(target.shape, dtype=torch.float32, device=target.device)
    if sample_weight is not None:
        valid = valid * torch.broadcast_to(sample_weight, target.shape).float()
    if ignore_index is not None:
        valid = valid * (target != ignore_index).float()
    valid = valid * ((target >= 0) & (target < n_classes)).float()
    return valid, target.clamp(0, n_classes - 1).long()


def _pick(values: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """values[b, target[b, h, w], h, w] for NCHW values: each class's plane
    where it is the target, summed over the classes (one term is not zero,
    so the sum is exact). Its gradient is a select as well: under
    deterministic algorithms (the fit) a ``gather``'s backward is a sorted
    scatter (PERF.md)."""
    classes = torch.arange(values.shape[1], device=values.device).view(1, -1, 1, 1)
    return torch.where(target.unsqueeze(1) == classes, values, 0.0).sum(1)


def cross_entropy_ignore(
    logits: torch.Tensor,
    target: torch.Tensor,
    ignore_index: int | None = None,
    sample_weight: torch.Tensor | None = None,
    group=None,
) -> torch.Tensor:
    """Mean softmax cross entropy over the pixels that count.

    logits: [B, C, H, W] (NCHW); target: [B, H, W] int; ``sample_weight``:
    an optional 0/1 weight broadcastable to target (the batch padding mask).
    """
    log_probs = torch.log_softmax(logits.float(), dim=1)
    valid, safe = _valid_and_target(logits, target, ignore_index, sample_weight)
    picked = _pick(log_probs, safe)
    total = _global(valid.sum(), group)
    numerator = _global(-(picked * valid).sum(), group)
    loss = numerator / torch.clamp_min(total, 1.0)
    return torch.where(total > 0, loss, torch.zeros_like(loss))


def weighted_cross_entropy(
    logits: torch.Tensor,
    target: torch.Tensor,
    class_weights: torch.Tensor,
    ignore_index: int | None = None,
    sample_weight: torch.Tensor | None = None,
    group=None,
) -> torch.Tensor:
    """CE with per-class weights, normalized by the summed weights of the
    pixels that count (torch CrossEntropyLoss(weight=...) semantics).
    logits NCHW."""
    log_probs = torch.log_softmax(logits.float(), dim=1)
    valid, safe = _valid_and_target(logits, target, ignore_index, sample_weight)
    picked = _pick(log_probs, safe)
    weights = torch.as_tensor(class_weights, dtype=torch.float32, device=logits.device)
    w = weights[safe] * valid
    total_w = _global(w.sum(), group)
    numerator = _global(-(picked * w).sum(), group)
    loss = numerator / torch.clamp_min(total_w, 1e-8)
    return torch.where(total_w > 0, loss, torch.zeros_like(loss))


def dice_loss(
    logits: torch.Tensor,
    target: torch.Tensor,
    ignore_index: int | None = None,
    sample_weight: torch.Tensor | None = None,
    eps: float = 1.0,
    group=None,
) -> torch.Tensor:
    """Soft multi-class Dice loss over the pixels that count. logits NCHW."""
    n_classes = logits.shape[1]
    probs = torch.softmax(logits.float(), dim=1)
    valid, safe = _valid_and_target(logits, target, ignore_index, sample_weight)
    onehot = torch.nn.functional.one_hot(safe, n_classes).permute(0, 3, 1, 2).float()
    onehot = onehot * valid.unsqueeze(1)
    probs = probs * valid.unsqueeze(1)
    axes = (0, 2, 3)
    intersection = _global((probs * onehot).sum(dim=axes), group)
    union = _global(probs.sum(dim=axes) + onehot.sum(dim=axes), group)
    dice = (2.0 * intersection + eps) / (union + eps)
    return 1.0 - dice.mean()
