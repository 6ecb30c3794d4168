"""Training and evaluation steps: the port of the step builders of
``floodplanet_code_tpu/train/fit.py``.

- ``make_augment_step``: on-device flips + rotation as its own step, the
  way ``fit_model`` runs it before every train step.
- ``make_train_step``: [augment ->] forward -> loss -> backward ->
  optimizer update (BatchNorm running statistics move in the forward) ->
  EMA -> confusion matrix. It updates the state in place.
- ``make_eval_step``: loss and confusion of a batch with padded rows
  (``valid`` = 0) masked out, on the EMA parameters when the state has them.

Batches are dicts of tensors in the loader's layout: ``image`` [B,H,W,C],
``target`` [B,H,W] int, ``valid`` [B] bool, optional aux rasters
[B,H,W,c]. ``fit_model`` (the epoch loop, checkpoints, TensorBoard, the
device cache) is not ported yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from floodplanet_code_tpu_torch.data.augment import TransformParams, augment_batch
from floodplanet_code_tpu_torch.models.water_seg import AUX_FEATURE_KEYS
from floodplanet_code_tpu_torch.ops.losses import (
    cross_entropy_ignore,
    dice_loss,
    weighted_cross_entropy,
)
from floodplanet_code_tpu_torch.ops.metrics import confusion_from_logits
from floodplanet_code_tpu_torch.train.state import TrainState, ema_decay_at


def resolve_ignore_index(ignore_index: int, n_classes: int) -> int:
    """-1 sentinel -> last class (reference water_seg_model.py:35-36)."""
    if ignore_index == -1:
        return n_classes - 1
    return ignore_index


def make_loss_fn(loss_cfg, ignore_index: int):
    """Loss factory: ce | weighted_ce | ce_dice (conf key ``loss``);
    returns loss(logits NCHW, target)."""
    name = "ce"
    class_weights = None
    dice_weight = 0.5
    if loss_cfg is not None:
        name = loss_cfg.get("name", "ce") if hasattr(loss_cfg, "get") else "ce"
        class_weights = loss_cfg.get("class_weights")
        dice_weight = float(loss_cfg.get("dice_weight", 0.5) or 0.5)
    weights = (
        torch.tensor([float(w) for w in class_weights], dtype=torch.float32)
        if class_weights is not None
        else None
    )
    if name == "ce":
        return lambda logits, target: cross_entropy_ignore(logits, target, ignore_index)
    if name == "weighted_ce":
        if weights is None:
            raise ValueError("loss.name=weighted_ce requires loss.class_weights")
        return lambda logits, target: weighted_cross_entropy(
            logits, target, weights, ignore_index
        )
    if name == "ce_dice":

        def ce_dice(logits, target):
            if weights is not None:
                ce = weighted_cross_entropy(logits, target, weights, ignore_index)
            else:
                ce = cross_entropy_ignore(logits, target, ignore_index)
            return ce + dice_weight * dice_loss(logits, target, ignore_index)

        return ce_dice
    raise NotImplementedError(f'No implementation for loss "{name}"')


def _model_batch(batch: dict, image: torch.Tensor) -> dict:
    """The model's NCHW inputs (views of the NHWC batch tensors)."""
    out = {"image": image.permute(0, 3, 1, 2)}
    for key in AUX_FEATURE_KEYS:
        if key in batch:
            out[key] = batch[key].permute(0, 3, 1, 2)
    return out


def make_augment_step(transform_params: TransformParams, ignore_index: int):
    """``augment_step(generator, batch) -> batch`` with ``image`` and
    ``target`` augmented (a new dict; the input batch is left as it is), or
    None when no transform is active."""
    if not transform_params.any_active:
        return None

    def augment_step(generator: torch.Generator, batch: dict) -> dict:
        image, target = augment_batch(
            generator, batch["image"], batch["target"], transform_params, ignore_index
        )
        out = dict(batch)
        out["image"] = image
        out["target"] = target
        return out

    return augment_step


def make_train_step(
    model,
    ignore_index: int,
    transform_params: TransformParams,
    loss_cfg=None,
    fuse_augmentation: bool = True,
    ema_decay: float = 0.0,
    ema_warmup: bool = True,
):
    """Build ``train_step(state, batch, generator) -> (state, logs)`` for
    a ``state`` made by ``create_train_state(model, ...)``.

    The step UPDATES ``state`` IN PLACE (the model's parameters and
    running statistics, the optimizer's moments, ``state.step``, the EMA)
    and returns the same object; ``logs`` holds the scalar ``loss`` and
    the batch's [C, C] ``confusion`` (additive across steps).
    ``fuse_augmentation`` augments inside the step with ``generator``;
    ``fit_model`` runs ``make_augment_step`` before the step instead.
    With ``state.ema_params``, they move as ``d*ema + (1-d)*params`` after
    the update, ``d`` warmed up by ``ema_decay_at`` unless ``ema_warmup``
    is off.
    """
    loss_of = make_loss_fn(loss_cfg, ignore_index)

    def train_step(state: TrainState, batch: dict, generator: torch.Generator | None = None):
        image, target = batch["image"], batch["target"]
        if fuse_augmentation and transform_params.any_active:
            image, target = augment_batch(
                generator, image, target, transform_params, ignore_index
            )
        model.train()
        logits = model(_model_batch(batch, image))
        loss = loss_of(logits, target)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        lr = state.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        if state.ema_params is not None:
            d = ema_decay_at(state.step, ema_decay) if ema_warmup else torch.tensor(
                ema_decay, dtype=torch.float32
            )
            with torch.no_grad():
                for name, p in model.named_parameters():
                    e = state.ema_params[name]
                    dd = d.to(e.device)
                    e.copy_(dd * e + (1.0 - dd) * p)
        with torch.no_grad():
            confusion = confusion_from_logits(logits, target, ignore_index)
        return state, {"loss": loss.detach(), "confusion": confusion}

    return train_step


def make_eval_step(model, ignore_index: int):
    """``eval_step(state, batch) -> {"loss", "confusion"}``: the eval-mode
    forward under inference mode (on the EMA parameters when present),
    with the rows whose ``valid`` is False dropped. The model's train/eval
    mode is restored afterwards."""

    def eval_step(state: TrainState, batch: dict) -> dict:
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode():
                inputs = _model_batch(batch, batch["image"])
                if state.ema_params is not None:
                    logits = functional_call(model, state.ema_params, (inputs,))
                else:
                    logits = model(inputs)
                valid = batch["valid"].float()[:, None, None]
                target = batch["target"]
                return {
                    "loss": cross_entropy_ignore(logits, target, ignore_index,
                                                 sample_weight=valid),
                    "confusion": confusion_from_logits(logits, target, ignore_index,
                                                       sample_weight=valid),
                }
        finally:
            model.train(was_training)

    return eval_step
