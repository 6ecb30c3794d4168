"""Training entry point and steps: the port of
``floodplanet_code_tpu/train/fit.py``.

- ``fit_model(cfg)``: the epoch loop on one device (reference fit.py:16-103):
  datasets and loaders, the model, the train state, resume from the
  latest checkpoint, per epoch the augment step then the train step over
  the HBM scene cache (``data/device_cache.py``) or the host loader,
  validation, TensorBoard scalars and image panels, top-k checkpoints
  (``train/checkpoint.py``) and ``timing.json``; returns the best
  checkpoint's path.
- ``make_augment_step``: on-device flips + rotation as its own step, the
  way ``fit_model`` runs it before every train step.
- ``make_train_step``: [augment ->] forward -> loss -> backward ->
  optimizer update (BatchNorm running statistics move in the forward) ->
  EMA -> confusion matrix. It updates the state in place.
- ``make_eval_step``: loss and confusion of a batch with padded rows
  (``valid`` = 0) masked out, on the EMA parameters when the state has them.

Batches are dicts of tensors in the loader's layout: ``image`` [B,H,W,C],
``target`` [B,H,W] int, ``valid`` [B] bool, optional aux rasters
[B,H,W,c]. The JAX package's flat-packed step (``train/flat.py``) computes
the same function as ``make_train_step`` and is not carried over.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import json
import os
import time

import numpy as np
import torch
from torch.func import functional_call

from floodplanet_code_tpu_torch.config import Config, save_config
from floodplanet_code_tpu_torch.data import (
    BatchLoader,
    build_dataset,
    device_prefetch,
    generate_image_slice_object,
)
from floodplanet_code_tpu_torch.data.augment import TransformParams, augment_batch
from floodplanet_code_tpu_torch.data.device_cache import (
    build_device_cache,
    cache_batches,
)
from floodplanet_code_tpu_torch.device import resolve_device
from floodplanet_code_tpu_torch.models import build_model, resolve_conv_impl
from floodplanet_code_tpu_torch.models.water_seg import AUX_FEATURE_KEYS
from floodplanet_code_tpu_torch.ops.losses import (
    cross_entropy_ignore,
    dice_loss,
    weighted_cross_entropy,
)
from floodplanet_code_tpu_torch.ops.metrics import (
    compute_binary_class_metrics,
    compute_metrics,
    confusion_from_logits,
    torchmetrics_key_names,
)
from floodplanet_code_tpu_torch.train.checkpoint import MONITOR_KEY, CheckpointManager
from floodplanet_code_tpu_torch.train.logging import log_image_panel, open_writer
from floodplanet_code_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    ema_decay_at,
    init_weights,
)


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
            # One non-blocking copy: a blocking one per parameter would wait
            # for the stream each time.
            d = d.to(loss.device, non_blocking=True)
            with torch.no_grad():
                for name, p in model.named_parameters():
                    e = state.ema_params[name]
                    e.copy_(d * e + (1.0 - d) * p)
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


def _steps_per_epoch(cfg, train_dataset, batch_size: int) -> int:
    """Train steps per epoch: drop_last batching, limit_train_batches cap."""
    steps = max(1, len(train_dataset) // batch_size)
    limit = int(cfg.select("limit_train_batches") or 0)
    return min(steps, limit) if limit else steps


def default_experiment_dir(cfg: Config) -> str:
    pattern = cfg.select("run.dir", "./outputs/{date}/{name}/")
    name = cfg.select("run.name", "default")
    return pattern.format(date=datetime.date.today().isoformat(), name=name)


def _check_single_device(cfg) -> None:
    """Raise NotImplementedError for the settings that need more than one
    device or process, which the port has not reached yet."""
    later = "needs more than one device, not ported yet (ROADMAP.md Queue 1 item 5)"
    n_devices = cfg.select("tpu.n_devices")
    if n_devices is not None and int(n_devices) > 1:
        raise NotImplementedError(f"tpu.n_devices={n_devices} {later}")
    spatial = int(cfg.select("tpu.spatial_shards", 1) or 1)
    if spatial > 1:
        raise NotImplementedError(f"tpu.spatial_shards={spatial} {later}")
    spmd_impl = cfg.select("tpu.spmd_impl", "gspmd") or "gspmd"
    if spmd_impl != "gspmd":
        raise NotImplementedError(f"tpu.spmd_impl={spmd_impl} {later}")
    multihost = cfg.select("tpu.multihost") or {}
    if multihost.get("coordinator_address") or int(multihost.get("num_processes") or 1) > 1:
        raise NotImplementedError(f"a tpu.multihost cluster {later}")
    if cfg.select("tpu.device_cache_shard", "auto") == "pod":
        raise NotImplementedError(f"tpu.device_cache_shard=pod {later}")
    if cfg.select("tpu.debug_nans", False):
        raise NotImplementedError("tpu.debug_nans (jax_debug_nans) is not ported")


def _epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The augmentation generator of one epoch, a pure function of (seed,
    epoch) as ``fold_in(key(seed), epoch)`` is in the JAX package: a resumed
    fit replays the uninterrupted run's draws."""
    state = np.random.SeedSequence((int(seed), int(epoch))).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fit_model(
    cfg: Config,
    overwrite_exp_dir: str | None = None,
    device="cuda",
    init_state_dict: dict | None = None,
) -> str:
    """Train on one device; returns the best checkpoint path (reference
    fit.py:16-103, JAX ``train/fit.py:263-938``).

    ``init_state_dict``: start from these weights (a state dict, e.g. the
    JAX package's initial parameters through ``state_dict_from_flax``)
    instead of ``init_weights(model, seed_num)``. Raises without a card
    unless ``device="cpu"``, and for settings that need more than one
    device (``_check_single_device``).
    """
    device = resolve_device(device)
    _check_single_device(cfg)
    # Wall-clock decomposition of the whole fit, written to
    # <exp_dir>/timing.json with the JAX package's keys.
    fit_start = time.time()
    timing_epochs: list[dict] = []

    exp_dir = overwrite_exp_dir or default_experiment_dir(cfg)
    os.makedirs(exp_dir, exist_ok=True)
    save_config(cfg, exp_dir)

    slice_params = generate_image_slice_object(
        cfg.crop_height, cfg.crop_width, cfg.crop_stride
    )
    common = dict(
        sensor=cfg.dataset.sensor,
        channels=cfg.dataset.channels,
        norm_mode=cfg.norm_mode,
        eval_region=cfg.eval_region,
        ignore_index=cfg.ignore_index,
        seed_num=cfg.seed_num,
        train_split_pct=cfg.train_split_pct,
        **(cfg.dataset.get("dataset_kwargs") or {}),
    )
    train_dataset = build_dataset(cfg.dataset.name, "train", slice_params, **common)
    valid_dataset = build_dataset(cfg.dataset.name, "valid", slice_params, **common)
    n_classes = train_dataset.n_classes
    ignore_index = resolve_ignore_index(cfg.ignore_index, n_classes)
    batch_size = int(cfg.batch_size)
    seed = cfg.seed_num or 0

    train_loader = BatchLoader(train_dataset, batch_size=batch_size, shuffle=True,
                               n_workers=cfg.n_workers, drop_last=True, seed=cfg.seed_num)
    valid_loader = BatchLoader(valid_dataset, batch_size=batch_size, shuffle=False,
                               n_workers=cfg.n_workers, drop_last=False, pad_final=True)

    compute_dtype = cfg.select("tpu.compute_dtype", "bfloat16")
    model = build_model(
        cfg.model.name,
        train_dataset.n_channels,
        n_classes,
        dtype={"bfloat16": torch.bfloat16, "float32": torch.float32}[compute_dtype],
        device=device,
        conv_impl=resolve_conv_impl(cfg),
        **(cfg.model.get("model_kwargs") or {}),
    )
    if init_state_dict is None:
        init_weights(model, seed)
    ema_decay = float(cfg.select("ema_decay", 0.0) or 0.0)
    state = create_train_state(
        model,
        init_state_dict,
        lr=cfg.lr,
        optimizer_name=cfg.select("model.model_kwargs.optimizer_name", cfg.optimizer),
        schedule=cfg.select("lr_schedule", "constant"),
        # Cosine decays to 0 at the run's last step (drop_last batching,
        # capped by limit_train_batches).
        total_steps=cfg.n_epochs * _steps_per_epoch(cfg, train_dataset, batch_size),
        warmup_steps=int(cfg.select("lr_warmup_steps", 0) or 0),
        ema=ema_decay > 0,
    )

    manager = CheckpointManager(
        exp_dir,
        save_top_k=cfg.save_topk_models,
        async_save=bool(cfg.select("tpu.async_checkpoint", True)),
        resume_every=int(cfg.select("tpu.resume_every", 5) or 1),
    )
    start_epoch = 0
    if cfg.select("tpu.resume", True) and manager.latest_model_path:
        manager.restore(manager.latest_model_path, state)
        latest = manager.latest_epoch
        start_epoch = 0 if latest is None else latest + 1
        print(f"[fit] resumed from {manager.latest_model_path} (epoch {start_epoch})")
        if start_epoch >= cfg.n_epochs:
            # A fully trained experiment: no cache, no writer, no step.
            print(f"[fit] nothing to do: epoch {start_epoch} >= n_epochs {cfg.n_epochs}")
            return manager.best_model_path or ""

    transform_params = dataclasses.replace(
        TransformParams.from_config(cfg.transforms), dtype=compute_dtype
    )
    if not cfg.select("tpu.use_pallas", True):
        transform_params = dataclasses.replace(transform_params, rotate_impl="shear")
    train_step = make_train_step(
        model,
        ignore_index,
        transform_params,
        loss_cfg=cfg.select("loss"),
        fuse_augmentation=False,
        ema_decay=ema_decay,
        ema_warmup=bool(cfg.select("ema_warmup", True)),
    )
    augment_step = make_augment_step(transform_params, ignore_index)
    eval_step = make_eval_step(model, ignore_index)

    # The HBM scene cache (data/device_cache.py): batches are gathered on
    # the card from index rows. The budget covers train + valid together;
    # the valid stacks get what the train stacks left.
    train_cache = valid_cache = None
    cache_bytes = int(cfg.select("tpu.device_data_bytes", 6 << 30) or 0)
    if cache_bytes > 0:
        train_cache = build_device_cache(train_dataset, cache_bytes, device, cfg.n_workers)
        if train_cache is not None:
            valid_cache = build_device_cache(
                valid_dataset, cache_bytes - train_cache.nbytes, device, cfg.n_workers
            )
            cached = train_cache.nbytes + (valid_cache.nbytes if valid_cache else 0)
            print(f"[fit] device data cache: {cached / 1e9:.2f} GB on {device}")

    def from_cache(cache, dataset, order, drop_last):
        for batch, _, n_real in cache_batches(cache, dataset, batch_size, order, drop_last):
            # Made on the card: a blocking host copy would wait for the
            # stream, and the host could no longer run ahead of the steps.
            batch["valid"] = torch.arange(batch_size, device=device) < n_real
            yield batch

    def train_batches(epoch):
        if train_cache is not None:
            # The order is a pure function of (seed, epoch), as the loader's.
            order = np.random.default_rng((seed, epoch)).permutation(len(train_dataset))
            return from_cache(train_cache, train_dataset, order, True)
        train_loader.set_epoch(epoch)
        return device_prefetch(iter(train_loader), device, size=cfg.select("tpu.prefetch", 2))

    def valid_batches():
        if valid_cache is not None:
            return from_cache(valid_cache, valid_dataset, np.arange(len(valid_dataset)), False)
        return device_prefetch(iter(valid_loader), device, size=2)

    def logits_of(image):
        """Eval forward on the current parameters (not the EMA), NHWC logits."""
        model.eval()
        try:
            with torch.inference_mode():
                return model({"image": image.permute(0, 3, 1, 2)}).permute(0, 2, 3, 1)
        finally:
            model.train()

    writer, writer_name = open_writer(os.path.join(exp_dir, "tensorboard_logs"))
    print(f"[fit] logging with {writer_name} under {exp_dir}/tensorboard_logs")
    log_image_iter = cfg.select("log_image_iter") or 0
    profiler_mode = cfg.select("profiler")
    limit_train = cfg.select("limit_train_batches")
    limit_val = cfg.select("limit_val_batches")
    global_step = start_epoch * max(1, len(train_loader))

    setup_wall = time.time() - fit_start
    first_step_wall = None
    for epoch in range(start_epoch, cfg.n_epochs):
        # ---- train -------------------------------------------------------
        generator = _epoch_generator(seed, epoch, device)
        epoch_start = time.time()
        profiler = None
        if profiler_mode == "advanced" and epoch == start_epoch:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            profiler = profile(activities=activities)
            profiler.start()

        train_confusion = torch.zeros((n_classes, n_classes), device=device)
        n_train_batches = 0
        losses = []
        for batch in itertools.islice(train_batches(epoch), limit_train):
            if augment_step is not None:
                batch = augment_step(generator, batch)
            state, logs = train_step(state, batch)
            train_confusion += logs["confusion"]
            losses.append(logs["loss"])
            if first_step_wall is None:
                # The first step of the fit, synchronized so that later
                # steps' queued work does not hide in its reading.
                _sync(device)
                first_step_wall = time.time() - epoch_start
            n_train_batches += 1
            global_step += 1
            if global_step % 10 == 0:
                writer.add_scalar("train_loss", logs["loss"].item(), global_step)
                step_metrics = compute_metrics(logs["confusion"], "train_", ignore_index)
                for key, value in step_metrics.items():
                    writer.add_scalar(key, value.item(), global_step)
            if log_image_iter and global_step % log_image_iter == 0:
                logits = logits_of(batch["image"])
                log_image_panel(
                    writer,
                    f"train_s{global_step}",
                    batch["image"][0].float().cpu().numpy(),
                    batch["mean"][0].cpu().numpy(),
                    batch["std"][0].cpu().numpy(),
                    logits[0].cpu().numpy(),
                    batch["target"][0].cpu().numpy(),
                    train_dataset.to_RGB,
                    global_step,
                )

        if profiler is not None:
            profiler.stop()
            profile_dir = cfg.select("tpu.profile_dir") or os.path.join(exp_dir, "profile")
            os.makedirs(profile_dir, exist_ok=True)
            profiler.export_chrome_trace(os.path.join(profile_dir, f"epoch{epoch}.json"))

        _sync(device)
        train_time = time.time() - epoch_start
        train_metrics = compute_metrics(train_confusion, "train_", ignore_index)
        train_metrics["train_loss"] = (
            torch.stack(losses).mean() if losses else torch.tensor(0.0)
        )

        # ---- validation --------------------------------------------------
        eval_start = time.time()
        val_confusion = torch.zeros((n_classes, n_classes), device=device)
        val_losses = []
        for batch in itertools.islice(valid_batches(), limit_val):
            logs = eval_step(state, batch)
            val_confusion += logs["confusion"]
            val_losses.append(logs["loss"])
        _sync(device)
        eval_wall = time.time() - eval_start
        val_metrics = compute_metrics(val_confusion, "val_", ignore_index)
        val_metrics.update(compute_binary_class_metrics(val_confusion, 1, "val_"))
        val_metrics["valid_loss"] = (
            torch.stack(val_losses).mean() if val_losses else torch.tensor(0.0)
        )

        # Renamed to the reference's torchmetrics keys for the monitor.
        key_map = torchmetrics_key_names("val_")
        monitored = {key_map.get(k, k): float(v) for k, v in val_metrics.items()}
        monitored.update({k: float(v) for k, v in train_metrics.items()})
        for key, value in monitored.items():
            writer.add_scalar(key, value, global_step)

        tiles_per_sec = n_train_batches * batch_size / train_time if train_time > 0 else 0.0
        writer.add_scalar("train_tiles_per_sec", tiles_per_sec, global_step)
        if profiler_mode == "simple":
            print(f"[profiler] epoch {epoch}: {train_time:.1f}s train, "
                  f"{tiles_per_sec:.1f} tiles/s")
        print(
            f"epoch {epoch}: loss {monitored['train_loss']:.4f} "
            f"val_IoU {monitored.get(MONITOR_KEY, 0.0):.4f} "
            f"water_IoU {monitored.get('val_water_IoU', 0.0):.4f} "
            f"({tiles_per_sec:.1f} tiles/s)"
        )
        ckpt_start = time.time()
        # force on the final epoch: a completed run leaves a latest
        # checkpoint, so a re-invoked fit is a no-op.
        manager.save(state, epoch, monitored, force=(epoch == cfg.n_epochs - 1))
        ckpt_wall = time.time() - ckpt_start
        timing_epochs.append({
            "epoch": epoch,
            "train_wall": round(train_time, 3),
            "eval_wall": round(eval_wall, 3),
            "ckpt_wall": round(ckpt_wall, 3),
            "epoch_wall": round(time.time() - epoch_start, 3),
            "n_train_batches": n_train_batches,
            "tiles_per_sec": round(tiles_per_sec, 2),
        })

    writer.close()
    # Drain the in-flight write: its tail is charged to checkpointing, and
    # callers reading best_model_path get a finished directory.
    ckpt_drain_start = time.time()
    manager.wait_until_finished()
    ckpt_drain_wall = time.time() - ckpt_drain_start
    if timing_epochs:
        _write_timing(exp_dir, fit_start, setup_wall, first_step_wall, timing_epochs,
                      batch_size, manager.background_write_seconds, ckpt_drain_wall)
    return manager.best_model_path or ""


def _write_timing(exp_dir, fit_start, setup_wall, first_step_wall, timing_epochs,
                  batch_size, ckpt_bg_wall, ckpt_drain_wall) -> None:
    """<exp_dir>/timing.json with the JAX package's keys (fit.py:884-937)."""
    fit_wall = time.time() - fit_start
    n_tiles = int(sum(e["n_train_batches"] for e in timing_epochs) * batch_size)
    train_sum = sum(e["train_wall"] for e in timing_epochs)
    eval_sum = sum(e["eval_wall"] for e in timing_epochs)
    ckpt_sum = sum(e["ckpt_wall"] for e in timing_epochs)
    # Steady train rate: without the (first) epoch that holds the first step.
    steady = timing_epochs[1:] or timing_epochs
    steady_tiles = int(sum(e["n_train_batches"] for e in steady) * batch_size)
    steady_wall = sum(e["train_wall"] for e in steady)
    timing = {
        "fit_wall": round(fit_wall, 2),
        "setup_wall": round(setup_wall, 2),
        "first_step_wall": round(first_step_wall or 0.0, 2),
        "train_wall": round(train_sum, 2),
        "eval_wall": round(eval_sum, 2),
        "ckpt_wall": round(ckpt_sum, 2),
        # Async: ckpt_wall is the blocking epoch-end cost (snapshot + drain
        # of the previous write), ckpt_bg_wall the worker's time (overlapped
        # with training), ckpt_drain_wall the tail paid at the fit's end.
        "ckpt_bg_wall": round(ckpt_bg_wall, 2),
        "ckpt_drain_wall": round(ckpt_drain_wall, 2),
        "other_wall": round(
            fit_wall - setup_wall - train_sum - eval_sum - ckpt_sum - ckpt_drain_wall, 2
        ),
        "n_epochs_run": len(timing_epochs),
        "train_tiles": n_tiles,
        "effective_tiles_per_sec": round(n_tiles / fit_wall, 2),
        "steady_train_tiles_per_sec": round(
            steady_tiles / steady_wall if steady_wall > 0 else 0.0, 2
        ),
        "epochs": timing_epochs,
    }
    with open(os.path.join(exp_dir, "timing.json"), "w") as handle:
        json.dump(timing, handle, indent=2)
    print(
        f"[timing] fit {fit_wall:.1f}s = setup {setup_wall:.1f} + "
        f"train {train_sum:.1f} + eval {eval_sum:.1f} + "
        f"ckpt {ckpt_sum:.1f} (+{timing['ckpt_drain_wall']:.1f} drain, "
        f"{timing['ckpt_bg_wall']:.1f} overlapped) + "
        f"other {timing['other_wall']:.1f} "
        f"(effective {timing['effective_tiles_per_sec']:.1f} tiles/s, "
        f"steady train {timing['steady_train_tiles_per_sec']:.1f})"
    )
