"""Training entry point and steps: the port of
``floodplanet_code_tpu/train/fit.py``.

- ``fit_model(cfg)``: the epoch loop (reference fit.py:16-103):
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
- ``tpu.debug_nans``: the counterpart of ``jax_debug_nans``
  (``raise_on_nan``), scoped to the fit.
- More than one device (``tpu.n_devices`` > 1, a ``tpu.multihost`` block
  or a launcher's environment): one process per device
  (``parallel/launch.py``, ``parallel/multihost.py``); each rank loads its
  rows of every global batch, augments them with the global batch's draws,
  and runs the data-parallel steps (``group``: SyncBN, the global loss, one
  gradient all-reduce, the global confusion).
  Only rank 0 writes the experiment directory, checkpoints and TensorBoard.
- Spatial partitioning (``tpu.spatial_shards`` = sp > 1): the ranks form a
  data x space mesh. A rank loads and augments its batch shard's rows at
  full height, as above (the sp ranks of one data row repeat the same
  draws on the same tiles, where GSPMD would gather), then keeps its block
  of image rows (``mesh.local_height``: the JAX batch sharding's block of
  H / sp rows; any height that sp divides, unless some rank's block would
  be empty at some UNet level, ``parallel/rows.py``). The model exchanges
  edge rows around every 3x3 conv and 2x upsample, and at every pool window
  split between two ranks, over the space group (``parallel/halo.py``), and
  the steps are ``make_train_step`` and ``make_eval_step`` with every sum
  over all ranks (SyncBN weighting each rank by its pixels).

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
from floodplanet_code_tpu_torch.data.augment import (
    TransformParams,
    apply_augmentation,
    augment_batch,
    draw_augmentation,
)
from floodplanet_code_tpu_torch.data.device_cache import (
    build_device_cache,
    build_device_cache_sharded,
    cache_batches,
    make_batch_builder,
    make_batch_builder_podsharded,
)
from floodplanet_code_tpu_torch.device import resolve_device
from floodplanet_code_tpu_torch.models import (
    build_model,
    resolve_compute_dtype,
    resolve_conv_impl,
)
from floodplanet_code_tpu_torch.models.unet import set_space_group
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
from floodplanet_code_tpu_torch.parallel import collectives, launch, multihost
from floodplanet_code_tpu_torch.parallel.mesh import (
    all_group,
    detect_n_pods,
    device_list,
    local_height,
    local_rows,
    make_hybrid_mesh,
    make_mesh,
    make_mesh_2d,
    n_batch_shards,
    replicate_state,
    space_group,
)
from floodplanet_code_tpu_torch.parallel.rows import row_layout
from floodplanet_code_tpu_torch.train.checkpoint import MONITOR_KEY, CheckpointManager
from floodplanet_code_tpu_torch.train.logging import NullWriter, log_image_panel, open_writer
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


def make_loss_fn(loss_cfg, ignore_index: int, group=None):
    """Loss factory: ce | weighted_ce | ce_dice (conf key ``loss``);
    returns loss(logits NCHW, target). ``group``: the loss of the group's
    whole batch (ops/losses.py)."""
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
        return lambda logits, target: cross_entropy_ignore(logits, target, ignore_index,
                                                           group=group)
    if name == "weighted_ce":
        if weights is None:
            raise ValueError("loss.name=weighted_ce requires loss.class_weights")
        return lambda logits, target: weighted_cross_entropy(
            logits, target, weights, ignore_index, group=group
        )
    if name == "ce_dice":

        def ce_dice(logits, target):
            if weights is not None:
                ce = weighted_cross_entropy(logits, target, weights, ignore_index, group=group)
            else:
                ce = cross_entropy_ignore(logits, target, ignore_index, group=group)
            return ce + dice_weight * dice_loss(logits, target, ignore_index, group=group)

        return ce_dice
    raise NotImplementedError(f'No implementation for loss "{name}"')


def _model_batch(batch: dict, image: torch.Tensor) -> dict:
    """The model's NCHW inputs (views of the NHWC batch tensors)."""
    out = {"image": image.permute(0, 3, 1, 2)}
    for key in AUX_FEATURE_KEYS:
        if key in batch:
            out[key] = batch[key].permute(0, 3, 1, 2)
    return out


def make_augment_step(transform_params: TransformParams, ignore_index: int, mesh=None):
    """``augment_step(generator, batch) -> batch`` with ``image`` and
    ``target`` augmented (a new dict; the input batch is left as it is), or
    None when no transform is active.

    ``mesh`` (more than one rank): ``batch`` is this rank's rows of the
    global batch. Every rank draws for the whole global batch from the same
    generator and applies its rows' draws, so the result is the one-rank
    step's on the global batch, row for row (the JAX fit augments the
    global batch as one program: its draws do not depend on the device
    count)."""
    if not transform_params.any_active:
        return None

    def augment_step(generator: torch.Generator, batch: dict) -> dict:
        if mesh is None:
            image, target = augment_batch(
                generator, batch["image"], batch["target"], transform_params, ignore_index
            )
        else:
            local = batch["image"].shape[0]
            n = local * n_batch_shards(mesh)
            rows = local_rows(mesh, n)
            draws = draw_augmentation(generator, n, transform_params, batch["image"].device)
            draws = type(draws)(*(getattr(draws, f.name)[rows]
                                  for f in dataclasses.fields(draws)))
            image, target = apply_augmentation(batch["image"], batch["target"], draws,
                                               transform_params, ignore_index)
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
    group=None,
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

    ``group`` (the data-parallel step, ``parallel/shard_step.py``):
    ``batch`` is this rank's rows and ``model`` was built with the same
    ``bn_group``. The loss is the group's whole batch's (ops/losses.py),
    the gradients are summed over the group in one all-reduce of one flat
    buffer before the update, so every rank takes the same update, and the
    confusion is the group's. The loss's and BatchNorm's backwards add no
    second sum (parallel/collectives.py).
    """
    loss_of = make_loss_fn(loss_cfg, ignore_index, group)

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
        if group is not None:
            _all_reduce_grads(model, group)
        lr = state.schedule(state.step)
        for param_group in state.optimizer.param_groups:
            param_group["lr"] = lr
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
            confusion = confusion_from_logits(logits, target, ignore_index, group=group)
        return state, {"loss": loss.detach(), "confusion": confusion}

    return train_step


def _all_reduce_grads(model, group) -> None:
    """Sum every parameter's gradient over ``group`` in one all-reduce of
    one flat f32 buffer (the parameters are f32)."""
    params = list(model.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    collectives.all_reduce(flat, group)
    offset = 0
    for p in params:
        p.grad.copy_(flat[offset:offset + p.numel()].view_as(p))
        offset += p.numel()


def make_eval_step(model, ignore_index: int, group=None):
    """``eval_step(state, batch) -> {"loss", "confusion", "logits"}``: the
    eval-mode forward under inference mode (on the EMA parameters when
    present), loss and confusion with the rows whose ``valid`` is False
    dropped, and the batch's f32 logits [B, n_classes, H, W]. The model's
    train/eval mode is restored afterwards. ``group``: ``batch`` is this
    rank's rows, the loss and confusion are the group's whole batch's, the
    logits this rank's."""

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
                                                 sample_weight=valid, group=group),
                    "confusion": confusion_from_logits(logits, target, ignore_index,
                                                       sample_weight=valid, group=group),
                    "logits": logits,
                }
        finally:
            model.train(was_training)

    return eval_step


def raise_on_nan(where: str, named, group=None) -> None:
    """Raise ``FloatingPointError`` naming the first of ``named`` ((name,
    tensor) pairs, in order) that holds a NaN: ``tpu.debug_nans``, the
    counterpart of ``jax_debug_nans``, which checks NaN and not inf. One
    fused reduction and one host sync: a tensor's 2-norm is NaN exactly
    when one of its elements is (an inf gives inf), and ``_foreach_norm``
    takes all the tensors in one multi-tensor launch per dtype.

    ``group``: the flags are summed over the group first, so every rank
    raises at the same step, naming the first tensor that holds a NaN on
    any rank: one rank raising alone would leave the others waiting in
    their next collective."""
    names = [name for name, _ in named]
    norms = torch._foreach_norm([t.detach().float() for _, t in named])
    flags = torch.stack(norms).isnan().float()
    if group is not None:
        collectives.all_reduce(flags, group)
    bad = flags.nonzero()  # the host sync
    if bad.numel():
        raise FloatingPointError(f"NaN in {names[int(bad[0, 0])]} {where} (tpu.debug_nans)")


def _train_step_tensors(model, loss: torch.Tensor) -> list:
    """What ``tpu.debug_nans`` checks after a train step: the loss, the
    gradients, the updated parameters and the running statistics."""
    params = list(model.named_parameters())
    return ([("the loss", loss)]
            + [(f"the gradient of {n}", p.grad) for n, p in params if p.grad is not None]
            + [(f"parameter {n}", p) for n, p in params]
            + [(f"running statistic {n}", b) for n, b in model.named_buffers()])


def _steps_per_epoch(cfg, train_dataset, batch_size: int) -> int:
    """Train steps per epoch: drop_last batching, limit_train_batches cap."""
    steps = max(1, len(train_dataset) // batch_size)
    limit = int(cfg.select("limit_train_batches") or 0)
    return min(steps, limit) if limit else steps


def default_experiment_dir(cfg: Config) -> str:
    pattern = cfg.select("run.dir", "./outputs/{date}/{name}/")
    name = cfg.select("run.name", "default")
    return pattern.format(date=datetime.date.today().isoformat(), name=name)


def _spatial_shards(cfg) -> int:
    return int(cfg.select("tpu.spatial_shards", 1) or 1)


def _check_supported(cfg) -> None:
    """Raise for the settings the port does not run (before anything is
    written): the JAX package's own refusals of ``tpu.spmd_impl``
    (``train/fit.py:377-386`` there), a crop height that spatial
    partitioning does not divide (the JAX batch sharding's refusal), and
    one that leaves some rank's block empty at some UNet level
    (``rows.row_layout``)."""
    spatial = _spatial_shards(cfg)
    spmd_impl = cfg.select("tpu.spmd_impl", "gspmd") or "gspmd"
    if spmd_impl not in ("gspmd", "shard_map"):
        raise NotImplementedError(f'No implementation for tpu.spmd_impl "{spmd_impl}"')
    if spmd_impl == "shard_map" and spatial > 1:
        raise ValueError("tpu.spmd_impl=shard_map is the data-parallel variant; "
                         "spatial_shards>1 needs gspmd")
    if spmd_impl == "shard_map" and (cfg.select("loss.name", "ce") or "ce") != "ce":
        raise NotImplementedError("tpu.spmd_impl=shard_map supports the default CE loss only")
    if spatial > 1:
        row_layout(int(cfg.crop_height), spatial)
    block = cfg.select("tpu.multihost") or {}
    keys = ("coordinator_address", "num_processes", "process_id")
    given = [k for k in keys if block.get(k) is not None]
    if given and len(given) < len(keys):
        raise ValueError(
            f"tpu.multihost sets {given} but not {[k for k in keys if k not in given]}: a "
            "cluster needs all three (or none, and a launcher's environment)"
        )


def _fit_mesh(spatial: int):
    """The mesh of this fit's ranks (JAX ``train/fit.py:308-331``): pod x
    data when the ranks span more than one node (``detect_n_pods``), else
    one data axis; with ``spatial`` > 1 a ``space`` axis of that size
    last, over world / spatial batch shards (raises unless it divides the
    world). Unlike the JAX package, a pod axis is made also with one rank
    per node: the mesh places no collective here, and the pod-sharded
    scene cache needs the axis."""
    world = multihost.process_count()
    if world % spatial:
        raise ValueError(
            f"tpu.spatial_shards={spatial} needs {spatial} devices (or a multiple of "
            f"{spatial}), one per rank; {world} rank(s) are in this process group")
    dp = world // spatial
    n_pods = detect_n_pods()
    if n_pods > 1 and dp % n_pods == 0:
        return make_hybrid_mesh(n_pods, dp // n_pods, sp=spatial)
    return make_mesh_2d(dp, spatial) if spatial > 1 else make_mesh(world)


def _local_block(batch: dict, rows: slice) -> dict:
    """A batch with its image, target and aux rasters cut to ``rows`` of
    their height (this rank's block); the per-example leaves (mean, std,
    valid) stay whole."""
    out = dict(batch)
    for key in ("image", "target", *AUX_FEATURE_KEYS):
        if key in out:
            out[key] = out[key][:, rows]
    return out


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
    devices=None,
) -> str:
    """Train; returns the best checkpoint path (reference fit.py:16-103,
    JAX ``train/fit.py:263-938``), on every rank.

    ``init_state_dict``: start from these weights (a state dict, e.g. the
    JAX package's initial parameters through ``state_dict_from_flax``)
    instead of ``init_weights(model, seed_num)``. Raises without a card
    unless ``device="cpu"``, and for the settings ``_check_supported``
    refuses.

    More than one device: ``devices`` (a list, e.g. ``["cuda:0",
    "cuda:1"]``, or twice ``"cpu"``) or ``tpu.n_devices`` > 1 (``cuda:0``
    .. ``cuda:n-1``; raises when fewer cards are present, or ``n`` times
    the CPU) spawns one rank per device (``parallel/launch.py``), each
    running this function, and returns rank 0's result. A process already
    in a group (``torchrun``, a ``tpu.multihost`` block) is one rank.
    ``tpu.n_devices`` counts ranks: with ``tpu.spatial_shards`` = sp, the
    world / sp batch shards of sp blocks of rows each (module docstring);
    sp must divide the crop height and leave every rank a row at every
    UNet level.

    ``tpu.debug_nans``: after every train step the loss, gradients,
    parameters and running statistics, after every validation step the loss
    and logits, are checked for NaN (``raise_on_nan``), and the first NaN
    raises ``FloatingPointError`` naming the epoch, the step and the
    tensor (on every rank at once). Off, the steps carry no check and no
    sync. Unlike ``jax_debug_nans``, which the JAX fit turns on for the rest
    of the process, the setting ends with the fit.
    """
    _check_supported(cfg)
    multihost.initialize_from_env_or_config(cfg, device)
    n_cfg = cfg.select("tpu.n_devices")
    if not collectives.active():
        if devices is None and int(n_cfg or 1) > 1:
            devices = device_list(int(n_cfg), device)
        if devices is not None and n_cfg is not None and int(n_cfg) != len(devices):
            raise ValueError(f"tpu.n_devices={n_cfg} but {len(devices)} devices given")
        if devices is not None and len(devices) > 1:
            exp_dir = overwrite_exp_dir or default_experiment_dir(cfg)
            return launch.spawn(fit_model, (cfg, exp_dir), {"init_state_dict": init_state_dict},
                                devices=devices)[0]
        if devices:
            device = devices[0]
    device = resolve_device(multihost.rank_device(device))
    world = multihost.process_count()
    if n_cfg is not None and int(n_cfg) != world:
        raise ValueError(f"tpu.n_devices={n_cfg} but {world} ranks are in this process group")
    coordinator = multihost.is_coordinator()
    mesh = _fit_mesh(_spatial_shards(cfg))
    group = all_group(mesh)  # every sum of the steps: SyncBN, losses, gradients
    space = space_group(mesh)  # spatial partitioning's row exchanges, or None
    height_rows = local_height(mesh, int(cfg.crop_height))
    shard_mode = str(cfg.select("tpu.device_cache_shard", "auto") or "auto")
    if shard_mode == "pod" and "pod" not in mesh.axis_names:
        raise ValueError(
            "tpu.device_cache_shard=pod needs a pod axis: ranks on more than one node "
            f"(LOCAL_WORLD_SIZE below the world size); this fit's mesh is {mesh.shape}"
        )
    if device.type == "cuda" and collectives.active():
        torch.cuda.set_device(device)  # the rank's card (rank_device gives it an index)
    # Wall-clock decomposition of the whole fit, written to
    # <exp_dir>/timing.json with the JAX package's keys.
    fit_start = time.time()
    timing_epochs: list[dict] = []

    exp_dir = overwrite_exp_dir or default_experiment_dir(cfg)
    if coordinator:
        os.makedirs(exp_dir, exist_ok=True)
        save_config(cfg, exp_dir)
    if world > 1:
        print(f"[fit] rank {multihost.process_index()} of {world} on {device}, mesh axes "
              f"{mesh.shape}", flush=True)

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
    # The global batch splits evenly over the ranks (JAX train/fit.py:336-346).
    n_shards = n_batch_shards(mesh)
    batch_size = int(cfg.batch_size)
    if batch_size % n_shards != 0:
        batch_size = max(n_shards, (batch_size // n_shards) * n_shards)
        print(f"[fit] batch_size {cfg.batch_size} not divisible by {n_shards} data shards; "
              f"using {batch_size}")
    rows = local_rows(mesh, batch_size)
    seed = cfg.seed_num or 0

    shard = multihost.process_shard(mesh)
    train_loader = BatchLoader(train_dataset, batch_size=batch_size, shuffle=True,
                               n_workers=cfg.n_workers, drop_last=True, seed=cfg.seed_num,
                               process_shard=shard)
    valid_loader = BatchLoader(valid_dataset, batch_size=batch_size, shuffle=False,
                               n_workers=cfg.n_workers, drop_last=False, pad_final=True,
                               process_shard=shard)

    compute_dtype = cfg.select("tpu.compute_dtype", "bfloat16")
    model = build_model(
        cfg.model.name,
        train_dataset.n_channels,
        n_classes,
        dtype=resolve_compute_dtype(cfg),
        device=device,
        conv_impl=resolve_conv_impl(cfg),
        bn_group=group,
        space_group=space,
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
    replicate_state(state, mesh)

    # Every rank reads the index rank 0 wrote; the barrier orders the
    # reads after rank 0 made the directory.
    multihost.sync("setup")
    manager = CheckpointManager(
        exp_dir,
        save_top_k=cfg.save_topk_models,
        async_save=bool(cfg.select("tpu.async_checkpoint", True)),
        resume_every=int(cfg.select("tpu.resume_every", 5) or 1),
    )
    start_epoch = 0
    if cfg.select("tpu.resume", True) and manager.latest_model_path:
        # Every rank restores from the shared directory.
        manager.restore(manager.latest_model_path, state)
        replicate_state(state, mesh)
        latest = manager.latest_epoch
        start_epoch = 0 if latest is None else latest + 1
        print(f"[fit] resumed from {manager.latest_model_path} (epoch {start_epoch})")
        if start_epoch >= cfg.n_epochs:
            # A fully trained experiment: no cache, no writer, no step. The
            # same index on every rank: every rank returns here.
            print(f"[fit] nothing to do: epoch {start_epoch} >= n_epochs {cfg.n_epochs}")
            return manager.best_model_path or ""

    transform_params = dataclasses.replace(
        TransformParams.from_config(cfg.transforms), dtype=compute_dtype
    )
    if not cfg.select("tpu.use_pallas", True):
        transform_params = dataclasses.replace(transform_params, rotate_impl="shear")
    # The steps over every rank of this fit's mesh (on one rank they sum
    # nothing): the data-parallel steps, and under spatial partitioning
    # the port's GSPMD step, the same code with the model's space group set.
    train_step = make_train_step(model, ignore_index, TransformParams(False, 0, False, 0, False, 0),
                                 loss_cfg=cfg.select("loss"), fuse_augmentation=False,
                                 ema_decay=ema_decay,
                                 ema_warmup=bool(cfg.select("ema_warmup", True)), group=group)
    eval_step = make_eval_step(model, ignore_index, group)
    augment_step = make_augment_step(transform_params, ignore_index,
                                     mesh if world > 1 else None)

    def own_rows(batch: dict) -> dict:
        """This rank's block of a batch's image rows (all of them without
        spatial partitioning)."""
        return batch if space is None else _local_block(batch, height_rows)

    # The HBM scene cache (data/device_cache.py): batches are gathered on
    # the card from index rows. The budget (per device) covers train +
    # valid together; the valid stacks get what the train stacks left.
    # tpu.device_cache_shard (JAX train/fit.py:543-566): 'replicate' keeps
    # every scene on every rank, 'pod' 1/n_pods of them per pod, 'auto'
    # replicates when the budget allows and else shards over the pods.
    def build_cache(dataset, budget):
        """(cache, builder of this rank's rows, bytes on this device)."""
        if shard_mode in ("auto", "replicate"):
            cache = build_device_cache(dataset, budget, device, cfg.n_workers)
            if cache is not None:
                return cache, make_batch_builder(cache, rows), cache.nbytes
        if shard_mode in ("auto", "pod") and "pod" in mesh.axis_names:
            cache = build_device_cache_sharded(dataset, mesh, budget, device, cfg.n_workers)
            if cache is not None:
                return (cache, make_batch_builder_podsharded(cache, mesh, batch_size),
                        cache.device_nbytes)
        return None, None, 0

    train_cache = valid_cache = train_build = valid_build = None
    cache_bytes = int(cfg.select("tpu.device_data_bytes", 6 << 30) or 0)
    if cache_bytes > 0:
        train_cache, train_build, train_held = build_cache(train_dataset, cache_bytes)
        if train_cache is not None:
            valid_cache, valid_build, valid_held = build_cache(
                valid_dataset, cache_bytes - train_held)
            cached = train_held + (valid_held if valid_cache else 0)
            pod = " (pod-sharded)" if train_cache.device_nbytes < train_cache.nbytes else ""
            print(f"[fit] device data cache: {cached / 1e9:.2f} GB on {device}{pod}")

    positions = torch.arange(batch_size, device=device)[rows]

    def from_cache(cache, build, dataset, order, drop_last):
        for batch, _, n_real in cache_batches(cache, dataset, batch_size, order, drop_last,
                                              build=build):
            # Made on the card: a blocking host copy would wait for the
            # stream, and the host could no longer run ahead of the steps.
            batch["valid"] = positions < n_real
            yield batch

    def train_batches(epoch):
        if train_cache is not None:
            # The order is a pure function of (seed, epoch), as the loader's.
            order = np.random.default_rng((seed, epoch)).permutation(len(train_dataset))
            return from_cache(train_cache, train_build, train_dataset, order, True)
        train_loader.set_epoch(epoch)
        return device_prefetch(iter(train_loader), device, size=cfg.select("tpu.prefetch", 2))

    def valid_batches():
        if valid_cache is not None:
            return from_cache(valid_cache, valid_build, valid_dataset,
                              np.arange(len(valid_dataset)), False)
        return device_prefetch(iter(valid_loader), device, size=2)

    def logits_of(image):
        """Eval forward on the current parameters (not the EMA), NHWC logits,
        of whole images: the coordinator alone runs it, so the model
        exchanges no rows for it (under spatial partitioning the image is
        the coordinator's full-height batch, before its block is cut)."""
        model.eval()
        set_space_group(model, None)
        try:
            with torch.inference_mode():
                return model({"image": image.permute(0, 3, 1, 2)}).permute(0, 2, 3, 1)
        finally:
            set_space_group(model, space)
            model.train()

    # The coordinator writes TensorBoard; the other ranks' writer drops all.
    writer, writer_name = NullWriter(), "nothing (not the coordinator)"
    if coordinator:
        writer, writer_name = open_writer(os.path.join(exp_dir, "tensorboard_logs"))
        print(f"[fit] logging with {writer_name} under {exp_dir}/tensorboard_logs")
    log_image_iter = cfg.select("log_image_iter") or 0
    debug_nans = bool(cfg.select("tpu.debug_nans", False))
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
        if profiler_mode == "advanced" and epoch == start_epoch and coordinator:
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
            state, logs = train_step(state, own_rows(batch))
            if debug_nans:
                raise_on_nan(f"after train step {n_train_batches} of epoch {epoch}",
                             _train_step_tensors(model, logs["loss"]), group)
            train_confusion += logs["confusion"]
            losses.append(logs["loss"])
            if first_step_wall is None:
                # The first step of the fit, synchronized so that later
                # steps' queued work does not hide in its reading.
                _sync(device)
                first_step_wall = time.time() - epoch_start
            n_train_batches += 1
            global_step += 1
            if global_step % 10 == 0 and coordinator:
                writer.add_scalar("train_loss", logs["loss"].item(), global_step)
                step_metrics = compute_metrics(logs["confusion"], "train_", ignore_index)
                for key, value in step_metrics.items():
                    writer.add_scalar(key, value.item(), global_step)
            if log_image_iter and global_step % log_image_iter == 0 and coordinator:
                # The coordinator's rows, at full height; the panel's
                # forward has no collective, so the other ranks skip it.
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
        for k, batch in enumerate(itertools.islice(valid_batches(), limit_val)):
            logs = eval_step(state, own_rows(batch))
            if debug_nans:
                raise_on_nan(f"after validation step {k} of epoch {epoch}",
                             [("the loss", logs["loss"]), ("the logits", logs["logits"])],
                             group)
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
        if coordinator:
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
        # Epoch-end barrier: no rank decides the next save, or exits,
        # before rank 0's write.
        multihost.sync(f"epoch_{epoch}")
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
    if timing_epochs and coordinator:
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
