"""Rank functions for the port's multi-rank CPU tests.

``parallel/launch.py::spawn`` starts each rank in a fresh interpreter that
imports the function's module: this one imports torch and the port only
(not JAX, not the tests' conftest), so a rank starts in seconds. Every
function takes its inputs as numpy arrays, runs on ``device`` (the
launcher's), and returns numpy results for the parent to hold to the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from floodplanet_code_tpu_torch.models import build_model
from floodplanet_code_tpu_torch.ops.batchnorm import batch_stats, bn_relu_train
from floodplanet_code_tpu_torch.ops.losses import (
    cross_entropy_ignore,
    dice_loss,
    weighted_cross_entropy,
)
from floodplanet_code_tpu_torch.ops.metrics import confusion_from_logits
from floodplanet_code_tpu_torch.parallel import multihost
from floodplanet_code_tpu_torch.parallel.mesh import (
    batch_group,
    local_rows,
    make_hybrid_mesh,
    make_mesh,
)
from floodplanet_code_tpu_torch.parallel.shard_step import (
    make_shard_eval_step,
    make_shard_train_step,
)
from floodplanet_code_tpu_torch.train.state import create_train_state


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _nchw(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(device)


def ops_case(data: dict, device) -> dict:
    """SyncBN, the global losses and confusion, and the shard train / eval
    steps on this rank's rows of ``data``'s global batches."""
    mesh = make_mesh()
    group = batch_group(mesh)
    out = {}

    # SyncBN: bn_relu_train, and the differentiable statistics.
    rows = local_rows(mesh, data["bn_x"].shape[0])
    x = _nchw(data["bn_x"][rows], device).requires_grad_()
    scale = torch.from_numpy(data["bn_scale"]).requires_grad_()
    bias = torch.from_numpy(data["bn_bias"]).requires_grad_()
    z, mean, var = bn_relu_train(x, scale, bias, 1e-5, group)
    z.backward(_nchw(data["bn_dz"][rows], device))
    out["bn"] = {"z": _np(z), "mean": _np(mean), "var": _np(var), "dx": _np(x.grad),
                 "dscale": _np(scale.grad), "dbias": _np(bias.grad)}
    xs = _nchw(data["bn_x"][rows], device).requires_grad_()
    m1, m2 = batch_stats(xs, group)
    # This rank's share of a loss of the normalized batch: the gradient
    # reaches every rank's pixels through the shared statistics.
    inv = torch.rsqrt(m2 - m1 * m1 + 1e-5).view(1, -1, 1, 1)
    (_nchw(data["bn_dz"][rows], device) * (xs - m1.view(1, -1, 1, 1)) * inv).sum().backward()
    out["stats"] = {"mean": _np(m1), "m2": _np(m2), "dx": _np(xs.grad)}

    # The losses and the confusion, with unequal ignored pixels per rank.
    rows = local_rows(mesh, data["logits"].shape[0])
    target = torch.from_numpy(data["target"][rows]).to(device)
    weights = torch.from_numpy(data["class_weights"])
    losses = {
        "ce": lambda lg: cross_entropy_ignore(lg, target, 2, group=group),
        "weighted_ce": lambda lg: weighted_cross_entropy(lg, target, weights, 2, group=group),
        "dice": lambda lg: dice_loss(lg, target, 2, group=group),
    }
    for name, fn in losses.items():
        logits = _nchw(data["logits"][rows], device).requires_grad_()
        loss = fn(logits)
        loss.backward()
        out[name] = {"loss": loss.item(), "grad": _np(logits.grad)}
    out["confusion"] = _np(confusion_from_logits(_nchw(data["logits"][rows], device), target,
                                                 2, group=group))

    # Unequal pixel counts, as spatial partitioning's blocks of unequal
    # height: every example on both ranks, rank 0 the first rows of each
    # and rank 1 the rest. SyncBN, the statistics, the losses, the confusion.
    def block(a, split):
        return a[:, :split] if dist.get_rank() == 0 else a[:, split:]

    split = data["unequal_split"]
    x = _nchw(block(data["bn_x"], split["bn"]), device).requires_grad_()
    scale = torch.from_numpy(data["bn_scale"]).requires_grad_()
    bias = torch.from_numpy(data["bn_bias"]).requires_grad_()
    z, mean, var = bn_relu_train(x, scale, bias, 1e-5, group)
    z.backward(_nchw(block(data["bn_dz"], split["bn"]), device))
    out["bn_unequal"] = {"z": _np(z), "mean": _np(mean), "var": _np(var), "dx": _np(x.grad),
                         "dscale": _np(scale.grad), "dbias": _np(bias.grad)}
    xs = _nchw(block(data["bn_x"], split["bn"]), device).requires_grad_()
    m1, m2 = batch_stats(xs, group)
    inv = torch.rsqrt(m2 - m1 * m1 + 1e-5).view(1, -1, 1, 1)
    dz = _nchw(block(data["bn_dz"], split["bn"]), device)
    (dz * (xs - m1.view(1, -1, 1, 1)) * inv).sum().backward()
    out["stats_unequal"] = {"mean": _np(m1), "m2": _np(m2), "dx": _np(xs.grad)}
    target = torch.from_numpy(block(data["target"], split["logits"])).to(device)
    losses = {
        "ce": lambda lg: cross_entropy_ignore(lg, target, 2, group=group),
        "weighted_ce": lambda lg: weighted_cross_entropy(lg, target, weights, 2, group=group),
        "dice": lambda lg: dice_loss(lg, target, 2, group=group),
    }
    for name, fn in losses.items():
        logits = _nchw(block(data["logits"], split["logits"]), device).requires_grad_()
        loss = fn(logits)
        loss.backward()
        out[f"{name}_unequal"] = {"loss": loss.item(), "grad": _np(logits.grad)}
    out["confusion_unequal"] = _np(confusion_from_logits(
        _nchw(block(data["logits"], split["logits"]), device), target, 2, group=group))

    # Three chained shard train steps, then the shard eval step, with the
    # fused pair (its plain version here) and without.
    for impl in ("xla", "pallas_fused"):
        model = build_model("ef_model", {"ms_image": 4}, 3, base_feat_channels=8,
                            device=device, conv_impl=impl, bn_group=group)
        state = create_train_state(model, {k: torch.from_numpy(v) for k, v in
                                           data["start"].items()}, data["lr"])
        step = make_shard_train_step(model, mesh, 0)
        eval_step = make_shard_eval_step(model, mesh, 0)
        image, tgt, valid = data["eval"]
        rows = local_rows(mesh, image.shape[0])
        eval_batch = {"image": torch.from_numpy(image[rows]).to(device),
                      "target": torch.from_numpy(tgt[rows]).to(device),
                      "valid": torch.from_numpy(valid[rows]).to(device)}
        logs = eval_step(state, eval_batch)
        res = {"loss": [], "confusion": [], "eval0_loss": logs["loss"].item(),
               "eval0_confusion": _np(logs["confusion"])}
        for k, (image, tgt) in enumerate(data["batches"]):
            rows = local_rows(mesh, image.shape[0])
            batch = {"image": torch.from_numpy(image[rows]).to(device),
                     "target": torch.from_numpy(tgt[rows]).to(device)}
            state, logs = step(state, batch)
            res["loss"].append(logs["loss"].item())
            res["confusion"].append(_np(logs["confusion"]))
            if k == 0:
                res["grads"] = {n: _np(p.grad) for n, p in model.named_parameters()}
                res["buffers1"] = {n: _np(b) for n, b in model.named_buffers()}
        res["params"] = {n: _np(p) for n, p in model.named_parameters()}
        res["buffers"] = {n: _np(b) for n, b in model.named_buffers()}
        logs = eval_step(state, eval_batch)
        res["eval_loss"] = logs["loss"].item()
        res["eval_confusion"] = _np(logs["confusion"])
        out[f"step_{impl}"] = res
    return out


def pod_cache_case(root: str, batch_size: int, device) -> dict:
    """Every batch of one shuffled epoch from the pod-sharded cache (this
    rank's pod holds half the scenes) against the replicated cache's, for
    this rank's rows, with norm_mode null and local."""
    from floodplanet_code_tpu_torch.data import build_dataset, generate_image_slice_object
    from floodplanet_code_tpu_torch.data.device_cache import (
        build_device_cache,
        build_device_cache_sharded,
        cache_batches,
        make_batch_builder,
        make_batch_builder_podsharded,
    )

    mesh = make_hybrid_mesh(2, 1)
    rows = local_rows(mesh, batch_size)
    out = {"rows": (rows.start, rows.stop), "mesh": mesh.shape, "batches": 0}
    for norm in (None, "local"):
        ds = build_dataset("floodplanet", "train", generate_image_slice_object(32, 32, 32),
                           sensor="PS", eval_region="RegionA", ignore_index=0, seed_num=0,
                           root_dir=root, norm_mode=norm)
        full = build_device_cache(ds, 1 << 30, device)
        pod = build_device_cache_sharded(ds, mesh, 1 << 30, device)
        out["scenes"] = len(full.scene_index)
        out["held"] = (int(full.images.shape[0]), int(pod.images.shape[0]))
        order = np.random.default_rng((0, 0)).permutation(len(ds))
        want = cache_batches(full, ds, batch_size, order, True, make_batch_builder(full, rows))
        got = cache_batches(pod, ds, batch_size, order, True,
                            make_batch_builder_podsharded(pod, mesh, batch_size))
        for (w, _, _), (g, _, _) in zip(want, got):
            for key in ("image", "target", "mean", "std"):
                if not (g[key].dtype == w[key].dtype and torch.equal(g[key], w[key])):
                    raise AssertionError(f"pod-sharded {key} differs ({norm})")
            out["batches"] += 1
    return out


def multihost_case(how: str, port: int, rank: int, world: int, result_path: str) -> None:
    """Join a group the way ``how`` says (the cfg's ``tpu.multihost``
    block, or a launcher's environment), then write what ``multihost``
    reports to ``result_path``."""
    import json
    import os

    from floodplanet_code_tpu_torch.config import compose

    overrides = []
    if how == "cfg":
        overrides = [f"tpu.multihost.coordinator_address=127.0.0.1:{port}",
                     f"tpu.multihost.num_processes={world}", f"tpu.multihost.process_id={rank}"]
    else:
        os.environ.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                           "RANK": str(rank), "WORLD_SIZE": str(world)})
    cfg = compose(overrides=overrides)
    joined = multihost.initialize_from_env_or_config(cfg, "cpu", timeout_s=60)
    again = multihost.initialize_from_env_or_config(cfg, "cpu", timeout_s=60)
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    try:
        multihost.local_batch_size(world + 1)
        raised = None
    except ValueError as exc:
        raised = str(exc)
    result = {"joined": joined, "again": again, "index": multihost.process_index(),
              "count": multihost.process_count(), "coordinator": multihost.is_coordinator(),
              "shard": list(multihost.process_shard(make_mesh())), "local": multihost.local_batch_size(
                  2 * world), "sum": t.item(), "raised": raised}
    multihost.sync("done")
    dist.destroy_process_group()
    with open(result_path, "w") as handle:
        json.dump(result, handle)


def fail_on_rank_one(device) -> int:
    """Rank 1 raises; rank 0 waits in a barrier that never completes."""
    if dist.get_rank() == 1:
        raise RuntimeError("rank one fails on purpose")
    dist.barrier()
    return 0


def fit_rank(runs, init_state_dict, device) -> list:
    """``fit_model`` on this rank for each (config, experiment directory)
    of ``runs`` in turn, recording which side effects each took:
    checkpoint writes, writers opened, configs saved, image panels."""
    from floodplanet_code_tpu_torch.train import checkpoint, fit

    write, open_writer, save_config, log_image_panel = (
        checkpoint.CheckpointManager._write, fit.open_writer, fit.save_config,
        fit.log_image_panel)

    def writing(self, *args, **kwargs):
        taken.append("checkpoint")
        return write(self, *args, **kwargs)

    def opening(logdir):
        taken.append("writer")
        return open_writer(logdir)

    def saving(cfg_, path):
        taken.append("config")
        return save_config(cfg_, path)

    def panel(*args, **kwargs):
        taken.append("panel")
        return log_image_panel(*args, **kwargs)

    checkpoint.CheckpointManager._write = writing
    fit.open_writer, fit.save_config, fit.log_image_panel = opening, saving, panel
    out = []
    for cfg, exp_dir in runs:
        taken = []
        best = fit.fit_model(cfg, exp_dir, device=device, init_state_dict=init_state_dict)
        out.append({"best": best, "taken": taken, "rank": multihost.process_index()})
    return out


def _spatial_steps(case: dict, mesh, steps: dict, device) -> dict:
    """The spatial eval step (with ``case``'s padded rows) and one spatial
    train step (SGD at lr 1, whose first update is the gradient) from
    JAX's start, for each model configuration of ``steps``, on this rank's
    block of ``case``'s batch."""
    from floodplanet_code_tpu_torch.data.augment import TransformParams
    from floodplanet_code_tpu_torch.parallel.mesh import all_group, local_height, space_group
    from floodplanet_code_tpu_torch.train.fit import make_eval_step, make_train_step

    every, space = all_group(mesh), space_group(mesh)
    image, target = case["image"], case["target"]
    rows, hs = local_rows(mesh, image.shape[0]), local_height(mesh, image.shape[1])
    batch = {"image": torch.from_numpy(image[rows, hs]).to(device),
             "target": torch.from_numpy(target[rows, hs]).to(device)}
    valid = torch.from_numpy(case["valid"][rows]).to(device)
    no_aug = TransformParams(False, 0, False, 0, False, 0)
    out = {}
    for name, kwargs in steps.items():
        model = build_model("ef_model", {"ms_image": image.shape[-1]}, 3, base_feat_channels=8,
                            device=device, bn_group=every, space_group=space, **kwargs)
        state = create_train_state(model, {k: torch.from_numpy(v) for k, v in
                                           case["start"].items()}, 1.0, optimizer_name="sgd")
        logs = make_eval_step(model, 2, every)(state, dict(batch, valid=valid))
        res = {"eval_loss": logs["loss"].item(), "eval_confusion": _np(logs["confusion"])}
        step = make_train_step(model, 2, no_aug, fuse_augmentation=False, group=every)
        state, logs = step(state, batch)
        res.update(loss=logs["loss"].item(), confusion=_np(logs["confusion"]),
                   grads={n: _np(p.grad) for n, p in model.named_parameters()},
                   params={n: _np(p) for n, p in model.named_parameters()},
                   buffers={n: _np(b) for n, b in model.named_buffers()})
        out[name] = res
    return out


def _uneven_modules(case: dict, mesh, double_convs: list, device) -> dict:
    """Blocks of unequal height (``parallel/rows.py``): at every level the
    sharded pool (level -> level + 1) and the sharded upsample with
    pad-to-match (level + 1 -> level, both conventions), and the sharded
    DoubleConv at ``case["conv_level"]``: this rank's output rows and the
    gradient of <out, g> (this rank's share)."""
    from floodplanet_code_tpu_torch.models.unet import (
        DoubleConv,
        _max_pool_rows,
        _pad_to_match,
        _upsample2x_rows,
        set_bn_group,
        set_space_group,
    )
    from floodplanet_code_tpu_torch.parallel.mesh import all_group, space_group
    from floodplanet_code_tpu_torch.parallel.rows import row_layout

    every, space = all_group(mesh), space_group(mesh)
    layout = row_layout(case["height"], mesh.shape["space"])
    s = mesh.coords["space"]
    rows = local_rows(mesh, case["x"][0].shape[0])

    def own(a, level, requires_grad=False):
        t = torch.from_numpy(a[rows, :, layout.block(level, s)]).to(device)
        return t.contiguous(memory_format=torch.channels_last).requires_grad_(requires_grad)

    out = {}
    for level in range(len(layout.heights) - 1):
        x = own(case["x"][level], level, True)
        y = _max_pool_rows(x, layout, level, space)
        (y * own(case["pool_g"][level], level + 1)).sum().backward()
        out[f"pool{level}"] = {"out": _np(y), "dx": _np(x.grad)}
        for ac in (False, True):
            x = own(case["x"][level + 1], level + 1, True)
            skip = own(case["up_g"][level], level)
            up = _pad_to_match(_upsample2x_rows(x, ac, space, layout, level), skip)
            (up * skip).sum().backward()
            out[f"up{level}_{ac}"] = {"out": _np(up), "dx": _np(x.grad)}
    level = case["conv_level"]
    for impl, fused_bn in double_convs:
        torch.manual_seed(0)
        module = DoubleConv(case["x"][level].shape[1], case["conv_g"].shape[1], conv_impl=impl,
                            fused_bn=fused_bn).to(device, memory_format=torch.channels_last).train()
        set_space_group(set_bn_group(module, every), space)
        x = own(case["x"][level], level, True)
        y = module(x)
        (y * own(case["conv_g"], level)).sum().backward()
        out[f"double_conv_{impl}_{fused_bn}"] = {
            "out": _np(y), "dx": _np(x.grad),
            "grads": {n: _np(p.grad) for n, p in module.named_parameters()}}
    return out


def spatial_case(data: dict, device) -> dict:
    """Spatial partitioning on a 2 x 2 data x space mesh: this rank's block
    (its batch shard's rows, its block of image rows) through the row
    exchange, the sharded upsample and DoubleConv, the spatial train and
    eval steps, and ``replicate_state``; then blocks of unequal height: the
    sharded pool, upsample and DoubleConv and the steps at each of
    ``data["uneven"]``'s heights, on its mesh (the 2 x 2 mesh, or a 1 x 4
    mesh of the same ranks)."""
    from floodplanet_code_tpu_torch.models.unet import (
        DoubleConv,
        _upsample2x_rows,
        set_bn_group,
        set_space_group,
    )
    from floodplanet_code_tpu_torch.parallel.halo import join_rows
    from floodplanet_code_tpu_torch.parallel.mesh import (
        all_group,
        local_height,
        make_mesh_2d,
        replicate_state,
        space_group,
    )
    from floodplanet_code_tpu_torch.parallel.rows import row_layout
    from floodplanet_code_tpu_torch.train.state import init_weights

    mesh = make_mesh_2d(2, 2)
    every, space = all_group(mesh), space_group(mesh)
    rank, s = dist.get_rank(), mesh.coords["space"]
    out = {"coords": mesh.coords, "space_ranks": dist.get_process_group_ranks(space)}

    # (a) the exchange: <join_rows(x), weight> of this rank's block.
    for k in (1, 2):
        x_all = data["exchange_x"]  # [B, C, H, W]
        per = x_all.shape[2] // 2
        rows = local_rows(mesh, x_all.shape[0])
        x = torch.from_numpy(x_all[rows, :, s * per:(s + 1) * per]).to(device).requires_grad_()
        ext = join_rows(x.contiguous(memory_format=torch.channels_last), space, k)
        weight = torch.from_numpy(data["exchange_w"][rank][..., :ext.shape[2], :]).to(device)
        (ext * weight).sum().backward()
        out[f"exchange{k}"] = {"ext": _np(ext), "dx": _np(x.grad),
                               "joined": ext.shape[2] - x.shape[2]}

    # (b) the sharded modules against the unsharded ones: forward and the
    # gradient of <out, g> (this rank's share).
    x_all = data["module_x"]
    rows, hs = local_rows(mesh, x_all.shape[0]), local_height(mesh, x_all.shape[2])
    layout = row_layout(2 * x_all.shape[2], 2)  # x at level 1, the output at level 0
    for ac in (False, True):
        x = torch.from_numpy(x_all[rows, :, hs]).to(device).requires_grad_()
        up = _upsample2x_rows(x.contiguous(memory_format=torch.channels_last), ac, space,
                              layout, 0)
        g = data["upsample_g"][rows, :, 2 * hs.start:2 * hs.stop]
        (up * torch.from_numpy(g).to(device)).sum().backward()
        out[f"upsample_{ac}"] = {"out": _np(up), "dx": _np(x.grad)}
        x = torch.from_numpy(x_all[rows, :, hs]).to(device, torch.bfloat16)
        up = _upsample2x_rows(x.contiguous(memory_format=torch.channels_last), ac, space,
                              layout, 0)
        out[f"upsample_bf16_{ac}"] = {"out": _np(up.float())}
    for impl, fused_bn in data["double_convs"]:
        torch.manual_seed(0)
        module = DoubleConv(x_all.shape[1], data["module_g"].shape[1], conv_impl=impl,
                            fused_bn=fused_bn).to(device, memory_format=torch.channels_last).train()
        set_space_group(set_bn_group(module, every), space)
        x = torch.from_numpy(x_all[rows, :, hs]).to(device).requires_grad_()
        y = module(x.contiguous(memory_format=torch.channels_last))
        (y * torch.from_numpy(data["module_g"][rows, :, hs]).to(device)).sum().backward()
        out[f"double_conv_{impl}_{fused_bn}"] = {
            "out": _np(y), "dx": _np(x.grad),
            "grads": {n: _np(p.grad) for n, p in module.named_parameters()}}

    # (c), (d) one spatial train step and the eval step with a padded row.
    for name, res in _spatial_steps(data, mesh, data["steps"], device).items():
        out[f"step_{name}"] = res

    # (e) every rank starts from its own weights; replicate_state gives
    # each rank 0's, the EMA copy included.
    model = init_weights(build_model("ef_model", {"ms_image": 4}, 3, base_feat_channels=8,
                                     device=device), seed=rank)
    state = replicate_state(create_train_state(model, None, 1e-3, ema=True), mesh)
    out["replicated"] = np.concatenate(
        [_np(t).ravel() for t in [*model.state_dict().values(), *state.ema_params.values()]])

    # (f) blocks of unequal height, each case on its mesh.
    for key, case in data["uneven"].items():
        mesh = make_mesh_2d(*case["mesh"])
        out[f"uneven_{key}"] = dict(_uneven_modules(case, mesh, data["double_convs"], device),
                                    steps=_spatial_steps(case, mesh, data["steps"], device))
    return out
