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
              "shard": list(multihost.process_shard()), "local": multihost.local_batch_size(
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


def fit_rank(cfg, exp_dir: str, init_state_dict, device) -> dict:
    """``fit_model`` on this rank, recording which side effects it took:
    checkpoint writes, writers opened, configs saved."""
    from floodplanet_code_tpu_torch.train import checkpoint, fit

    taken = []
    write, open_writer, save_config = (checkpoint.CheckpointManager._write, fit.open_writer,
                                       fit.save_config)

    def writing(self, *args, **kwargs):
        taken.append("checkpoint")
        return write(self, *args, **kwargs)

    def opening(logdir):
        taken.append("writer")
        return open_writer(logdir)

    def saving(cfg_, path):
        taken.append("config")
        return save_config(cfg_, path)

    checkpoint.CheckpointManager._write = writing
    fit.open_writer, fit.save_config = opening, saving
    best = fit.fit_model(cfg, exp_dir, device=device, init_state_dict=init_state_dict)
    return {"best": best, "taken": taken, "rank": multihost.process_index()}
