"""Deep-ensemble evaluation: average softmax over several checkpoints (port
of ``floodplanet_code_tpu/tools/eval_ensemble.py``).

Classic deep ensembling (Lakshminarayanan et al. 2017): run k
independently trained models of the same architecture on the same fold
and average their predicted *probabilities*. Unlike weight soups
(tools/soup_checkpoints.py) this works across random seeds.

Each positional argument is an experiment directory produced by
``fit``/``run_crossval``; its best retained checkpoint (top of
``checkpoints/index.json``), or an explicit checkpoint directory passed
directly, becomes one ensemble member. The fold definition (dataset,
sensor, eval region, split seed) is taken from the first experiment's
config snapshot; every other member must match it, since mixing folds
would leak the held-out region into a member's training set.

Per batch of the host loader, each member runs its forward once on the
card (all members stay there together); the ensemble confusion comes from
the mean of the members' f32 softmax, and each member's own confusion from
its logits. The JAX package runs each member's forward twice for the two;
the function is the same.

Usage:
    python -m floodplanet_code_tpu_torch.tools.eval_ensemble \\
        outputs/cv_a/S1_Bangladesh outputs/cv_b/S1_Bangladesh \\
        [--split valid|test] [--batch_size N] [--out results.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from floodplanet_code_tpu_torch.config import load_experiment_config
from floodplanet_code_tpu_torch.data import BatchLoader, device_prefetch
from floodplanet_code_tpu_torch.inference.infer import (
    build_experiment_dataset,
    load_model_for_eval,
)
from floodplanet_code_tpu_torch.inference.sliding import (
    inference_devices,
    replicate,
    split_apply,
    split_batch_size,
)
from floodplanet_code_tpu_torch.models.water_seg import AUX_FEATURE_KEYS
from floodplanet_code_tpu_torch.ops.metrics import (
    compute_binary_class_metrics,
    compute_metrics,
    confusion_from_logits,
    torchmetrics_key_names,
)
from floodplanet_code_tpu_torch.train.fit import resolve_ignore_index

FOLD_KEYS = (
    "dataset.name",
    "dataset.sensor",
    "eval_region",
    "train_split_pct",
    "ignore_index",
    "crop_height",
    "crop_width",
    "crop_stride",
    "norm_mode",
    "model.name",
)


def _fold_signature(cfg) -> dict:
    signature = {key: cfg.select(key) for key in FOLD_KEYS}
    # Differently seeded members are the point of an ensemble; the seed
    # matters only when it defines the split itself: with no eval_region
    # the train/val membership is a seeded random draw.
    if not signature["eval_region"]:
        signature["seed_num"] = cfg.select("seed_num")
    return signature


def _best_checkpoint(exp_dir: str) -> str:
    """Explicit checkpoint dir, or the best entry of an experiment dir."""
    if os.path.exists(os.path.join(exp_dir, "index.json")) or not os.path.isdir(
        os.path.join(exp_dir, "checkpoints")
    ):
        # A checkpoint directory passed directly (no checkpoints/ subdir).
        return exp_dir
    with open(os.path.join(exp_dir, "checkpoints", "index.json")) as handle:
        entries = json.load(handle)["entries"]
    if not entries:
        raise ValueError(f"no checkpoints indexed under {exp_dir}")
    best = max(entries, key=lambda e: e["metric"])
    return os.path.join(exp_dir, "checkpoints", best["name"])


def _exp_dir_of(path: str) -> str:
    """Experiment dir owning ``path`` (itself, or two levels up)."""
    if os.path.isdir(os.path.join(path, "hydra")):
        return path
    parent = os.path.dirname(os.path.dirname(os.path.abspath(path)))
    if os.path.isdir(os.path.join(parent, "hydra")):
        return parent
    raise ValueError(f"cannot locate an experiment dir for {path}")


def evaluate_ensemble(
    member_dirs: list[str],
    split: str = "valid",
    batch_size: int | None = None,
    device="cuda",
    devices=None,
) -> dict:
    """Evaluate the softmax-average ensemble of the members' best
    checkpoints. ``devices``: every member replicated to each device, each
    batch split over them (JAX ``eval_ensemble.py:115-179``;
    ``inference_devices``). Raises without a card unless
    ``device="cpu"``."""
    if len(member_dirs) < 2:
        raise ValueError("an ensemble needs at least 2 members")

    exp_dirs = [_exp_dir_of(d) for d in member_dirs]
    cfgs = [load_experiment_config(d) for d in exp_dirs]
    signature = _fold_signature(cfgs[0])
    for exp_dir, cfg in zip(exp_dirs[1:], cfgs[1:]):
        other = _fold_signature(cfg)
        if other != signature:
            diff = {k: (signature[k], other[k]) for k in signature if signature[k] != other[k]}
            raise ValueError(
                f"member {exp_dir} was trained on a different fold than {exp_dirs[0]}: {diff}"
            )
    cfg = cfgs[0]
    devices = inference_devices(cfg, device, devices)
    device = devices[0]
    dataset = build_experiment_dataset(cfg, split)
    ignore_index = resolve_ignore_index(cfg.ignore_index, dataset.n_classes)

    checkpoints = [_best_checkpoint(d) for d in member_dirs]
    models = []
    for exp_cfg, ckpt in zip(cfgs, checkpoints):
        print(f"[ensemble] restoring member: {ckpt}", flush=True)
        models.append(load_model_for_eval(exp_cfg, ckpt, dataset, device))
    print(f"[ensemble] {len(models)} members restored; evaluating on '{split}'", flush=True)
    # Per device, a replica of every member (the members themselves on the
    # first).
    replicas = list(zip(*(replicate(m, devices) for m in models)))

    def member_logits(model_batch) -> list:
        """Each member's logits of the batch, its rows split over the
        devices (``split_apply``) and gathered to the first."""
        parts = split_apply([lambda b, ms=ms: [m(b) for m in ms] for ms in replicas], devices,
                            model_batch)
        return [torch.cat([p[j].to(device, non_blocking=True) for p in parts])
                for j in range(len(models))]

    @torch.inference_mode()
    def eval_step(batch):
        model_batch = {"image": batch["image"].permute(0, 3, 1, 2)}
        for key in AUX_FEATURE_KEYS:
            if key in batch:
                model_batch[key] = batch[key].permute(0, 3, 1, 2)
        valid = batch["valid"].float()[:, None, None]
        probs, member_cms = 0.0, []
        for logits in member_logits(model_batch):
            probs = probs + torch.softmax(logits.float(), dim=1)
            member_cms.append(confusion_from_logits(logits, batch["target"], ignore_index,
                                                    sample_weight=valid))
        # argmax of the averaged probabilities (confusion_from_logits only
        # argmaxes its first argument).
        ensemble_cm = confusion_from_logits(probs / len(models), batch["target"],
                                            ignore_index, sample_weight=valid)
        return ensemble_cm, member_cms

    eval_batch = split_batch_size(batch_size or cfg.batch_size, len(devices))
    loader = BatchLoader(dataset, batch_size=eval_batch, shuffle=False,
                         n_workers=cfg.n_workers, drop_last=False, pad_final=True)
    n_classes = dataset.n_classes
    ensemble_cm = torch.zeros((n_classes, n_classes), device=device)
    member_cms = [torch.zeros((n_classes, n_classes), device=device) for _ in models]
    for n_batches, batch in enumerate(device_prefetch(iter(loader), device, size=2)):
        e_cm, m_cms = eval_step(batch)
        ensemble_cm += e_cm
        for acc, cm in zip(member_cms, m_cms):
            acc += cm
        if n_batches % 20 == 0:
            print(f"[ensemble] batch {n_batches}", flush=True)

    # The "valid" split reports val_* (the monitored-checkpoint prefix),
    # "test" reports test_*, as fit and predict do.
    prefix = "val_" if split == "valid" else f"{split}_"
    key_map = torchmetrics_key_names(prefix)

    def finish(confusion) -> dict:
        metrics = compute_metrics(confusion, prefix, ignore_index)
        metrics.update(compute_binary_class_metrics(confusion, 1, prefix))
        return {key_map.get(k, k): float(v) for k, v in metrics.items()}

    monitor = f"{prefix}MulticlassJaccardIndex"
    ensemble_metrics = finish(ensemble_cm)
    members = [
        {"experiment": exp_dir, "checkpoint": ckpt, "iou": finish(cm)[monitor]}
        for exp_dir, ckpt, cm in zip(exp_dirs, checkpoints, member_cms)
    ]
    return {
        "split": split,
        "fold": {"sensor": cfg.dataset.sensor, "eval_region": cfg.eval_region},
        "members": members,
        "best_member_iou": max(m["iou"] for m in members),
        "ensemble_iou": ensemble_metrics[monitor],
        "ensemble_metrics": ensemble_metrics,
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "member_dirs", nargs="+",
        help="experiment dirs (best retained ckpt used) or checkpoint dirs",
    )
    parser.add_argument("--split", default="valid", choices=("valid", "test"))
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--out", default=None, help="also write JSON here")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    result = evaluate_ensemble(args.member_dirs, split=args.split,
                               batch_size=args.batch_size, device=args.device)
    print(json.dumps(result, indent=2))
    if args.out:
        with open(args.out, "w") as handle:
            json.dump(result, handle, indent=2)
    return result


if __name__ == "__main__":
    main()
