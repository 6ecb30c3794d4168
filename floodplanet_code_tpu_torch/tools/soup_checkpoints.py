"""Checkpoint soup: average the retained top-k checkpoints of one run (port
of ``floodplanet_code_tpu/tools/soup_checkpoints.py``).

Model soups (Wortsman et al. 2022) average the *weights* of several
snapshots; here the ingredients are the top-k epoch checkpoints the
checkpoint manager retains (``train/checkpoint.py``, best by
val_MulticlassJaccardIndex): snapshots along one trajectory.

Two modes:
- ``uniform``: average all ingredients.
- ``greedy`` (default): order ingredients by their stored val metric,
  start from the best one, and keep each addition only if the val IoU
  (re-measured on the fold's validation split) does not drop.

What is averaged: the weights evaluation uses (``ema_params`` when the run
trained with EMA, else the parameters) together with the BatchNorm
running means and variances, as one state dict per ingredient
(``train/checkpoint.py::eval_state_dict``), uniformly in f32.

The soup is written in the port's checkpoint format as
``<exp>/checkpoints/soup-<mode>/checkpoint.pt`` ({model, step,
ema_params}; no optimizer state) with ``metrics.json`` and ``soup.json``,
loadable by ``predict``/``infer`` like any other checkpoint. It is not
registered in ``index.json``: the index drives top-k retention and resume.

The evaluator scores a state dict with the port's ``make_eval_step`` over
the HBM scene cache, or over the host loader when ``build_device_cache``
returns None (over budget); any other failure of the cache raises. Every
candidate is loaded into the one model with ``load_state_dict`` (an
in-place copy that moves the tensors' versions), so the eval pack cache
re-packs for it (``models/unet.py::DoubleConv._pack_key``).

Usage:
    python -m floodplanet_code_tpu_torch.tools.soup_checkpoints <exp_dir> \\
        [--mode greedy|uniform] [--max_k N] [--no_eval] [--batch_size N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np
import torch

from floodplanet_code_tpu_torch.config import load_experiment_config
from floodplanet_code_tpu_torch.data import BatchLoader, device_prefetch
from floodplanet_code_tpu_torch.data.device_cache import build_device_cache, cache_batches
from floodplanet_code_tpu_torch.device import resolve_device
from floodplanet_code_tpu_torch.inference.infer import (
    build_experiment_dataset,
    load_model_for_eval,
)
from floodplanet_code_tpu_torch.ops.metrics import (
    compute_binary_class_metrics,
    compute_metrics,
    torchmetrics_key_names,
)
from floodplanet_code_tpu_torch.train.checkpoint import (
    CHECKPOINT_FILE,
    MONITOR_KEY,
    eval_state_dict,
    read_checkpoint,
)
from floodplanet_code_tpu_torch.train.fit import make_eval_step, resolve_ignore_index
from floodplanet_code_tpu_torch.train.state import TrainState


def average_state_dicts(state_dicts: list[dict]) -> dict:
    """Uniform elementwise mean of identically keyed state dicts:
    ``sum(xs) / n`` per tensor, in its dtype (f32), as the JAX package's
    ``average_trees``."""
    n = float(len(state_dicts))
    return {key: sum(sd[key] for sd in state_dicts) / n for key in state_dicts[0]}


def load_ingredients(exp_dir: str, cfg, dataset, max_k: int | None = None, device="cuda"):
    """The index's top-k checkpoints, best stored metric first.

    Returns (entries, payloads, model): the index entries sorted by stored
    metric (desc), their checkpoint payloads (tensors on the CPU) in the
    same order, and the configured model on ``device`` with the best
    entry's evaluation weights loaded.
    """
    ckpt_dir = os.path.join(exp_dir, "checkpoints")
    with open(os.path.join(ckpt_dir, "index.json")) as handle:
        entries = json.load(handle)["entries"]
    entries = sorted(entries, key=lambda e: e["metric"], reverse=True)
    if max_k:
        entries = entries[:max_k]
    if not entries:
        raise ValueError(f"no checkpoints indexed under {ckpt_dir}")
    paths = [os.path.join(ckpt_dir, e["name"]) for e in entries]
    model = load_model_for_eval(cfg, paths[0], dataset, device)
    return entries, [read_checkpoint(p) for p in paths], model


def make_val_evaluator(cfg, dataset, model, ignore_index: int, device="cuda"):
    """Validation-split evaluator: ``evaluate(state_dict) -> metrics``.

    Loads the state dict into ``model`` and runs fit_model's validation
    pass over the whole split (no shuffle, the padded final batch masked
    by ``valid``), so the returned val_MulticlassJaccardIndex is comparable
    to the stored checkpoint metrics.
    """
    device = resolve_device(device)
    batch_size = int(cfg.batch_size)
    n_classes = dataset.n_classes
    eval_step = make_eval_step(model, ignore_index)
    state = TrainState(model=model, optimizer=None, schedule=None)
    cache = None
    cache_bytes = int(cfg.select("tpu.device_data_bytes", 6 << 30) or 0)
    if cache_bytes > 0:
        cache = build_device_cache(dataset, cache_bytes, device, cfg.n_workers)

    def batches():
        if cache is not None:
            order = np.arange(len(dataset))
            for batch, _, n_real in cache_batches(cache, dataset, batch_size, order):
                batch["valid"] = torch.arange(batch_size, device=device) < n_real
                yield batch
        else:
            loader = BatchLoader(dataset, batch_size=batch_size, shuffle=False,
                                 n_workers=cfg.n_workers, drop_last=False, pad_final=True)
            yield from device_prefetch(iter(loader), device, size=2)

    key_map = torchmetrics_key_names("val_")

    def evaluate(state_dict: dict) -> dict:
        model.load_state_dict(state_dict, strict=True)
        confusion = torch.zeros((n_classes, n_classes), device=device)
        losses = []
        for batch in batches():
            logs = eval_step(state, batch)
            confusion += logs["confusion"]
            losses.append(logs["loss"])
        metrics = compute_metrics(confusion, "val_", ignore_index)
        metrics.update(compute_binary_class_metrics(confusion, 1, "val_"))
        out = {key_map.get(k, k): float(v) for k, v in metrics.items()}
        out["valid_loss"] = float(torch.stack(losses).mean())
        return out

    return evaluate


def soup_experiment(
    exp_dir: str,
    mode: str = "greedy",
    max_k: int | None = None,
    no_eval: bool = False,
    batch_size: int | None = None,
    out_name: str | None = None,
    device="cuda",
) -> dict:
    """Build, (optionally) evaluate, and save a checkpoint soup; returns
    the summary dict (also written next to the soup checkpoint). Raises
    without a card unless ``device="cpu"``."""
    if mode not in ("greedy", "uniform"):
        raise ValueError(f'soup mode must be greedy|uniform, got "{mode}"')
    if mode == "greedy" and no_eval:
        raise ValueError("greedy soup needs validation evals; drop --no_eval")
    device = resolve_device(device)

    cfg = load_experiment_config(exp_dir)
    if batch_size:
        cfg.batch_size = batch_size
    valid_dataset = build_experiment_dataset(cfg, "valid")
    ignore_index = resolve_ignore_index(cfg.ignore_index, valid_dataset.n_classes)

    entries, payloads, model = load_ingredients(exp_dir, cfg, valid_dataset, max_k, device)
    weights = [eval_state_dict(p) for p in payloads]
    evaluate = None
    if not no_eval:
        evaluate = make_val_evaluator(cfg, valid_dataset, model, ignore_index, device)

    chosen = list(range(len(entries)))
    per_ingredient = [
        {"name": e["name"], "epoch": e["epoch"], "stored_metric": e["metric"]} for e in entries
    ]
    if mode == "uniform":
        soup = average_state_dicts(weights)
        soup_metrics = evaluate(soup) if evaluate is not None else {}
    else:
        # Greedy (Wortsman et al. alg. 1): ingredients in stored-metric
        # order; keep an addition iff val IoU does not drop.
        chosen = [0]
        soup = weights[0]
        soup_metrics = evaluate(soup)
        best = base_val_iou = soup_metrics[MONITOR_KEY]
        per_ingredient[0]["greedy"] = f"base (val {best:.4f})"
        for i in range(1, len(entries)):
            cand = chosen + [i]
            cand_soup = average_state_dicts([weights[j] for j in cand])
            cand_metrics = evaluate(cand_soup)
            iou = cand_metrics[MONITOR_KEY]
            if iou >= best:
                chosen, soup, soup_metrics, best = cand, cand_soup, cand_metrics, iou
                per_ingredient[i]["greedy"] = f"kept (val {iou:.4f})"
            else:
                per_ingredient[i]["greedy"] = f"dropped (val {iou:.4f})"

    # A regular checkpoint directory (loadable by predict/infer): the soup
    # goes to the model and, when the run trained with EMA, to ema_params
    # too (evaluation loads ema_params when present).
    ema = payloads[0].get("ema_params")
    name = out_name or f"soup-{mode}"
    path = os.path.join(exp_dir, "checkpoints", name)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save({"model": soup, "step": payloads[0]["step"],
                "ema_params": None if ema is None else {k: soup[k] for k in ema}},
               os.path.join(path, CHECKPOINT_FILE))

    summary = {
        "mode": mode,
        "checkpoint": path,
        "n_ingredients_available": len(entries),
        "ingredients_used": [entries[i]["name"] for i in chosen],
        "per_ingredient": per_ingredient,
        "best_single_stored_metric": entries[0]["metric"],
        "soup_val_metrics": soup_metrics,
    }
    if mode == "greedy":
        # Re-measured val IoU of the best single checkpoint (the greedy
        # base): by construction soup_val_iou >= base_val_iou.
        summary["base_val_iou"] = base_val_iou
    if soup_metrics:
        summary["soup_val_iou"] = soup_metrics.get(MONITOR_KEY)
        with open(os.path.join(path, "metrics.json"), "w") as handle:
            json.dump(soup_metrics | {"soup": summary["ingredients_used"]}, handle, indent=2)
    with open(os.path.join(path, "soup.json"), "w") as handle:
        json.dump(summary, handle, indent=2)
    return summary


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("exp_dir", help="experiment dir with checkpoints/")
    parser.add_argument("--mode", default="greedy", choices=("greedy", "uniform"))
    parser.add_argument("--max_k", type=int, default=None,
                        help="cap the number of ingredients (default: all)")
    parser.add_argument("--no_eval", action="store_true",
                        help="skip validation evals (uniform mode only)")
    parser.add_argument("--batch_size", type=int, default=None, help="override eval batch size")
    parser.add_argument("--out_name", default=None,
                        help="soup checkpoint dir name (default soup-<mode>)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    summary = soup_experiment(
        args.exp_dir,
        mode=args.mode,
        max_k=args.max_k,
        no_eval=args.no_eval,
        batch_size=args.batch_size,
        out_name=args.out_name,
        device=args.device,
    )
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
