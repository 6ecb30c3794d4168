"""Unlabeled batch inference CLI (port of
``floodplanet_code_tpu/inference/infer.py``; reference: st_water_seg/infer.py).

Loads a checkpoint, runs sliding-window inference over a dataset split
on the card (through the HBM scene cache when the scenes fit
``tpu.device_data_bytes``), and writes binary flood-water masks as
*georeferenced* uint8 GeoTIFFs per region/scene, carrying the source
scene's geo tags.

The reference forces non-overlapping tiles at infer time
(stride = min(crop_h, crop_w), infer.py:64-65); reproduced here.

The checkpoint is either a directory written by the port's ``fit_model``
(``train/checkpoint.py``; its EMA weights when it has them, as the JAX
``load_model_for_eval`` does) or a weights file written by
``tools/import_jax_params.save_weights`` (orbax checkpoints need JAX; the
bridge converts them). Its experiment config is found as the JAX CLI finds
it: ``<experiment>/<sub>/<checkpoint>`` with the config snapshot under
``<experiment>/hydra/config.yaml``.

    python -m floodplanet_code_tpu_torch.inference.infer \\
        <experiment>/checkpoints/<entry> floodplanet test [--tta] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from floodplanet_code_tpu_torch.config import load_experiment_config
from floodplanet_code_tpu_torch.data import build_dataset, generate_image_slice_object
from floodplanet_code_tpu_torch.device import resolve_device
from floodplanet_code_tpu_torch.geo import tiff
from floodplanet_code_tpu_torch.inference.sliding import (
    resolve_inference_batch_size,
    sliding_window_predict,
)
from floodplanet_code_tpu_torch.models import build_model, resolve_conv_impl
from floodplanet_code_tpu_torch.tools.import_jax_params import load_weights
from floodplanet_code_tpu_torch.train.checkpoint import read_checkpoint


def load_model_for_eval(cfg, weights_path: str, dataset, device="cuda"):
    """Build the configured model on ``device`` and load ``weights_path``
    into it (``strict=True``): a checkpoint directory of ``fit_model``
    (with its ``ema_params`` in place of the parameters when it has them)
    or a weights file. Returns the eval-mode model."""
    compute_dtype = {
        "bfloat16": torch.bfloat16,
        "float32": torch.float32,
    }[cfg.select("tpu.compute_dtype", "bfloat16")]
    model = build_model(
        cfg.model.name,
        dataset.n_channels,
        dataset.n_classes,
        dtype=compute_dtype,
        device=device,
        conv_impl=resolve_conv_impl(cfg),
        **(cfg.model.get("model_kwargs") or {}),
    )
    if os.path.isdir(weights_path):
        payload = read_checkpoint(weights_path)
        state_dict = dict(payload["model"])
        # EMA-trained checkpoints evaluate with the averaged weights, the
        # ones validation selected them by.
        state_dict.update(payload.get("ema_params") or {})
    else:
        state_dict = load_weights(weights_path)
    model.load_state_dict(state_dict, strict=True)
    return model


def build_infer_dataset(cfg, dataset_name: str, split: str, eval_region=None,
                        root_dir: str | None = None):
    """The dataset ``infer`` tiles: non-overlapping crops (reference
    infer.py:64-65), metadata on. ``root_dir`` None reads
    ``dataset_dirs.json``."""
    slice_params = generate_image_slice_object(
        cfg.crop_height,
        cfg.crop_width,
        stride=min(cfg.crop_height, cfg.crop_width),
    )
    dataset_kwargs = dict(cfg.dataset.get("dataset_kwargs") or {})
    if root_dir is not None:
        dataset_kwargs["root_dir"] = root_dir
    return build_dataset(
        dataset_name,
        split,
        slice_params,
        sensor=cfg.dataset.sensor,
        channels=cfg.dataset.channels,
        norm_mode=cfg.norm_mode,
        eval_region=eval_region if eval_region is not None else cfg.eval_region,
        ignore_index=cfg.ignore_index,
        seed_num=cfg.select("seed_num"),
        train_split_pct=cfg.select("train_split_pct", 0.8),
        output_metadata=True,
        **dataset_kwargs,
    )


def infer(
    cfg,
    weights_path: str | None,
    dataset_name: str,
    split: str,
    save_dir: str,
    eval_region=None,
    n_workers: int | None = None,
    tta: bool = False,
    warm=None,
    dataset=None,
    device="cuda",
) -> list[str]:
    """Run inference and export masks; returns the written mask paths.

    ``tta``: dihedral test-time augmentation (8 forwards per tile).
    ``warm``: a model already on ``device`` from an earlier call (then
    ``weights_path`` is not read) — a server keeps one model across
    requests. ``dataset``: a pre-built dataset for the same cfg/split
    (see ``build_infer_dataset``). Raises without a card unless
    ``device="cpu"``.
    """
    device = resolve_device(device)
    if dataset is None:
        dataset = build_infer_dataset(cfg, dataset_name, split, eval_region)
    model = warm
    if model is None:
        model = load_model_for_eval(cfg, weights_path, dataset, device)

    written = []
    for scene in sliding_window_predict(
        model,
        dataset,
        batch_size=resolve_inference_batch_size(cfg),
        n_workers=n_workers or cfg.n_workers,
        device=device,
        tta=tta,
        device_data_bytes=int(cfg.select("tpu.device_data_bytes", 6 << 30) or 0),
    ):
        probs = scene["probabilities"]
        # argmax -> clip to binary water mask (reference infer.py:179-181):
        # class-2 predictions clip to water, matching np.clip(pred, 0, 1).
        mask = np.minimum(probs.argmax(axis=-1), 1).astype(np.uint8)
        region_dir = os.path.join(save_dir, scene["region"] + "_pred")
        os.makedirs(region_dir, exist_ok=True)
        out_path = os.path.join(region_dir, scene["image_name"] + ".tif")
        tiff.imwrite(out_path, mask * 255, geo_from=scene["image_path"])
        written.append(out_path)
    return written


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Batch flood-mask inference from a checkpoint directory "
        "or a weights file."
    )
    parser.add_argument("weights_path", type=str)
    parser.add_argument("dataset_name", type=str)
    parser.add_argument("split", type=str, choices=["train", "valid", "test", "all"])
    parser.add_argument("--eval_region", type=str, default=None)
    parser.add_argument("--save_dir", type=str, default=None)
    parser.add_argument("--n_workers", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument(
        "--tta",
        action="store_true",
        help="Dihedral test-time augmentation: average tile softmax over "
        "the 8 square-symmetry transforms (~8x forward cost).",
    )
    args = parser.parse_args(argv)

    experiment_dir = os.path.dirname(
        os.path.dirname(os.path.normpath(args.weights_path))
    )
    cfg = load_experiment_config(experiment_dir)
    save_dir = args.save_dir or os.path.join(
        experiment_dir, "inference", args.dataset_name, args.split
    )
    written = infer(
        cfg,
        args.weights_path,
        args.dataset_name,
        args.split,
        save_dir,
        eval_region=args.eval_region,
        n_workers=args.n_workers,
        tta=args.tta,
        device=args.device,
    )
    print(f"Wrote {len(written)} masks under {save_dir}")
    return written


if __name__ == "__main__":
    main()
