"""Augmentation visual-regression harness: the port of
``floodplanet_code_tpu/tools/test_image_transforms.py``.

Reference: the module-level ``test_image_transforms`` in
st_water_seg/datasets/floodplanet.py:661-737 — builds the dataset twice
(with and without a forced transform config) and writes before/after GIFs
for eyeball comparison. Here the transform runs through the port's
on-device augmentation (data/augment.py) on ``device`` (the card by
default), so what you see is what training gets; only the GIF encoding
runs on the host.

Usage:
    python -m floodplanet_code_tpu_torch.tools.test_image_transforms \
        [--root_dir PATH] --sensor PS --out aug_viz/ [--angle 45] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from floodplanet_code_tpu_torch.data import build_dataset, generate_image_slice_object
from floodplanet_code_tpu_torch.data.augment import TransformParams, augment_batch
from floodplanet_code_tpu_torch.device import resolve_device
from floodplanet_code_tpu_torch.utils.image import create_gif


def visualize_transforms(
    dataset_name: str,
    sensor: str,
    out_dir: str,
    root_dir: str | None = None,
    channels: str = "ALL",
    angle: float = 45.0,
    n_examples: int = 8,
    crop: int = 256,
    seed: int = 0,
    device="cuda",
) -> list[str]:
    """One before/after GIF per example, ``transform_NNN.gif`` under
    ``out_dir``. Raises without a card unless ``device="cpu"``."""
    device = resolve_device(device)
    kwargs = {"root_dir": root_dir} if root_dir else {}
    dataset = build_dataset(
        dataset_name,
        "all",
        generate_image_slice_object(crop, stride=crop),
        sensor=sensor,
        channels=channels,
        ignore_index=0,
        seed_num=seed,
        **kwargs,
    )
    # Forced transforms: always flip+rotate by a fixed angle, so the
    # before/after comparison is deterministic (reference builds an inline
    # OmegaConf with a forced rotation, floodplanet.py:672-687).
    params = TransformParams(
        hflip_active=True,
        hflip_likelihood=1.0,
        vflip_active=False,
        vflip_likelihood=0.0,
        rotate_active=True,
        rotate_likelihood=1.0,
        min_rot_angle=angle,
        max_rot_angle=angle,
    )
    os.makedirs(out_dir, exist_ok=True)

    def frame(img_hwc: np.ndarray, tgt_hw: np.ndarray) -> np.ndarray:
        rgb = dataset.to_RGB(np.transpose(img_hwc, (2, 0, 1)))
        rgb = (np.clip(np.nan_to_num(rgb), 0, 1) * 255).astype(np.uint8)
        overlay = rgb.copy()
        overlay[tgt_hw == 1] = (0, 100, 255)
        return np.concatenate([rgb, overlay], axis=1)

    written = []
    for index in range(min(n_examples, len(dataset))):
        example = dataset.load_example(index)
        image = torch.from_numpy(example["image"][None]).to(device)
        target = torch.from_numpy(example["target"][None]).to(device)
        generator = torch.Generator(device=device).manual_seed(seed + index)
        aug_img, aug_tgt = augment_batch(generator, image, target, params, 0)
        before = frame(example["image"], example["target"])
        after = frame(aug_img[0].float().cpu().numpy(), aug_tgt[0].cpu().numpy())
        path = os.path.join(out_dir, f"transform_{index:03d}.gif")
        create_gif([before, after], path, image_text=["original", "augmented"])
        written.append(path)
    return written


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, default="floodplanet")
    parser.add_argument("--root_dir", type=str, default=None)
    parser.add_argument("--sensor", type=str, required=True)
    parser.add_argument("--channels", type=str, default="ALL")
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--angle", type=float, default=45.0)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    written = visualize_transforms(
        args.dataset,
        args.sensor,
        args.out,
        root_dir=args.root_dir,
        channels=args.channels,
        angle=args.angle,
        device=args.device,
    )
    print(f"Wrote {len(written)} transform comparisons under {args.out}")
    return written


if __name__ == "__main__":
    main()
