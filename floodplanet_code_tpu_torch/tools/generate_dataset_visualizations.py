"""Dataset visualization CLI: RGB + mask-overlay GIFs per region. The port
of ``floodplanet_code_tpu/tools/generate_dataset_visualizations.py`` (host
numpy, the port's ``utils/image.py``).

Reference: st_water_seg/misc/generate_dataset_visualizations.py:14-65 —
writes an animated GIF per scene flipping between the RGB view and the
RGB-with-flood-mask overlay.

Usage:
    python -m floodplanet_code_tpu_torch.tools.generate_dataset_visualizations \
        --dataset floodplanet [--root_dir PATH] --sensor PS --out viz/
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from floodplanet_code_tpu_torch.data import build_dataset, generate_image_slice_object
from floodplanet_code_tpu_torch.data.sensors import (
    normalize_sensor_range,
    select_channels,
)
from floodplanet_code_tpu_torch.geo import tiff
from floodplanet_code_tpu_torch.utils.image import create_gif, resize_image


def generate_dataset_visualizations(
    dataset_name: str,
    sensor: str,
    out_dir: str,
    root_dir: str | None = None,
    channels: str = "ALL",
    overlay_alpha: float = 0.5,
) -> list[str]:
    kwargs = {"root_dir": root_dir} if root_dir else {}
    slice_params = generate_image_slice_object(512, stride=512)
    dataset = build_dataset(
        dataset_name,
        "all",
        slice_params,
        sensor=sensor,
        channels=channels,
        ignore_index=0,
        **kwargs,
    )
    written = []
    seen = set()
    for example in dataset.dataset:
        if example.image_path in seen:
            continue
        seen.add(example.image_path)
        raw = tiff.imread(example.image_path)
        if raw.ndim == 2:
            raw = raw[None]
        raw = select_channels(raw, sensor, channels)
        img = normalize_sensor_range(raw, sensor)
        label = tiff.imread(example.label_path)
        if img.shape[1:] != label.shape:
            img = resize_image(img, label.shape[0], label.shape[1])
        rgb = dataset.to_RGB(img)
        rgb_u8 = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        overlay = rgb_u8.copy()
        flood = label == 2
        overlay[flood] = (
            (1 - overlay_alpha) * overlay[flood]
            + overlay_alpha * np.array([0, 100, 255])
        ).astype(np.uint8)
        region_dir = os.path.join(out_dir, example.region_name)
        os.makedirs(region_dir, exist_ok=True)
        name = os.path.splitext(os.path.basename(example.image_path))[0]
        path = os.path.join(region_dir, f"{name}.gif")
        create_gif([rgb_u8, overlay], path)
        written.append(path)
    return written


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, default="floodplanet")
    parser.add_argument("--root_dir", type=str, default=None)
    parser.add_argument("--sensor", type=str, required=True)
    parser.add_argument("--channels", type=str, default="ALL")
    parser.add_argument("--out", type=str, required=True)
    args = parser.parse_args(argv)
    written = generate_dataset_visualizations(
        args.dataset,
        args.sensor,
        args.out,
        root_dir=args.root_dir,
        channels=args.channels,
    )
    print(f"Wrote {len(written)} visualizations under {args.out}")
    return written


if __name__ == "__main__":
    main()
