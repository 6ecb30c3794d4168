"""Precompute global normalization parameters per sensor: the port of
``floodplanet_code_tpu/tools/compute_norm_params.py`` (host numpy).

Reference: st_water_seg/misc/compute_dataset_normalization_parameters.py —
samples pixels from the training split (masking zero padding, 21-24;
subsampling, 27-35) and writes per-sensor mean/std used by
``norm_mode=global``. Output here is JSON (data/normalize.py) instead of
pickle.

Usage:
    python -m floodplanet_code_tpu_torch.tools.compute_norm_params \
        --dataset floodplanet [--root_dir PATH] --sensor PS \
        [--pct_sample 0.25] [--eval_region R] [--out dataset_norm_params.json]
"""

from __future__ import annotations

import argparse

import numpy as np

from floodplanet_code_tpu_torch.data import build_dataset, generate_image_slice_object
from floodplanet_code_tpu_torch.data.normalize import (
    load_global_norm_params,
    save_global_norm_params,
)
from floodplanet_code_tpu_torch.data.sensors import normalize_sensor_range, select_channels
from floodplanet_code_tpu_torch.geo import tiff


def compute_norm_params(
    dataset_name: str,
    sensor: str,
    root_dir: str | None = None,
    channels: str = "ALL",
    eval_region=None,
    pct_sample: float = 0.25,
    max_pixels_per_scene: int = 200_000,
    seed: int = 0,
) -> dict:
    """Mean/std per channel over a pixel sample of the train split.

    Zero pixels (scene padding) are masked out, mirroring the reference's
    padding mask (compute_dataset_normalization_parameters.py:21-24).
    """
    kwargs = {"root_dir": root_dir} if root_dir else {}
    slice_params = generate_image_slice_object(512, stride=512)
    dataset = build_dataset(
        dataset_name,
        "train" if eval_region else "all",
        slice_params,
        sensor=sensor,
        channels=channels,
        eval_region=eval_region,
        ignore_index=0,
        seed_num=seed,
        **kwargs,
    )
    rng = np.random.default_rng(seed)
    samples = []
    seen = set()
    for example in dataset.dataset:
        if example.image_path in seen:
            continue
        seen.add(example.image_path)
        if rng.random() > pct_sample and len(seen) > 1:
            continue
        raw = tiff.imread(example.image_path)
        if raw.ndim == 2:
            raw = raw[None]
        raw = select_channels(raw, sensor, channels)
        img = normalize_sensor_range(raw, sensor)
        c = img.shape[0]
        flat = img.reshape(c, -1)
        # Mask zero padding (all-channel zero pixels).
        nonzero = ~(np.abs(flat).sum(axis=0) == 0)
        flat = flat[:, nonzero]
        if flat.shape[1] > max_pixels_per_scene:
            idx = rng.choice(flat.shape[1], max_pixels_per_scene, replace=False)
            flat = flat[:, idx]
        samples.append(flat)
    stacked = np.concatenate(samples, axis=1)
    return {
        "mean": stacked.mean(axis=1).tolist(),
        "std": stacked.std(axis=1).tolist(),
        "n_pixels": int(stacked.shape[1]),
        "n_scenes": len(samples),
    }


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, default="floodplanet")
    parser.add_argument("--root_dir", type=str, default=None)
    parser.add_argument("--sensor", type=str, required=True)
    parser.add_argument("--channels", type=str, default="ALL")
    parser.add_argument("--eval_region", type=str, default=None)
    parser.add_argument("--pct_sample", type=float, default=0.25)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    params = compute_norm_params(
        args.dataset,
        args.sensor,
        root_dir=args.root_dir,
        channels=args.channels,
        eval_region=args.eval_region,
        pct_sample=args.pct_sample,
        seed=args.seed,
    )
    try:
        existing = load_global_norm_params(args.dataset, args.out)
    except (FileNotFoundError, KeyError):
        existing = {}
    existing[args.sensor] = {"mean": params["mean"], "std": params["std"]}
    path = save_global_norm_params(args.dataset, existing, args.out)
    print(
        f"Saved {args.sensor} norm params ({params['n_scenes']} scenes, "
        f"{params['n_pixels']} px) -> {path}"
    )
    return params


if __name__ == "__main__":
    main()
