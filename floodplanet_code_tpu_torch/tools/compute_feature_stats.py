"""Input-feature statistics CLI: the port of
``floodplanet_code_tpu/tools/compute_feature_stats.py`` (host numpy).

Reference: st_water_seg/misc/compute_input_feature_stats.py:11-49 — reports
min / max / 5th / 95th percentile per input feature over the dataset.

Usage:
    python -m floodplanet_code_tpu_torch.tools.compute_feature_stats \
        --dataset floodplanet [--root_dir PATH] --sensor S1 \
        [--feature_names 'image|dem|slope']
"""

from __future__ import annotations

import argparse

import numpy as np

from floodplanet_code_tpu_torch.data import build_dataset, generate_image_slice_object


def compute_feature_stats(
    dataset_name: str,
    sensor: str,
    root_dir: str | None = None,
    channels: str = "ALL",
    feature_names: list[str] | None = None,
    max_examples: int = 200,
    seed: int = 0,
) -> dict:
    kwargs = {"root_dir": root_dir} if root_dir else {}
    slice_params = generate_image_slice_object(256, stride=256)
    dataset = build_dataset(
        dataset_name,
        "all",
        slice_params,
        sensor=sensor,
        channels=channels,
        ignore_index=0,
        seed_num=seed,
        **kwargs,
    )
    feature_names = feature_names or ["image"]
    rng = np.random.default_rng(seed)
    indices = rng.permutation(len(dataset))[:max_examples]
    collected: dict[str, list] = {name: [] for name in feature_names}
    for index in indices:
        example = dataset.load_example(int(index))
        for name in feature_names:
            if name in example:
                collected[name].append(np.asarray(example[name]).ravel())
    stats = {}
    for name, values in collected.items():
        if not values:
            continue
        flat = np.concatenate(values)
        stats[name] = {
            "min": float(flat.min()),
            "max": float(flat.max()),
            "pct_5": float(np.percentile(flat, 5)),
            "pct_95": float(np.percentile(flat, 95)),
            "mean": float(flat.mean()),
            "std": float(flat.std()),
        }
    return stats


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, default="floodplanet")
    parser.add_argument("--root_dir", type=str, default=None)
    parser.add_argument("--sensor", type=str, required=True)
    parser.add_argument("--channels", type=str, default="ALL")
    parser.add_argument(
        "--feature_names",
        type=str,
        default="image",
        help="Pipe-separated feature names, e.g. 'image|dem|slope'",
    )
    args = parser.parse_args(argv)
    stats = compute_feature_stats(
        args.dataset,
        args.sensor,
        root_dir=args.root_dir,
        channels=args.channels,
        feature_names=args.feature_names.split("|"),
    )
    for name, values in stats.items():
        print(f"{name}:")
        for key, value in values.items():
            print(f"  {key}: {value:.6g}")
    return stats


if __name__ == "__main__":
    main()
