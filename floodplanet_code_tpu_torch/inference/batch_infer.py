"""Time-series batch inference driver (port of
``floodplanet_code_tpu/inference/batch_infer.py``; reference: Batch_infer.sh).

The reference loops over scene directories with a shell script that
jq-rewrites ``dataset_dirs.json`` and invokes infer.py per scene
(Batch_infer.sh:12-26). This driver runs the same loop in-process: for
each scene root, point the dataset at it and export masks, without
touching a shared json file on disk. One model is loaded and kept on the
card for every root (the JAX driver restores it per root); it is rebuilt
only when a root's channels or classes differ.

    python -m floodplanet_code_tpu_torch.inference.batch_infer \\
        <checkpoint> <dataset_name> --roots <dir1> <dir2> ... \\
        [--split all] [--save_dir out/] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

from floodplanet_code_tpu_torch.config import load_experiment_config
from floodplanet_code_tpu_torch.device import resolve_device
from floodplanet_code_tpu_torch.inference.infer import (
    build_infer_dataset,
    infer,
    load_model_for_eval,
    model_key,
)


def batch_infer(
    checkpoint_path: str,
    dataset_name: str,
    roots: list[str],
    split: str = "all",
    save_dir: str | None = None,
    n_workers: int | None = None,
    device="cuda",
) -> dict:
    """Masks for every root, ``{root: [mask paths]}``, written under
    ``<save_dir>/<root's basename>/``. Raises without a card unless
    ``device="cpu"``."""
    device = resolve_device(device)
    experiment_dir = os.path.dirname(os.path.dirname(os.path.normpath(checkpoint_path)))
    cfg = load_experiment_config(experiment_dir)
    if save_dir is None:
        save_dir = os.path.join(experiment_dir, "batch_inference")
    results = {}
    model, key = None, None
    for root in roots:
        dataset = build_infer_dataset(cfg, dataset_name, split, root_dir=root)
        if model is None or model_key(dataset) != key:
            model = load_model_for_eval(cfg, checkpoint_path, dataset, device)
            key = model_key(dataset)
        out_dir = os.path.join(save_dir, os.path.basename(os.path.normpath(root)))
        written = infer(cfg, checkpoint_path, dataset_name, split, out_dir,
                        n_workers=n_workers, warm=model, dataset=dataset, device=device)
        results[root] = written
        print(f"[batch_infer] {root}: {len(written)} masks -> {out_dir}")
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Flood masks for several scene roots from one warm model."
    )
    parser.add_argument("checkpoint_path", type=str)
    parser.add_argument("dataset_name", type=str)
    parser.add_argument("--roots", type=str, nargs="+", required=True)
    parser.add_argument("--split", type=str, default="all")
    parser.add_argument("--save_dir", type=str, default=None)
    parser.add_argument("--n_workers", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    return batch_infer(
        args.checkpoint_path,
        args.dataset_name,
        args.roots,
        split=args.split,
        save_dir=args.save_dir,
        n_workers=args.n_workers,
        device=args.device,
    )


if __name__ == "__main__":
    main()
