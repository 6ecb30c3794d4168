"""Leave-one-region-out cross-validation over a sensor's regions (port of
``floodplanet_code_tpu/tools/run_crossval.py``).

Reproduces the reference's published experiment recipe (300x300 crops,
stride 150, 11 epochs, Adam lr 1e-4, hflip/vflip/rotate p=0.5, seed 0)
over every held-out region of a sensor, and records the best val IoU per
fold: the statistic the reference's checkpoint filenames encode.

Usage:
    python -m floodplanet_code_tpu_torch.tools.run_crossval \\
        --sensor S1 --regions Bangladesh US-Carolina US-Nebraska \\
        --batch_size 8 --out_dir outputs/cv --results results_S1.json [--soup] [--device cpu]

Each fold runs the port's ``fit_model`` to completion and reads the best
val_MulticlassJaccardIndex from the checkpoint index. ``run_fold``
overrides the shipped ignore_index=0 with -1 (see the comment there), so
the monitored statistic is the micro Jaccard over {dry, flood} with nodata
ignored. The water-class-only IoU is recorded beside it as
best_val_water_iou. The dataset root comes from ``dataset_dirs.json`` in
the working directory, as for every entry point, unless an ``--override
dataset.dataset_kwargs.root_dir=...`` names it.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from floodplanet_code_tpu_torch.config import compose
from floodplanet_code_tpu_torch.train.checkpoint import CheckpointManager
from floodplanet_code_tpu_torch.train.fit import fit_model


def run_fold(
    sensor: str,
    region: str,
    batch_size: int,
    out_dir: str,
    n_epochs: int,
    extra_overrides: list[str],
    soup: bool = False,
    device="cuda",
) -> dict:
    exp_dir = os.path.join(out_dir, f"{sensor}_{region}")
    overrides = [
        f"dataset.sensor={sensor}",
        f"eval_region={region}",
        f"batch_size={batch_size}",
        f"n_epochs={n_epochs}",
        "crop_height=300",
        "crop_width=300",
        "crop_stride=150",
        "lr=1e-4",
        "optimizer=adam",
        # The reference config ships ignore_index=0, but that makes CE
        # ignore the dry class (training collapses to all-flood) and
        # reduces the monitored IoU to flood recall. The published
        # 0.25-0.88 per-region IoUs are only consistent with the -1 path:
        # nodata -> class 2 (ignored), micro IoU over {dry, flood}.
        "ignore_index=-1",
        "seed_num=0",
        "norm_mode=null",
        *extra_overrides,
    ]
    cfg = compose(overrides=overrides)
    start = time.time()
    best_path = fit_model(cfg, overwrite_exp_dir=exp_dir, device=device)
    wall = time.time() - start

    manager = CheckpointManager(exp_dir, async_save=False)
    entries = manager._index["entries"]
    best = max(entries, key=lambda e: e["metric"]) if entries else None
    water_iou = None
    if best is not None:
        metrics_path = os.path.join(manager.ckpt_dir, best["name"], "metrics.json")
        if os.path.exists(metrics_path):
            with open(metrics_path) as handle:
                water_iou = json.load(handle).get("val_water_IoU")
    record = {
        "sensor": sensor,
        "region": region,
        "best_val_iou": best["metric"] if best else None,
        "best_val_water_iou": water_iou,
        "best_epoch": best["epoch"] if best else None,
        "best_checkpoint": best_path,
        "wall_seconds": round(wall, 1),
        "n_epochs": n_epochs,
        "batch_size": batch_size,
    }
    # The fit's wall-clock decomposition (train/eval/ckpt per epoch).
    timing_path = os.path.join(exp_dir, "timing.json")
    if os.path.exists(timing_path):
        with open(timing_path) as handle:
            timing = json.load(handle)
        record["timing"] = {k: v for k, v in timing.items() if k != "epochs"}
    if soup and best is not None:
        # Greedy checkpoint soup over the retained top-k
        # (tools/soup_checkpoints.py): the re-scored val IoU of the averaged
        # weights beside the best single epoch.
        from floodplanet_code_tpu_torch.tools.soup_checkpoints import soup_experiment

        try:
            soup_summary = soup_experiment(exp_dir, mode="greedy", device=device)
            record["soup_val_iou"] = soup_summary["soup_val_iou"]
            record["soup_base_val_iou"] = soup_summary["base_val_iou"]
            record["soup_n_ingredients"] = len(soup_summary["ingredients_used"])
            record["soup_checkpoint"] = soup_summary["checkpoint"]
        except Exception as exc:  # the soup is additive; never fail the fold
            print(f"[crossval] soup failed for {sensor}/{region}: {exc!r}")
    return record


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--sensor", required=True)
    parser.add_argument("--regions", nargs="+", required=True)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--n_epochs", type=int, default=11)
    parser.add_argument("--out_dir", default="outputs/cv")
    parser.add_argument("--results", default=None, help="results json path")
    parser.add_argument("--override", action="append", default=[], help="extra cfg overrides")
    parser.add_argument(
        "--soup",
        action="store_true",
        help="after each fold, greedy-soup the top-k checkpoints and record the souped "
        "val IoU (tools/soup_checkpoints.py)",
    )
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    results_path = args.results or os.path.join(args.out_dir, f"crossval_{args.sensor}.json")
    os.makedirs(args.out_dir, exist_ok=True)
    folds = []
    summary = None
    # Resume: skip folds already recorded, so a preempted run picks up.
    if os.path.exists(results_path):
        with open(results_path) as handle:
            summary = json.load(handle)
        folds = summary.get("folds", [])
    done = {f["region"] for f in folds}

    for region in args.regions:
        if region in done:
            print(f"[crossval] {args.sensor}/{region}: already done, skipping")
            continue
        print(f"[crossval] === {args.sensor} leave-{region}-out ===")
        fold = run_fold(args.sensor, region, args.batch_size, args.out_dir, args.n_epochs,
                        args.override, soup=args.soup, device=args.device)
        folds.append(fold)
        ious = [f["best_val_iou"] for f in folds if f["best_val_iou"] is not None]
        # Provenance reflects the run: the effective seed and epochs, and
        # the extra overrides verbatim.
        seed = next(
            (o.split("=", 1)[1] for o in reversed(args.override) if o.startswith("seed_num=")),
            "0",
        )
        summary = {
            "sensor": args.sensor,
            "recipe": f"300x300 stride 150, {args.n_epochs} epochs, adam "
            f"1e-4, aug p=0.5, ignore_index -1, seed {seed} (reference "
            "conf/config.yaml:17-52; see run_fold for why -1 replaces the "
            "shipped ignore_index=0)",
            "overrides": list(args.override),
            "mean_best_val_iou": sum(ious) / len(ious) if ious else None,
            "folds": folds,
        }
        with open(results_path, "w") as handle:
            json.dump(summary, handle, indent=2)
        print(f"[crossval] {region}: best val IoU {fold['best_val_iou']} "
              f"(epoch {fold['best_epoch']}, {fold['wall_seconds']}s)")

    # summary stays None only when no fold ran and no results file existed.
    if summary is not None:
        print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
