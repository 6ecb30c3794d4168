"""Aggregate cross-validation arms into one pivot table (port of
``floodplanet_code_tpu/tools/summarize_crossval.py``; host only).

Scans experiment-arm output directories (each one produced by
``tools/run_crossval.py``, i.e. containing ``crossval_<SENSOR>.json``
records) and emits a fold x arm pivot of the monitored val IoU, plus
per-arm means and, when the fold was souped (``run_crossval --soup`` or
``tools/soup_checkpoints.py``), the souped val IoU as a second value.

Output: a markdown table on stdout and, with ``--json``, the raw pivot
as one JSON object:

    {"arms": [...], "folds": {"S1/Bangladesh": {"arm": {"iou": x, "soup_iou": y}}},
     "means": {"arm": {"S1": {"mean": m, "n": k}, "all": {...}}}}

Usage:
    python -m floodplanet_code_tpu_torch.tools.summarize_crossval \\
        outputs/cv_a outputs/cv_b [--ensemble_dir outputs/ensemble] [--json out.json]

``--ensemble_dir`` adds a column from ``eval_ensemble --out`` records
(one ``<fold>.json`` per fold).
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def load_arm(arm_dir: str) -> dict[str, dict]:
    """{"<sensor>/<region>": fold_record} for every recorded fold."""
    folds: dict[str, dict] = {}
    for path in sorted(glob.glob(os.path.join(arm_dir, "crossval_*.json"))):
        with open(path) as handle:
            record = json.load(handle)
        for fold in record.get("folds", []):
            if fold.get("best_val_iou") is None:
                continue
            folds[f'{fold["sensor"]}/{fold["region"]}'] = fold
    # Folds souped after the CV run carry their result in
    # <exp>/checkpoints/soup-*/soup.json, not in the CV record.
    for soup_path in sorted(
        glob.glob(os.path.join(arm_dir, "*", "checkpoints", "soup-*", "soup.json"))
    ):
        exp_name = os.path.basename(
            os.path.dirname(os.path.dirname(os.path.dirname(soup_path)))
        )
        sensor, _, region = exp_name.partition("_")
        key = f"{sensor}/{region}"
        if key in folds and "soup_val_iou" not in folds[key]:
            with open(soup_path) as handle:
                soup = json.load(handle)
            if soup.get("soup_val_iou") is not None:
                folds[key]["soup_val_iou"] = soup["soup_val_iou"]
    return folds


def load_ensemble_arm(ensemble_dir: str) -> dict[str, dict]:
    """Fold records from ``eval_ensemble --out`` JSONs (<fold>.json),
    shaped like a CV arm: ``best_val_iou`` carries the ensemble IoU."""
    folds: dict[str, dict] = {}
    for path in sorted(glob.glob(os.path.join(ensemble_dir, "*.json"))):
        with open(path) as handle:
            record = json.load(handle)
        if "ensemble_iou" not in record:
            continue
        fold = record.get("fold") or {}
        sensor, region = fold.get("sensor"), fold.get("eval_region")
        if not sensor or not region:
            sensor, _, region = os.path.splitext(os.path.basename(path))[0].partition("_")
        folds[f"{sensor}/{region}"] = {
            "sensor": sensor,
            "region": region,
            "best_val_iou": record["ensemble_iou"],
        }
    return folds


def build_pivot(arm_dirs: list[str], ensemble_dirs: list[str] = ()) -> dict:
    arms = [os.path.basename(os.path.normpath(d)) for d in arm_dirs]
    per_arm = [load_arm(d) for d in arm_dirs]
    for ensemble_dir in ensemble_dirs:
        arms.append(os.path.basename(os.path.normpath(ensemble_dir)))
        per_arm.append(load_ensemble_arm(ensemble_dir))
    fold_keys = sorted({k for folds in per_arm for k in folds})
    pivot: dict[str, dict] = {k: {} for k in fold_keys}
    for arm, folds in zip(arms, per_arm):
        for key, fold in folds.items():
            cell = {"iou": fold["best_val_iou"]}
            if fold.get("soup_val_iou") is not None:
                cell["soup_iou"] = fold["soup_val_iou"]
            pivot[key][arm] = cell

    means: dict[str, dict] = {}
    for arm, folds in zip(arms, per_arm):
        by_sensor: dict[str, list[float]] = {}
        for key, fold in folds.items():
            by_sensor.setdefault(key.split("/")[0], []).append(fold["best_val_iou"])
        arm_means = {
            sensor: {"mean": sum(v) / len(v), "n": len(v)}
            for sensor, v in sorted(by_sensor.items())
        }
        everything = [v for vs in by_sensor.values() for v in vs]
        if everything:
            arm_means["all"] = {"mean": sum(everything) / len(everything), "n": len(everything)}
        means[arm] = arm_means
    return {"arms": arms, "folds": pivot, "means": means}


def format_markdown(pivot: dict) -> str:
    arms = pivot["arms"]

    def cell(entry) -> str:
        if not entry:
            return "—"
        text = f'{entry["iou"]:.3f}'
        if "soup_iou" in entry:
            text += f' (soup {entry["soup_iou"]:.3f})'
        return text

    lines = [
        "| fold | " + " | ".join(arms) + " |",
        "|---" * (len(arms) + 1) + "|",
    ]
    for key, row in pivot["folds"].items():
        lines.append(f"| {key} | " + " | ".join(cell(row.get(a)) for a in arms) + " |")
    sensors = sorted({k.split("/")[0] for k in pivot["folds"]})
    n_per_sensor = {
        s: sum(1 for k in pivot["folds"] if k.split("/")[0] == s) for s in sensors
    }
    n_per_sensor["all"] = len(pivot["folds"])

    def mean_cell(arm: str, sensor: str) -> str:
        entry = pivot["means"].get(arm, {}).get(sensor)
        if entry is None:
            return "—"
        text = f'{entry["mean"]:.3f}'
        # Flag means over a subset of the table's folds (partial arms).
        if entry["n"] != n_per_sensor[sensor]:
            text += f' (n={entry["n"]})'
        return text

    for sensor in sensors + ["all"]:
        lines.append(
            f"| mean {sensor} | " + " | ".join(mean_cell(a, sensor) for a in arms) + " |"
        )
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("arm_dirs", nargs="+", help="run_crossval --out_dir directories")
    parser.add_argument("--json", default=None, help="also write the raw pivot to this path")
    parser.add_argument(
        "--ensemble_dir",
        action="append",
        default=[],
        help="eval_ensemble output dir (<fold>.json files), added as an extra arm column",
    )
    args = parser.parse_args(argv)
    missing = [d for d in args.arm_dirs + args.ensemble_dir if not os.path.isdir(d)]
    if missing:
        parser.error(f"not a directory: {missing}")
    pivot = build_pivot(args.arm_dirs, args.ensemble_dir)
    print(format_markdown(pivot))
    if args.json:
        with open(args.json, "w") as handle:
            json.dump(pivot, handle, indent=2)


if __name__ == "__main__":
    main()
