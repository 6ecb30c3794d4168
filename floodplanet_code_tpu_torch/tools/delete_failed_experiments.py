"""Experiment GC: delete output dirs of runs that died early. The port of
``floodplanet_code_tpu/tools/delete_failed_experiments.py``.

Reference: st_water_seg/misc/delete_failed_experiments.py:8-27 — removes
experiment directories containing at most ``max_entries`` files (runs that
crashed before producing checkpoints).

Usage:
    python -m floodplanet_code_tpu_torch.tools.delete_failed_experiments \
        --outputs_dir outputs/ [--max_entries 2] [--dry_run]
"""

from __future__ import annotations

import argparse
import os
import shutil
from glob import glob


def delete_failed_experiments(
    outputs_dir: str, max_entries: int = 2, dry_run: bool = False
) -> list[str]:
    deleted = []
    for exp_dir in sorted(glob(os.path.join(outputs_dir, "*", "*"))):
        if not os.path.isdir(exp_dir):
            continue
        # A healthy experiment has hydra/, checkpoints/, tensorboard_logs/...
        n_entries = len(os.listdir(exp_dir))
        has_ckpt = os.path.isdir(os.path.join(exp_dir, "checkpoints")) and bool(
            os.listdir(os.path.join(exp_dir, "checkpoints"))
        )
        if n_entries <= max_entries and not has_ckpt:
            deleted.append(exp_dir)
            if not dry_run:
                shutil.rmtree(exp_dir)
    return deleted


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--outputs_dir", type=str, default="outputs")
    parser.add_argument("--max_entries", type=int, default=2)
    parser.add_argument("--dry_run", action="store_true")
    args = parser.parse_args(argv)
    deleted = delete_failed_experiments(
        args.outputs_dir, args.max_entries, args.dry_run
    )
    verb = "Would delete" if args.dry_run else "Deleted"
    print(f"{verb} {len(deleted)} failed experiment dirs")
    for path in deleted:
        print(f"  {path}")
    return deleted


if __name__ == "__main__":
    main()
