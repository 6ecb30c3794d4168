"""Training CLI: the port of ``floodplanet_code_tpu/fit.py`` (reference
st_water_seg/fit.py:106-112).

    python -m floodplanet_code_tpu_torch.fit [key=value ...] [--device cpu]
    python -m floodplanet_code_tpu_torch.fit dataset.sensor=PS eval_region=RegionA \\
        crop_height=512 crop_width=512 crop_stride=256 batch_size=8

Group swaps (``model=lf_model``), experiment overlays
(``+experiment=unet_csdap_baseline``) and dotted overrides work as in the
JAX package; the composed config is snapshotted to
``<exp>/hydra/config.yaml``. ``-m``/``--multirun`` sweeps comma-separated
override values through their cartesian product, one job after another,
each in ``multirun/<date>/<name>/<job_num>/``; bracketed values
(``key=[a,b]``) are lists, not sweeps. ``--device`` (default ``cuda``)
picks the device; without a card the run raises unless it is ``cpu``.
The fit runs under deterministic algorithms (``train/fit.py``); this CLI
sets ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` for it where it is unset.
"""

from __future__ import annotations

import datetime
import itertools
import os
import sys

from floodplanet_code_tpu_torch.config import compose
from floodplanet_code_tpu_torch.train.fit import fit_model, set_cublas_workspace_config


def _expand_multirun(overrides: list[str]) -> list[list[str]]:
    """Cartesian product of comma-separated override values.

    ``lr=1e-3,1e-4`` contributes two choices; ``regions=[A,B]`` (bracketed)
    and quoted values stay atomic.
    """
    choices_per_key: list[list[str]] = []
    for override in overrides:
        key, _, raw = override.partition("=")
        raw = raw.strip()
        if "," in raw and not raw.startswith(("[", "{", '"', "'")):
            choices_per_key.append([f"{key}={v}" for v in raw.split(",")])
        else:
            choices_per_key.append([override])
    return [list(combo) for combo in itertools.product(*choices_per_key)]


def _pop_device(argv: list[str]) -> str:
    """Remove ``--device X`` / ``--device=X`` from argv; return X."""
    device = "cuda"
    for i, arg in enumerate(argv):
        if arg == "--device":
            device = argv[i + 1]
            del argv[i : i + 2]
            return device
        if arg.startswith("--device="):
            del argv[i]
            return arg.partition("=")[2]
    return device


def main(argv: list[str] | None = None) -> str:
    set_cublas_workspace_config()  # before any CUDA work: the fit is deterministic
    argv = list(sys.argv[1:] if argv is None else argv)
    device = _pop_device(argv)
    multirun = False
    for flag in ("-m", "--multirun"):
        while flag in argv:
            argv.remove(flag)
            multirun = True

    if not multirun:
        best = fit_model(compose(overrides=argv), device=device)
        print(f"Best checkpoint: {best}")
        return best

    jobs = _expand_multirun(argv)
    date = datetime.date.today().isoformat()
    best = ""
    for job_num, job_overrides in enumerate(jobs):
        cfg = compose(overrides=job_overrides)
        name = cfg.select("run.name", "default")
        exp_dir = os.path.join("multirun", date, str(name), str(job_num))
        print(f"[multirun] job {job_num}/{len(jobs) - 1}: " + " ".join(job_overrides))
        best = fit_model(cfg, overwrite_exp_dir=exp_dir, device=device)
        print(f"[multirun] job {job_num} best checkpoint: {best}")
    return best


if __name__ == "__main__":
    main()
