"""Which ops of the port's train step are not deterministic, and what they move.

One train step (bf16, and f32 on one rank) of chip_smoke.py's seeded full-width EF UNet (4 PS
bands, 3 classes, Adam 1e-4) on a seed-0 numpy batch (``target = image[...,
0] > 0``, as bench.py draws it), run twice from the same weights under
``torch.use_deterministic_algorithms(True, warn_only=True)`` with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` and with them off, each with the
model's upsample backward and with ``F.interpolate``'s: at ``--tile``^2,
batch ``--batch``, for ``conv_impl`` xla and pallas_fused on one rank;
then the spatial step of a 1 x 2 data x space mesh (two ranks sharing the
device over gloo) at ``--sp_tile``^2. Prints one JSON line: which of a few
single ops raise under strict deterministic algorithms; per run, every
warning torch raised (each names the op it calls nondeterministic), the
loss of both steps, and the tensors that differ between them (parameters,
their gradients, Adam's two moments, the running statistics): how many
elements and the largest difference against the tensor's largest element.

    python scripts/torch_determinism.py                       # on a card
    python scripts/torch_determinism.py --costs     # the mode's cost, profiled
    python scripts/torch_determinism.py --device cpu --tile 32 --sp_tile 50 \\
        --base 8 --batch 2                                    # a CPU rehearsal
"""

from __future__ import annotations

import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import argparse  # noqa: E402
import contextlib  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from floodplanet_code_tpu_torch.data.augment import TransformParams  # noqa: E402
from floodplanet_code_tpu_torch.train import make_train_step  # noqa: E402


def make_batch(tile: int, batch: int) -> dict:
    image = np.random.default_rng(0).standard_normal((batch, tile, tile, 4)).astype(np.float32)
    return {"image": image, "target": (image[..., 0] > 0).astype(np.int64)}


def one_step(spec: dict, block: dict, conv_impl: str, device, group=None, space=None) -> dict:
    """One train step from the seeded weights; everything it moved, on the host."""
    model, state = cs._md_model(spec, spec["dtype"], device, group, space, conv_impl)
    step = make_train_step(model, 0, TransformParams(False, 0, False, 0, False, 0),
                           fuse_augmentation=False, group=group)
    _, logs = step(state, block)
    out = {"loss": logs["loss"].item()}
    for name, p in model.named_parameters():
        out[f"param {name}"] = p.detach().cpu().clone()
        out[f"grad {name}"] = p.grad.detach().cpu().clone()
        moments = state.optimizer.state[p]
        for key in ("exp_avg", "exp_avg_sq"):
            out[f"{key} {name}"] = moments[key].detach().cpu().clone()
    for name, b in model.named_buffers():
        out[f"stat {name}"] = b.detach().cpu().clone()
    return out


def compare(a: dict, b: dict) -> dict:
    """The tensors that differ: {name: [elements, max |a - b| / max |a|]}."""
    differ = {}
    for key, t in a.items():
        if key == "loss" or torch.equal(t, b[key]):
            continue
        d = (t.double() - b[key].double()).abs()
        differ[key] = [int((d > 0).sum()), (d.max() / t.double().abs().max().clamp_min(1e-30)).item()]
    return differ


@contextlib.contextmanager
def upsample(kind: str):
    """``kind`` "port": the model's upsample as it is; "interpolate": as it
    was before it had its own backward, ``F.interpolate`` (which, under
    deterministic algorithms on a card, computes a decomposition)."""
    from floodplanet_code_tpu_torch.models import unet

    port = unet._upsample2x
    if kind == "interpolate":
        unet._upsample2x = cs._interpolate_as_before
    try:
        yield
    finally:
        unet._upsample2x = port


def twice(spec: dict, block: dict, conv_impl: str, device, group=None, space=None) -> dict:
    """The step twice from the same weights, for each upsample backward
    and with deterministic algorithms off (the default) and on (warning):
    the warnings, the losses, the tensors that differ."""
    out = {}
    for kind, mode in itertools.product(("interpolate", "port"), ("off", "warn")):
        previous = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(mode == "warn", warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught, upsample(kind):
                warnings.simplefilter("always")
                runs = [one_step(spec, block, conv_impl, device, group, space) for _ in range(2)]
        finally:
            torch.use_deterministic_algorithms(previous)
        differ = compare(*runs)
        out[f"{kind}/{mode}"] = {
            "warnings": sorted({str(w.message).splitlines()[0][:160] for w in caught
                                if "determinis" in str(w.message).lower()}),
            "losses": [r["loss"] for r in runs], "tensors": len(runs[0]) - 1,
            "differ": len(differ), "differ_kinds": sorted({k.split(" ")[0] for k in differ}),
            "worst": sorted(differ.items(), key=lambda kv: -kv[1][1])[:6]}
    return out


def probes(device) -> dict:
    """Which single ops raise under strict deterministic algorithms: the
    message each raised, or None."""
    x = torch.randn(2, 8, 16, 16, device=device)
    idx = torch.randint(0, 9, (4096,), device=device)
    cases = {
        "interpolate bilinear backward": lambda: torch.nn.functional.interpolate(
            x.clone().requires_grad_(), scale_factor=2, mode="bilinear").sum().backward(),
        "index_add_": lambda: torch.zeros(9, device=device).index_add_(
            0, idx, torch.ones(4096, device=device)),
        "gather backward": lambda: x.clone().requires_grad_().gather(
            1, torch.zeros(2, 1, 16, 16, dtype=torch.long, device=device)).sum().backward(),
        "max_pool2d backward": lambda: torch.nn.functional.max_pool2d(
            x.clone().requires_grad_(), 2).sum().backward(),
    }
    # The same backward of a graph built before the mode was on: F.interpolate
    # picks its form when it runs forward.
    built = torch.nn.functional.interpolate(x.clone().requires_grad_(), scale_factor=2,
                                            mode="bilinear")
    cases["interpolate bilinear backward, forward before the mode"] = (
        lambda: built.sum().backward())
    previous = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    out = {}
    try:
        for name, fn in cases.items():
            try:
                fn()
                out[name] = None
            except RuntimeError as exc:
                out[name] = str(exc).splitlines()[0][:200]
    finally:
        torch.use_deterministic_algorithms(previous)
    return out


def spatial_rank(spec: dict, batch: dict, device) -> dict:
    """On each of two ranks: the spatial step twice (its block of rows)."""
    from floodplanet_code_tpu_torch.parallel.mesh import (
        all_group,
        local_height,
        make_mesh_2d,
        space_group,
    )

    mesh = make_mesh_2d(1, 2)
    rows = local_height(mesh, batch["image"].shape[1])
    block = {k: torch.from_numpy(v[:, rows]).to(device) for k, v in batch.items()}
    return {conv_impl: twice(spec, block, conv_impl, device, all_group(mesh), space_group(mesh))
            for conv_impl in ("xla", "pallas_fused")}


def step_costs(spec: dict, block: dict, device) -> dict:
    """On a card: the bf16 step's time (CUDA events) with the mode off and
    on, each ``conv_impl``, and each one's device profile (chip_smoke.py's
    ``profile_step``: time per kernel class and the largest kernels)."""
    from floodplanet_code_tpu_torch.train.fit import deterministic_algorithms

    out = {}
    for conv_impl in ("xla", "pallas_fused"):
        model, state = cs._md_model(spec, torch.bfloat16, device, None, None, conv_impl)
        step = make_train_step(model, 0, TransformParams(False, 0, False, 0, False, 0),
                               fuse_augmentation=False)
        for mode in ("off", "on"):
            with deterministic_algorithms() if mode == "on" else contextlib.nullcontext():
                out[f"{conv_impl}/{mode}"] = {
                    "ms": cs.cuda_ms(lambda: step(state, block), 5),
                    "profile": cs.profile_step(f"{conv_impl}, mode {mode}",
                                               lambda: step(state, block))}
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tile", type=int, default=cs.TILE)
    p.add_argument("--sp_tile", type=int, default=cs.SP_TILE)
    p.add_argument("--base", type=int, default=cs.BASE)
    p.add_argument("--batch", type=int, default=cs.TRAIN_BATCH)
    p.add_argument("--device", default="cuda")
    p.add_argument("--costs", action="store_true",
                   help="on a card: only the step's time and profile with the mode off and on")
    args = p.parse_args(argv)
    on_card = torch.device(args.device).type == "cuda"
    if on_card:
        cs.build_all()
    spec = {"base": args.base, "dtype": torch.bfloat16}
    batch = make_batch(args.tile, args.batch)
    block = {k: torch.from_numpy(v).to(args.device) for k, v in batch.items()}
    out = {"tile": args.tile, "batch": args.batch, "base": args.base, "device": args.device}
    if args.costs:
        out["costs"] = step_costs(spec, block, args.device)
        out["card"] = cs.card_line()
        print(json.dumps(out))
        return out
    out["probes"] = probes(args.device)
    for dtype in (torch.bfloat16, torch.float32):
        out[f"one_rank {dtype}"] = {c: twice(dict(spec, dtype=dtype), block, c, args.device)
                                    for c in ("xla", "pallas_fused")}
    from floodplanet_code_tpu_torch.parallel import launch

    dev = str(torch.device(args.device, 0) if on_card else torch.device("cpu"))
    out["sp_tile"] = args.sp_tile
    out["spatial"] = launch.spawn(spatial_rank, (spec, make_batch(args.sp_tile, args.batch)),
                                  devices=[dev, dev], timeout_s=300, join_timeout_s=600)
    if on_card:
        out["card"] = cs.card_line()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
