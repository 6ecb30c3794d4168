#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA card and check it.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each prints its seconds; any failure raises and exits non-zero):

1. environment: torch/CUDA versions and the card's name and power limit;
2. build: the fused-conv CUDA kernel (nvcc, sm_90a) and the native TIFF
   library, from this checkout's sources, in parallel;
3. kernel parity: the kernel against its plain PyTorch version on the card
   at the nine DoubleConv shapes of the full-width UNet (batch 2), an odd
   shape, channel tails and a b > 0 case, in f32 and bf16;
4. kernel timing: kernel, plain chain and one cuDNN conv of the
   materialized z, per level at batch 16 (CUDA events), beside the bound;
   the kernel's batch-16 output is held to the plain chain's;
5. the slice: synthetic PlanetScope scenes written with the port's TIFF
   writer, the full-width early-fusion UNet (base 64, 4 bands, 3 classes,
   bf16, conv_impl=pallas_fused) with seeded flax-layout weights carried
   through the weights bridge, three ``infer`` requests on one warm model
   (two plain, one with TTA) and one overlapping ``sliding_window_predict``
   pass; masks, probabilities, kernel launches (9 per forward) and the
   agreement with the unfused cuDNN path (argmax and probabilities) are
   checked.

The last four lines of standard output are the slice's numbers as JSON
(tiles/s per request, bare forward ms, fused-vs-unfused agreement), the
card's name and power limit, the ``kernels`` JSON line and the
``{"ok": true, ...}`` line.
Exits non-zero, printing no result, when no CUDA device is available.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from floodplanet_code_tpu_torch.config import Config
from floodplanet_code_tpu_torch.data import build_dataset, generate_image_slice_object
from floodplanet_code_tpu_torch.geo import tiff
from floodplanet_code_tpu_torch.inference.infer import (
    build_infer_dataset,
    infer,
    load_model_for_eval,
)
from floodplanet_code_tpu_torch.inference.sliding import (
    make_predict_step,
    sliding_window_predict,
)
from floodplanet_code_tpu_torch.models import build_model
from floodplanet_code_tpu_torch.ops import LAUNCHES
from floodplanet_code_tpu_torch.ops import conv_fused
from floodplanet_code_tpu_torch.tools.import_jax_params import (
    save_weights,
    seeded_flax_variables,
    state_dict_from_flax,
)

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")  # listed in .gitignore

# The nine DoubleConv middle boundaries of the base-64 UNet at 512^2 tiles:
# (name, H = W, C1, C2). The kernel's input is the mid activation.
LEVELS = [
    ("inc", 512, 64, 64),
    ("down1", 256, 128, 128),
    ("down2", 128, 256, 256),
    ("down3", 64, 512, 512),
    ("down4", 32, 512, 512),
    ("up1", 64, 512, 256),
    ("up2", 128, 256, 128),
    ("up3", 256, 128, 64),
    ("up4", 512, 64, 64),
]
# Dense bf16 tensor-core FLOP/s and HBM bytes/s (NVIDIA data sheets, SXM
# parts, at the full 700 W power limit).
PEAKS = {"H100": (989e12, 3.35e12), "H200": (989e12, 4.8e12)}
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}  # of max|ref|
DPROB_TOL = 5e-3  # max |fused - unfused| stitched probability, bf16 model
SCENES = [(2100, 3300), (2100, 3300), (1500, 2700)]  # ragged edges at 512^2
TILE = 512
BATCH = 16


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"== {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"== {self.name}: {time.perf_counter() - self.t0:.2f} s")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def peaks(name: str) -> tuple[float, float]:
    for key, value in PEAKS.items():
        if key in name:
            return value
    raise RuntimeError(f"no published peaks recorded for {name!r}")


# -- 2. build ---------------------------------------------------------------


def build_all() -> None:
    results: dict = {}

    def run(name, fn):
        try:
            results[name] = fn()
        except BaseException as exc:  # re-raised below, in the main thread
            results[name] = exc

    threads = [
        threading.Thread(target=run, args=("conv_fused", conv_fused.build)),
        threading.Thread(target=run, args=("tiffio", tiff.load_library)),
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for value in results.values():
        if isinstance(value, BaseException):
            raise value
    path, report = results["conv_fused"]
    log(f"built {os.path.relpath(path, REPO)}")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")


# -- 3./4. the kernel -------------------------------------------------------


def kernel_inputs(gen, b, h, w, c1, c2, dtype, b_positive=False):
    dev = "cuda"
    y = torch.randn(b, c1, h, w, generator=gen, device=dev).to(dtype)
    y = y.contiguous(memory_format=torch.channels_last)
    a = torch.rand(c1, generator=gen, device=dev) + 0.5
    bias = torch.randn(c1, generator=gen, device=dev) * 0.5
    if b_positive:
        bias = bias.abs() + 0.5
    wt = torch.randn(c2, c1, 3, 3, generator=gen, device=dev) / math.sqrt(9 * c1)
    return y, a, bias, wt


def kernel_parity() -> dict:
    """Max errors of the kernel against the plain version, per dtype."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(name, 2, h, h, c1, c2, False) for name, h, c1, c2 in LEVELS]
    cases += [
        ("odd 37x75", 2, 37, 75, 256, 256, False),
        ("tails 13x11 5->7", 2, 13, 11, 5, 7, False),
        ("tails 9x21 40->72", 1, 9, 21, 40, 72, False),
        ("b>0 down4", 2, 32, 32, 512, 512, True),
        ("b>0 inc", 2, 64, 64, 64, 64, True),
    ]
    worst = {torch.float32: (0.0, 0.0), torch.bfloat16: (0.0, 0.0)}
    for name, bsz, h, w, c1, c2, bpos in cases:
        for dtype in (torch.float32, torch.bfloat16):
            y, a, b, wt = kernel_inputs(gen, bsz, h, w, c1, c2, dtype, bpos)
            got = conv_fused.relu_affine_conv3x3_cuda(y, a, b, wt)
            ref = conv_fused.relu_affine_conv3x3_plain(y, a, b, wt)
            torch.cuda.synchronize()
            if got.shape != ref.shape or got.dtype != ref.dtype:
                raise AssertionError(f"{name}: {got.shape} {got.dtype} vs {ref.shape}")
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            rel = err / max(scale, 1e-30)
            ok = math.isfinite(err) and rel <= TOL[dtype]
            log(f"  parity {name:18s} {str(dtype)[6:]:8s} max_abs_err={err:.3e} "
                f"max|ref|={scale:.3e} rel={rel:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"kernel disagrees with plain version: {name} {dtype}")
            worst[dtype] = max(worst[dtype], (rel, err))
    return worst


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_timing(card: str) -> list[dict]:
    """Per level at batch 16, bf16: kernel (on operands packed once, as the
    model does), plain chain, library conv; the kernel's output is held to
    the plain chain's on the same inputs."""
    peak_flops, peak_bytes = peaks(torch.cuda.get_device_name(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for name, h, c1, c2 in LEVELS:
        y, a, b, wt = kernel_inputs(gen, BATCH, h, h, c1, c2, torch.bfloat16)
        dt = y.dtype
        packed = conv_fused.pack(a, b, wt, dt)
        got = conv_fused.relu_affine_conv3x3_cuda(y, a, b, wt, packed).float()
        ref = conv_fused.relu_affine_conv3x3_plain(y, a, b, wt).float()
        err = (got - ref).abs().max().item()
        rel = err / max(ref.abs().max().item(), 1e-30)
        del got, ref
        if not (math.isfinite(err) and rel <= TOL[dt]):
            raise AssertionError(f"kernel disagrees with plain version at batch "
                                 f"{BATCH}: {name} rel={rel:.3e}")
        z = F.relu(y * a.to(dt).view(1, -1, 1, 1) + b.to(dt).view(1, -1, 1, 1))
        wd = wt.to(dt)
        iters = 10
        ms = cuda_ms(lambda: conv_fused.relu_affine_conv3x3_cuda(y, a, b, wt, packed), iters)
        plain_ms = cuda_ms(lambda: conv_fused.relu_affine_conv3x3_plain(y, a, b, wt), iters)
        library_ms = cuda_ms(lambda: F.conv2d(z, wd, padding=1), iters)
        flop = 2.0 * BATCH * h * h * 9 * c1 * c2
        nbytes = 2.0 * (BATCH * h * h * (c1 + c2) + 9 * c1 * c2 + 2 * c1)
        t_ops, t_bytes = flop / peak_flops * 1e3, nbytes / peak_bytes * 1e3
        row = dict(level=name, H=h, W=h, C1=c1, C2=c2, B=BATCH, gflop=flop / 1e9,
                   mbytes=nbytes / 1e6, max_abs_err=err, rel_err=rel, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        rows.append(row)
        log(f"  time {name:6s} {h}^2 {c1}->{c2} b{BATCH}: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, cuDNN conv {library_ms:.3f} ms, bound "
            f"{row['bound_ms']:.3f} ms ({row['bound_by']}), "
            f"{flop / ms / 1e9:.1f} TFLOP/s; vs plain max_abs_err={err:.3e} "
            f"rel={rel:.3e} [{card}]")
        del y, z, wd, packed
    return rows


# -- 5. the slice ------------------------------------------------------------


def write_scenes(root: str, seed: int = 0) -> None:
    """Synthetic CSDAP-layout PlanetScope scenes (uint16, 4 bands, stored
    HWC) with labels, written by the port's TIFF writer."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "CSDAP_complete", "RegionA")
    os.makedirs(os.path.join(base, "labels"), exist_ok=True)
    os.makedirs(os.path.join(base, "PS"), exist_ok=True)
    for i, (h, w) in enumerate(SCENES):
        label = rng.choice([0, 1, 2], size=(h, w), p=[0.1, 0.6, 0.3]).astype(np.uint8)
        img = rng.integers(0, 8000, size=(h, w, 4), dtype=np.uint16)
        img[..., 0] = np.where(label == 2, 7200, 800)
        tiff.imwrite(os.path.join(base, "labels", f"scene_{i}.tif"), label)
        tiff.imwrite(os.path.join(base, "PS", f"scene_{i}.tif"), img, planar_as_chw=False)


def slice_config(conv_impl: str) -> Config:
    return Config({
        "crop_height": TILE, "crop_width": TILE, "crop_stride": TILE,
        "batch_size": 8, "n_workers": 8, "norm_mode": None, "eval_region": None,
        "ignore_index": 0, "seed_num": 0, "train_split_pct": 0.8,
        "dataset": {"name": "floodplanet", "sensor": "PS", "channels": "ALL",
                    "dataset_kwargs": {}},
        "model": {"name": "ef_model", "model_kwargs": {"optimizer_name": "adam"}},
        "tpu": {"compute_dtype": "bfloat16", "conv_impl": conv_impl,
                "use_pallas": True, "inference_batch_size": BATCH},
    })


def check_masks(paths: list[str]) -> None:
    if len(paths) != len(SCENES):
        raise AssertionError(f"{len(paths)} masks for {len(SCENES)} scenes")
    shapes = sorted(SCENES)
    got = []
    for path in paths:
        mask = tiff.imread(path)
        if mask.dtype != np.uint8 or not set(np.unique(mask)) <= {0, 255}:
            raise AssertionError(f"{path}: not a {{0, 255}} uint8 mask")
        got.append(mask.shape)
    if sorted(got) != shapes:
        raise AssertionError(f"mask shapes {got} != scenes {shapes}")


def forward_ms(model) -> float:
    """CUDA-event time of one predict step on a random batch on the card."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.rand(BATCH, TILE, TILE, 4, generator=gen, device="cuda")
    step = make_predict_step(model)
    return cuda_ms(lambda: step({"image": x.permute(0, 3, 1, 2)}), iters=5)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def small_input_reference(device="cuda") -> float:
    """Fused f32 model on the card vs the same model on the CPU (plain
    version) on a small input: max |logit difference|."""
    sd = state_dict_from_flax(seeded_flax_variables(4, 3, 64, seed=3))
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (2, 4, 64, 96)).astype(np.float32))
    out = []
    for dev in (device, "cpu"):
        model = build_model("ef_model", {"ms_image": 4}, 3, dtype=torch.float32,
                            device=dev, conv_impl="pallas_fused")
        model.load_state_dict(sd, strict=True)
        with torch.inference_mode():
            out.append(model({"image": x.to(dev)}).cpu())
    return (out[0] - out[1]).abs().max().item()


def run_slice(card: str, device="cuda") -> dict:
    """Phase 5. ``device`` is the card; ``"cpu"`` rehearses the control
    flow (tests/test_torch_chip_smoke.py, at a small size): no kernel
    launches and no device timing then."""
    data_root = os.path.join(WORK, "data")
    exp = os.path.join(WORK, "exp")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(os.path.join(exp, "weights"))
    with Phase("slice: write scenes"):
        write_scenes(data_root)

    err_small = small_input_reference(device)
    log(f"  small input, fused f32 card vs CPU: max |dlogit| = {err_small:.3e}")
    if not err_small <= 1e-3:
        raise AssertionError("card and CPU disagree on the small input")

    cfg = slice_config("pallas_fused")
    weights = os.path.join(exp, "weights", "model.pt")
    save_weights(state_dict_from_flax(seeded_flax_variables(4, 3, 64, seed=0)), weights)
    ds = build_infer_dataset(cfg, "floodplanet", "all", root_dir=data_root)
    ds_overlap = build_dataset(
        "floodplanet", "all", generate_image_slice_object(TILE, TILE, stride=TILE // 2),
        sensor="PS", channels="ALL", root_dir=data_root, output_metadata=True,
        ignore_index=0,
    )
    model = load_model_for_eval(cfg, weights, ds, device)  # warm, on the card
    batches = -(-len(ds) // BATCH)
    batches_overlap = -(-len(ds_overlap) // BATCH)
    forwards = 2 * batches + 8 * batches + batches_overlap
    log(f"  {len(ds)} tiles per request ({batches} batches of {BATCH}), "
        f"{len(ds_overlap)} tiles in the overlapping pass")

    sync(device)
    LAUNCHES.clear()  # the main path starts here
    times = {}
    for name, tta in (("request 1", False), ("request 2", False), ("request 3 (tta)", True)):
        with Phase(f"slice: {name}"):
            t0 = time.perf_counter()
            paths = infer(cfg, None, "floodplanet", "all",
                          os.path.join(exp, "masks", name.split()[1]),
                          tta=tta, warm=model, dataset=ds, device=device)
            sync(device)
            times[name] = time.perf_counter() - t0
            check_masks(paths)
    with Phase("slice: overlapping pass (fused)"):
        t0 = time.perf_counter()
        fused = {s["image_name"]: s["probabilities"]
                 for s in sliding_window_predict(model, ds_overlap, BATCH, n_workers=8,
                                                 device=device)}
        sync(device)
        times["overlap fused"] = time.perf_counter() - t0
    launches = LAUNCHES[conv_fused.KERNEL]  # the main path ends here
    log(f"  launches of {conv_fused.KERNEL}: {launches} for {forwards} forwards")
    # 9 per forward on the card; a CPU tensor runs the plain version.
    expected = 9 * forwards if torch.device(device).type == "cuda" else 0
    if launches != expected:
        raise AssertionError(f"expected {expected} kernel launches, got {launches}")

    for name, probs in fused.items():
        if not np.isfinite(probs).all():
            raise AssertionError(f"{name}: non-finite probabilities")
        dev = np.abs(probs.sum(-1) - 1).max()
        if dev > 1e-3:
            raise AssertionError(f"{name}: probabilities sum off by {dev}")

    model_xla = build_model("ef_model", ds.n_channels, ds.n_classes,
                            dtype=torch.bfloat16, device=device, conv_impl="xla")
    model_xla.load_state_dict(model.state_dict(), strict=True)
    with Phase("slice: overlapping pass (xla = unfused cuDNN)"):
        t0 = time.perf_counter()
        unfused = {s["image_name"]: s["probabilities"]
                   for s in sliding_window_predict(model_xla, ds_overlap, BATCH, n_workers=8,
                                                   device=device)}
        sync(device)
        times["overlap xla"] = time.perf_counter() - t0
    agree = np.mean(np.concatenate([
        (fused[k].argmax(-1) == unfused[k].argmax(-1)).ravel() for k in fused
    ]))
    dprob = max(np.abs(fused[k] - unfused[k]).max() for k in fused)
    shares = np.bincount(np.concatenate([fused[k].argmax(-1).ravel() for k in fused]),
                         minlength=3) / sum(p.shape[0] * p.shape[1] for p in fused.values())
    log(f"  fused vs unfused: argmax agreement {agree:.6f}, max |dp| {dprob:.3e}, "
        f"fused class shares {np.round(shares, 4).tolist()}")
    # The seeded weights predict one class almost everywhere, so the argmax
    # check alone would pass whatever the kernel computed: the probabilities
    # themselves are held to DPROB_TOL too. A probability moves by at most
    # a quarter of its logit's change, so 5e-3 allows logit differences of
    # 2e-2, several bf16 rounding steps at |logit| ~ 1, and no more.
    if agree < 0.999:
        raise AssertionError(f"fused and unfused paths agree on only {agree:.4%}")
    if not dprob <= DPROB_TOL:
        raise AssertionError(f"fused and unfused probabilities differ by {dprob:.3e}")

    forward = {}
    if torch.device(device).type == "cuda":
        # The bare forward (+softmax) of one batch, without loading or
        # stitching, and the share of request 2's wall time it accounts for.
        for name, m in (("fused", model), ("xla", model_xla)):
            fwd = forward[name] = forward_ms(m)
            busy = batches * fwd / 1e3 / times["request 2"]
            log(f"  forward {name}: {fwd:.3f} ms per batch of {BATCH} "
                f"({BATCH / fwd * 1e3:.1f} tiles/s); request 2 at that rate keeps "
                f"the device busy {busy:.1%} of its wall time [{card}]")

    rates = {
        "request 1": len(ds) / times["request 1"],
        "request 2": len(ds) / times["request 2"],
        "request 3 (tta)": len(ds) / times["request 3 (tta)"],
        "overlap fused": len(ds_overlap) / times["overlap fused"],
        "overlap xla": len(ds_overlap) / times["overlap xla"],
    }
    for name, rate in rates.items():
        log(f"  tiles/s {name}: {rate:.1f} (host clock, loading and stitching "
            f"included) [{card}]")
    shutil.rmtree(WORK, ignore_errors=True)
    return {"launches": launches, "agree": float(agree), "max_dprob": float(dprob),
            "class_shares": shares.tolist(), "tiles_per_s": rates,
            "forward_ms": forward, "tiles": {"request": len(ds),
                                             "overlap": len(ds_overlap)}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # References in f32 run in full f32: cuDNN would use TF32 by default.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with Phase("environment"):
        card = card_line()
        log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
            f"{torch.cuda.device_count()} device(s)")
        log(f"card: {card}")
    with Phase("build"):
        build_all()
    with Phase("kernel parity"):
        worst = kernel_parity()
    with Phase("kernel timing"):
        rows = kernel_timing(card)
    with Phase("slice"):
        result = run_slice(card)

    # One forward launches the kernel once per level, so its least time is
    # the sum of the per-level bounds; it is bound by whichever resource
    # bounds the levels that make up most of that sum.
    total = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    t_ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    kernels = {"kernels": [{
        "name": conv_fused.KERNEL,
        "route": "cuda",
        "source": "floodplanet_code_tpu_torch/ops/csrc/conv_fused.cu",
        "replaces": "floodplanet_code_tpu/ops/conv_fused.py:95",
        "launches": result["launches"],
        # bf16: the parity cases at batch 2 and the nine levels at batch 16.
        "max_abs_err": max(worst[torch.bfloat16][1], *(r["max_abs_err"] for r in rows)),
        "max_rel_err_f32": worst[torch.float32][0],
        "max_rel_err_bf16": worst[torch.bfloat16][0],
        # Times are per forward of one batch of 16 tiles: the sum over the
        # nine levels (per-level rows under "levels").
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "operations" if t_ops >= total["bound_ms"] / 2 else "bytes",
        "library_ms": total["library_ms"],
        "levels": rows,
    }]}
    log(json.dumps({"slice": {k: v for k, v in result.items() if k != "launches"}}))
    log(card)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
