#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and fit paths on one NVIDIA
card and check them.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each prints its seconds; any failure raises and exits non-zero):

1. environment: torch/CUDA versions and the card's name and power limit;
2. build: the two CUDA kernels (nvcc, sm_90a: the fused conv and the row
   shear) and the native TIFF library, from this checkout's sources, in
   parallel;
3. kernel parity: the fused conv against its plain PyTorch version on the
   card at the nine DoubleConv shapes of the full-width UNet (batch 2), an
   odd shape, channel tails, b > 0 cases and the edges of the bf16
   kernel's tiles, in f32 and bf16; ptxas must report no spills in the bf16
   kernel;
4. kernel timing: kernel, plain chain and one cuDNN conv of the
   materialized z, per level at batch 16 (CUDA events), beside the bound
   (its fraction and TFLOP/s); the kernel's batch-16 output is held to the
   plain chain's, and the kernel must beat the plain chain at every level;
5. the slice (serving): synthetic PlanetScope scenes written with the
   port's TIFF writer, the full-width early-fusion UNet (base 64, 4 bands,
   3 classes, bf16, conv_impl=pallas_fused) with seeded flax-layout weights
   carried through the weights bridge, four ``infer`` requests on one warm
   model (two plain and one with TTA through the HBM scene cache, one plain
   through the host loader) and one overlapping ``sliding_window_predict``
   pass; masks, probabilities, kernel launches (9 per forward) and the
   agreement with the unfused cuDNN path are checked;
6. shear parity: the row-shear kernel against its plain version, bit for
   bit, at [8, 512, 512, 6] and [2, 300, 300, 6] over five residual angles
   and on the quantization's edges (integer shifts, .5 ties, clipped
   shifts) at odd shapes and C in {3, 5, 6}; both axes, order 0 and 1, f32
   and bf16;
7. shear timing: the kernel's device time (a trace, which must show one
   launch per wrapper call and nothing else), the wrapper's time per call,
   the shear along H, the plain version and one ``F.grid_sample`` at
   [8, 512, 512, 6] bf16, beside the bytes bound; the kernel must not be
   slower than ``grid_sample``;
8. training: augmentation (flips + rotation, rotate_impl=shear_pallas,
   bf16) and train steps (Adam, lr 1e-4) of the full-width model at batch 8
   on 512^2 crops through the loader, then steps on one fixed augmented
   batch (the loss must fall), eval steps before and after the updates and
   after one optimizer step alone (the pack cache must re-pack each time;
   the fused eval must agree with the unfused model), exact launch counts
   of both kernels, one f32 step fused + kernel shear against unfused +
   plain shear with an f64 unfused step as the witness, device times of
   the steps and profiles of one train step and one augment step;
9. fit: the training phase's scenes and model through
   ``python -m floodplanet_code_tpu_torch.fit`` (its ``main``) with the
   reference's default transforms: every batch of one epoch from the HBM
   scene cache against the loader's (bit-identical with norm_mode null,
   1e-6 with local); a 3-epoch fit with async top-2 checkpoints (index.json
   held to the retention rules, finite losses, timing.json, exact conv
   launches: 9 per train step, validation batch and image panel); a resume
   to a 4th epoch whose restored tensors equal the file's bit for bit; a
   no-op re-run with no launch; a 2-epoch fit through the host loader; and
   ``infer`` from the best checkpoint through the cache and the host
   loader on one warm model (probabilities within 1e-6, argmax equal).

The last six lines of standard output are the serving slice's numbers as
JSON, the training phase's numbers as JSON, the fit phase's numbers as
JSON, the card's name and power limit, the ``kernels`` JSON line and the
``{"ok": true, ...}`` line.
Exits non-zero, printing no result, when no CUDA device is available.
"""

from __future__ import annotations

import contextlib
import dataclasses
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

from floodplanet_code_tpu_torch import fit as fit_cli
from floodplanet_code_tpu_torch.config import Config, load_experiment_config
from floodplanet_code_tpu_torch.data import (
    BatchLoader,
    build_dataset,
    device_prefetch,
    generate_image_slice_object,
)
from floodplanet_code_tpu_torch.data.augment import (
    TransformParams,
    apply_augmentation,
    draw_augmentation,
)
from floodplanet_code_tpu_torch.data.device_cache import (
    build_device_cache,
    make_batch_builder,
)
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
from floodplanet_code_tpu_torch.ops import conv_fused, rotate
from floodplanet_code_tpu_torch.tools.import_jax_params import (
    save_weights,
    seeded_flax_variables,
    state_dict_from_flax,
)
from floodplanet_code_tpu_torch.train import (
    create_train_state,
    init_weights,
    make_augment_step,
    make_eval_step,
    make_train_step,
)
from floodplanet_code_tpu_torch.train import checkpoint as ckpt
from floodplanet_code_tpu_torch.train.logging import log_image_panel, open_writer

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
# f32 rate outside the tensor cores (NVIDIA data sheet, SXM, 700 W): the
# operations bound of the elementwise shear.
F32_PEAK = {"H100": 67e12, "H200": 67e12}

# Training phase: the reference's default recipe (config.yaml: flips and
# rotation at p=0.5 over 0-360 degrees, Adam at lr 1e-4, CE ignoring class 0,
# bf16) at bench.py's shape (512^2, batch 8), with the Pallas-kernel
# configuration of the rotation (rotate_impl=shear_pallas). Five scenes,
# so the 0.8 split leaves at least 15 batches of 8.
TRAIN_SCENES = SCENES + [(2100, 3300), (2100, 3300)]
TRAIN_BATCH = 8
TRAIN_STEPS = 12
FIXED_STEPS = 10  # steps on one fixed augmented batch: the loss must fall
BASE = 64  # UNet base width
F32_BATCH = 2  # the f32 fused-vs-plain step
# In that step, each gradient tensor's difference: its norm within GRAD_TOL
# of the tensor's norm, its largest element within GRAD_MAX_TOL of the
# tensor's largest (see f32_step_check). And the witness: against an f64
# unfused step, the fused f32 gradients' worst distance is at most
# WITNESS_RATIO times the unfused f32 gradients' worst distance.
GRAD_TOL = 1e-2
GRAD_MAX_TOL = 3e-2
WITNESS_RATIO = 3.0
# Shear parity: [B, H = W] at the augmentation shape and the reference's
# 300^2 crop; residual angles through rotate_flip_batch's a, b.
SHEAR_SHAPES = [(8, 512), (2, 300)]
SHEAR_ANGLES = [-44.9, -10.0, 0.0, 17.0, 44.9]
SHEAR_TOL = {torch.float32: 1e-5, torch.bfloat16: 3.9e-3}  # of max|ref|
# Shear parity at the quantization's edges: [B, H, W, C] with W*C not a
# multiple of the vector width, and C off the kernel's C = 6 path.
SHEAR_EDGE_SHAPES = [(1, 37, 53, 6), (2, 40, 40, 3), (2, 24, 40, 5)]

# Fit phase: the training phase's scenes, model and batch through the fit
# CLI with the reference's default transforms (the roll shear: no shear
# kernel), async checkpoints, top-2 retention and a resume point every
# second epoch.
FIT_EPOCHS = 3
FIT_LIMIT_TRAIN = 15
FIT_LIMIT_VAL = 2
FIT_LOG_IMAGE_ITER = 10
LOCAL_TOL = 1e-6  # cache vs loader with norm_mode local, of max|ref|
PROB_TOL = 1e-6  # stitched probabilities, cache vs host path


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
        threading.Thread(target=run, args=("rotate", rotate.build)),
        threading.Thread(target=run, args=("tiffio", tiff.load_library)),
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for value in results.values():
        if isinstance(value, BaseException):
            raise value
    for name in ("conv_fused", "rotate"):
        path, report = results[name]
        log(f"built {os.path.relpath(path, REPO)}")
        if not report:
            log("  (already built: no ptxas report)")
        for line in report.splitlines():
            if any(k in line for k in ("registers", "spill", "smem", "C75", "Function properties")):
                log(f"  ptxas: {line.strip()}")
        check_no_spills(report)


def check_no_spills(report: str) -> None:
    """Raise if ptxas reports spills, or serialized wgmmas, in a bf16 conv
    kernel (``Function properties for <name>`` is followed by its
    ``bytes spill stores`` line)."""
    kernel = None
    for line in report.splitlines():
        if "Function properties for" in line:
            kernel = line.split("for", 1)[1].strip()
        elif "spill stores" in line and kernel and "conv_bf16" in kernel:
            stores, loads = (int(line.split(" bytes spill stores")[0].split(",")[-1]),
                             int(line.split(" bytes spill loads")[0].split(",")[-1]))
            if stores or loads:
                raise AssertionError(f"ptxas spills in {kernel}: {line.strip()}")
        if "C7512" in line or "C7515" in line or "C7508" in line:
            raise AssertionError(f"ptxas: {line.strip()}")


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
        # Edges of the bf16 kernel's tiles (tile_config: 32x16, 16x16 or
        # 8x16 pixels by 64, 128 or 256 channels, K chunks of 64): H and W
        # off the tile, C2 off the N tile, C1 off the K chunk, an image
        # smaller than a tile, and C1 % 8 != 0 (the scalar halo load).
        ("hw tail 40x40 64->64", 2, 40, 40, 64, 64, True),
        ("c2 tail 16x24 128->96", 2, 16, 24, 128, 96, False),
        ("c2 tail 19x23 64->200", 1, 19, 23, 64, 200, True),
        ("c1 tail 16x20 96->128", 2, 16, 20, 96, 128, True),
        ("tiny 5x3 96->40", 1, 5, 3, 96, 40, True),
        ("scalar 10x9 12->300", 1, 10, 9, 12, 300, True),
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
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   tile=list(conv_fused.tile_config(c2)))
        row["bound_frac"] = row["bound_ms"] / ms
        row["tflops"] = flop / ms / 1e9
        rows.append(row)
        log(f"  time {name:6s} {h}^2 {c1}->{c2} b{BATCH}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, cuDNN conv {library_ms:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}, {row['bound_frac']:.1%} of it), "
            f"{row['tflops']:.1f} TFLOP/s, tile {row['tile']}; vs plain "
            f"max_abs_err={err:.3e} rel={rel:.3e} [{card}]")
        del y, z, wd, packed
    slower = [r["level"] for r in rows if not r["ms"] < r["plain_ms"]]
    if slower:
        raise AssertionError(f"the kernel is not faster than the plain chain at {slower}")
    return rows


# -- 5. the slice ------------------------------------------------------------


def write_scenes(root: str, scenes=None, seed: int = 0) -> None:
    """Synthetic CSDAP-layout PlanetScope scenes (uint16, 4 bands, stored
    HWC) with labels, written by the port's TIFF writer."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "CSDAP_complete", "RegionA")
    os.makedirs(os.path.join(base, "labels"), exist_ok=True)
    os.makedirs(os.path.join(base, "PS"), exist_ok=True)
    for i, (h, w) in enumerate(SCENES if scenes is None else scenes):
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


def check_masks(paths: list[str], scenes=None) -> None:
    scenes = SCENES if scenes is None else scenes
    if len(paths) != len(scenes):
        raise AssertionError(f"{len(paths)} masks for {len(scenes)} scenes")
    shapes = sorted(scenes)
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
    forwards = 4 * batches + 8 * batches + batches_overlap
    log(f"  {len(ds)} tiles per request ({batches} batches of {BATCH}), "
        f"{len(ds_overlap)} tiles in the overlapping pass")
    # The requests read their scenes through the HBM scene cache (the
    # config's tpu.device_data_bytes); the "(host)" ones through the host
    # loader. Request 1 of each warms its path; the two request 2s are the
    # ones compared.
    cfg_host = slice_config("pallas_fused")
    cfg_host.tpu.device_data_bytes = 0

    sync(device)
    LAUNCHES.clear()  # the main path starts here
    times = {}
    for name, c, tta in (("request 1", cfg, False), ("request 1 (host)", cfg_host, False),
                         ("request 2", cfg, False), ("request 2 (host)", cfg_host, False),
                         ("request 3 (tta)", cfg, True)):
        with Phase(f"slice: {name}"):
            t0 = time.perf_counter()
            paths = infer(c, None, "floodplanet", "all",
                          os.path.join(exp, "masks", name.replace(" ", "_")),
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
            log(f"  forward {name}: {fwd:.3f} ms per batch of {BATCH} "
                f"({BATCH / fwd * 1e3:.1f} tiles/s) [{card}]")
        for name in ("request 2", "request 2 (host)"):
            busy = batches * forward["fused"] / 1e3 / times[name]
            log(f"  {name} at the fused rate keeps the device busy {busy:.1%} of its "
                f"wall time [{card}]")

    rates = {
        "request 1": len(ds) / times["request 1"],
        "request 1 (host)": len(ds) / times["request 1 (host)"],
        "request 2": len(ds) / times["request 2"],
        "request 2 (host)": len(ds) / times["request 2 (host)"],
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


# -- 6./7. the shear kernel --------------------------------------------------


def shear_input(gen, b, hw, dtype, device):
    """[image (4 bands) | label | validity], as augment_batch builds it."""
    img = torch.rand(b, hw, hw, 4, generator=gen, device=device)
    lbl = torch.randint(0, 3, (b, hw, hw, 1), generator=gen, device=device).float()
    return torch.cat([img, lbl, torch.ones_like(lbl)], dim=-1).to(dtype)


def shear_shifts(angle_deg: float, b: int, n: int, axis: int, device) -> torch.Tensor:
    """rotate_flip_batch's per-line shifts for one residual angle: a =
    -tan(theta/2) for the shears along W (axis 2), b = sin(theta) along H."""
    theta = torch.full((b,), angle_deg, dtype=torch.float32, device=device) * (math.pi / 180.0)
    coef = -torch.tan(theta / 2.0) if axis == 2 else torch.sin(theta)
    return rotate._row_shifts(coef, n)


def edge_shifts(b: int, n: int, device) -> dict:
    """Per-line shifts [b, n] at the quantization's edges, for n lines: exact
    integers; fractions whose fq = frac * 65536 lands on a .5 tie (src =
    shift + pad stays exact in f32 while |src| < 128); and shifts beyond
    +-(pad-1), where the clip binds."""
    pad = rotate._pad(n)
    line = torch.arange(n, dtype=torch.float32, device=device)
    row = torch.arange(b, dtype=torch.float32, device=device)[:, None]
    ints = torch.remainder(line + 3 * row, 11) - 5
    ties = ints + (2 * torch.remainder(line * 7 + row, 64) + 1) / 131072.0
    clip = torch.where(torch.remainder(line + row, 2) == 0, 1.0, -1.0) * (pad + 3.25 + line / n)
    return {"integers": ints.expand(b, n).contiguous(), "ties": ties.contiguous(),
            "clip": clip.contiguous()}


def shear_parity(device="cuda") -> dict:
    """The shear (the kernel on a card) against its plain version, bit for
    bit: at the augmentation shape and the 300^2 crop over five residual
    angles, and on the quantization edges (``edge_shifts``) at shapes whose
    W*C is not a multiple of the vector width and with C in {3, 5} (the
    kernel's any-C path); both axes, order 0 and 1, f32 and bf16,
    nearest_from = C - 2. Returns the worst (relative, absolute) error per
    dtype, which must be 0."""
    gen = torch.Generator(device=device).manual_seed(4)
    worst = {torch.float32: (0.0, 0.0), torch.bfloat16: (0.0, 0.0)}
    cases = 0

    def check(x, shifts, axis, what):
        nonlocal cases
        nf = x.shape[-1] - 2
        for order in (0, 1):
            got = rotate.shear(x, shifts, order, 0.0, nf, axis)
            ref = rotate.shear_plain(x, shifts, order, 0.0, nf, axis)
            sync(device)
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            if not torch.equal(got, ref):
                raise AssertionError(
                    f"shear kernel differs from its plain version: {what} {tuple(x.shape)} "
                    f"{x.dtype} axis {axis} order {order}: max_abs_err={err:.3e}")
            worst[x.dtype] = max(worst[x.dtype], (err / max(scale, 1e-30), err))
            cases += 1

    for b, hw in SHEAR_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = shear_input(gen, b, hw, dtype, device)
            for angle in SHEAR_ANGLES:
                for axis in (2, 1):
                    check(x, shear_shifts(angle, b, hw, axis, device), axis, f"angle {angle}")
    for b, h, w, c in SHEAR_EDGE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.rand(b, h, w, c, generator=gen, device=device).to(dtype)
            x[..., -2:] = torch.randint(0, 3, (b, h, w, 2), generator=gen, device=device).to(dtype)
            for axis in (2, 1):
                for name, shifts in edge_shifts(b, h if axis == 2 else w, device).items():
                    check(x, shifts, axis, name)
    for dtype, (rel, err) in worst.items():
        log(f"  shear parity {str(dtype)[6:]:8s}: worst max_abs_err={err:.3e} "
            f"rel={rel:.3e} over {cases} cases in both types, bit-identical")
    return worst


def shear_timing(card: str) -> dict:
    """One launch at [8, 512, 512, 6] bf16: the kernel's device time (from
    a trace), the wrapper's time per call with its quantization and host
    work, the plain version and F.grid_sample of the same shear as the
    library yardstick (bilinear on every channel, where the kernel rounds
    the label and validity channels' fraction; CUDA events), beside the
    bytes bound."""
    b, hw = SHEAR_SHAPES[0]
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = shear_input(gen, b, hw, torch.bfloat16, "cuda")
    shifts = shear_shifts(17.0, b, hw, 2, "cuda")
    got = rotate.shear_cuda(x, shifts, 1, 0.0, 4, 2)
    ref = rotate.shear_plain(x, shifts, 1, 0.0, 4, 2)
    err = (got.float() - ref.float()).abs().max().item()
    # grid_sample's grid: (x + shift_y, y) in align_corners=True coordinates.
    ys, xs = torch.meshgrid(torch.arange(hw, device="cuda", dtype=torch.float32),
                            torch.arange(hw, device="cuda", dtype=torch.float32),
                            indexing="ij")
    gx = (xs[None] + shifts[:, :, None]) * (2.0 / (hw - 1)) - 1.0
    gy = (ys * (2.0 / (hw - 1)) - 1.0).expand(b, hw, hw)
    grid = torch.stack([gx, gy], dim=-1).to(x.dtype)
    x_nchw = x.permute(0, 3, 1, 2)
    iters = 50
    wrapper_ms = cuda_ms(lambda: rotate.shear_cuda(x, shifts, 1, 0.0, 4, 2), iters)
    # The kernel's device time from a trace of ``iters`` wrapper calls, which
    # must hold exactly one launch per call and nothing else: the wrapper
    # quantizes nothing itself.
    traced = trace_kernels(lambda: [rotate.shear_cuda(x, shifts, 1, 0.0, 4, 2)
                                    for _ in range(iters)])
    hits = [(t, n) for key, t, n in traced if "shear_kernel" in key]
    others = [key for key, _, _ in traced if "shear_kernel" not in key]
    launches = sum(n for _, n in hits)
    if others or launches != iters:
        raise AssertionError(f"{iters} shear calls launched {launches} shear kernels and "
                             f"{others}: want exactly one launch per call")
    ms = sum(t for t, _ in hits) / launches
    # The shear along H (the augmentation's middle shear): device time per
    # traced launch (a later trace session may drop a few kernel events, so
    # the count is not checked here).
    shifts_h = shear_shifts(17.0, b, hw, 1, "cuda")
    traced_h = [(t, n) for key, t, n in trace_kernels(
        lambda: [rotate.shear_cuda(x, shifts_h, 1, 0.0, 4, 1) for _ in range(iters)])
        if "shear" in key]
    axis1_ms = sum(t for t, _ in traced_h) / sum(n for _, n in traced_h)
    plain_ms = cuda_ms(lambda: rotate.shear_plain(x, shifts, 1, 0.0, 4, 2), iters)
    library_ms = cuda_ms(lambda: F.grid_sample(x_nchw, grid, mode="bilinear",
                                               padding_mode="zeros", align_corners=True),
                         iters)
    name = torch.cuda.get_device_name(0)
    nbytes = 2.0 * x.numel() * x.element_size() + 2 * shifts.numel() * 4
    ops = 6.0 * x.numel()  # two products, a difference and a sum, the tap tests
    t_bytes = nbytes / peaks(name)[1] * 1e3
    t_ops = ops / next(v for k, v in F32_PEAK.items() if k in name) * 1e3
    row = dict(shape=[b, hw, hw, 6], dtype="bfloat16", max_abs_err=err, ms=ms,
               wrapper_ms=wrapper_ms, axis1_ms=axis1_ms, launches_per_call=launches / iters,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               mbytes=nbytes / 1e6)
    log(f"  shear [{b},{hw},{hw},6] bf16 per launch: kernel {ms:.4f} ms (trace; "
        f"{nbytes / ms / 1e6:.0f} GB/s, {row['bound_ms'] / ms:.1%} of the bound), wrapper "
        f"{wrapper_ms:.4f} ms per call (events), plain {plain_ms:.4f} ms, grid_sample "
        f"{library_ms:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
        f"{nbytes / 1e6:.1f} MB); one launch per call; along H {axis1_ms:.4f} ms per launch "
        f"(trace); vs plain max_abs_err={err:.3e} [{card}]")
    if not ms <= library_ms:
        raise AssertionError(f"the shear kernel ({ms:.4f} ms) is slower than grid_sample "
                             f"({library_ms:.4f} ms)")
    return row


@contextlib.contextmanager
def plain_shear():
    """Within the block, ``impl="pallas"`` runs ``shear_plain`` on a card
    too (the plain augmentation the kernel is held to and timed against)."""
    saved = rotate.shear
    rotate.shear = rotate.shear_plain
    try:
        yield
    finally:
        rotate.shear = saved


# -- 8. training -------------------------------------------------------------


def _to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()
            if isinstance(v, np.ndarray)}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def f32_step_check(card: str, eval_batch: dict, device) -> dict:
    """One f32 train step at batch F32_BATCH from the same weights and the
    same draws: the fused model with the kernel shear against the unfused
    (cuDNN) model with the plain shear. TF32 is off (main). An f64 step of
    the unfused model (f64 activations and BatchNorm; the loss on f32
    logits, as in every dtype) is the truth both f32 steps are held to:
    gaps of rounding put both at about one distance from it, a fault in the
    fused forward or backward puts the fused step farther away."""
    sd = state_dict_from_flax(seeded_flax_variables(4, 3, BASE, seed=1))
    tp = TransformParams(rotate_likelihood=1.0, rotate_impl="shear_pallas")
    batch = {k: v[:F32_BATCH] for k, v in eval_batch.items()}
    gen = torch.Generator(device=device).manual_seed(6)
    draws = draw_augmentation(gen, F32_BATCH, tp, device)
    img_k, tgt_k = apply_augmentation(batch["image"], batch["target"], draws, tp, 0)
    with plain_shear():
        img_p, tgt_p = apply_augmentation(batch["image"], batch["target"], draws, tp, 0)
    aug_err = (img_k - img_p).abs().max().item() / max(img_p.abs().max().item(), 1e-30)
    if not (aug_err <= SHEAR_TOL[torch.float32] and torch.equal(tgt_k, tgt_p)):
        raise AssertionError(f"f32 augmentation: kernel vs plain rel={aug_err:.3e}")
    out = {}
    for name, impl, dtype, img, tgt in (
            ("fused", "pallas_fused", torch.float32, img_k, tgt_k),
            ("xla", "xla", torch.float32, img_p, tgt_p),
            ("xla again", "xla", torch.float32, img_p, tgt_p),
            ("f64", "xla", torch.float64, img_p, tgt_p)):
        model = build_model("ef_model", {"ms_image": 4}, 3, base_feat_channels=BASE,
                            dtype=dtype, device=device, conv_impl=impl)
        state = create_train_state(model, sd, 1e-4)
        step = make_train_step(model, 0, tp, fuse_augmentation=False)
        # Each DoubleConv's output ReLU mask, to count where the two paths'
        # f32 sums put a pre-activation on opposite sides of zero.
        masks = {}
        hooks = [m.register_forward_hook(
            lambda mod, inp, o, n=n: masks.__setitem__(n, (o > 0).detach()))
            for n, m in model.named_modules() if n.endswith("double_conv") or n.endswith("inc")]
        _, logs = step(state, {"image": img, "target": tgt})
        for h in hooks:
            h.remove()
        out[name] = (logs["loss"].item(),
                     {n: p.grad.detach().clone() for n, p in model.named_parameters()},
                     {n: b.detach().clone() for n, b in model.named_buffers()}, masks)
        del model, state, step
    (lf, gf, bf, mf), (lx, gx, bx, mx) = out["fused"], out["xla"]
    l64, g64, _, m64 = out["f64"]
    loss_rel = _rel(lf, lx)

    def grad_rels(ga, gb):
        """Per tensor: (max |ga-gb| / max|gb|, ||ga-gb|| / ||gb||)."""
        return {n: ((ga[n] - gb[n]).abs().max().item() / max(gb[n].abs().max().item(), 1e-30),
                    ((ga[n] - gb[n]).norm() / gb[n].norm().clamp_min(1e-30)).item())
                for n in gb}

    rels, noise = grad_rels(gf, gx), grad_rels(out["xla again"][1], gx)
    to64 = {"fused": grad_rels(gf, g64), "xla": grad_rels(gx, g64)}

    def short(n):
        return n.split(".")[-2] if n.endswith("double_conv") else "inc"

    flips = {n: int((mf[n] != mx[n]).sum()) for n in mx}
    flips64 = {k: {short(n): int((m[n] != m64[n]).sum()) for n in m64}
               for k, m in (("fused", mf), ("xla", mx))}
    for n in sorted(rels, key=lambda k: rels[k][0], reverse=True)[:4]:
        log(f"    grad {n}: fused vs xla max {rels[n][0]:.2e}·max|g|, norm "
            f"{rels[n][1]:.2e}·||g||; xla rerun max {noise[n][0]:.2e}; vs f64: fused "
            f"{to64['fused'][n][0]:.2e}/{to64['fused'][n][1]:.2e}, xla "
            f"{to64['xla'][n][0]:.2e}/{to64['xla'][n][1]:.2e} (max/norm)")
    log(f"    ReLU mask flips per DoubleConv output (fused vs xla): "
        f"{ {short(n): f for n, f in flips.items()} }; vs f64: fused {flips64['fused']}, "
        f"xla {flips64['xla']}")
    grad_max = max(r[0] for r in rels.values())
    grad_rel = max(r[1] for r in rels.values())
    # Worst distance to the f64 gradients over the tensors, (max, norm) forms.
    worst64 = {k: (max(r[0] for r in v.values()), max(r[1] for r in v.values()))
               for k, v in to64.items()}
    log(f"  f64 witness: worst gradient distance to the f64 step, fused f32 "
        f"{worst64['fused'][0]:.2e}·max|g| / {worst64['fused'][1]:.2e}·||g||, unfused f32 "
        f"{worst64['xla'][0]:.2e}·max|g| / {worst64['xla'][1]:.2e}·||g||; loss f64 "
        f"{l64:.8f}, fused rel {_rel(lf, l64):.2e}, xla rel {_rel(lx, l64):.2e}")
    stat_rel = max((bf[n] - bx[n]).abs().max().item() / max(bx[n].abs().max().item(), 1e-30)
                   for n in bx)
    log(f"  f32 step fused+kernel shear vs xla+plain shear (batch {F32_BATCH}): loss "
        f"{lf:.6f} vs {lx:.6f} (rel {loss_rel:.2e}), worst grad {grad_rel:.2e}·||g|| "
        f"(max-element form {grad_max:.2e}·max|g|), running stats {stat_rel:.2e}·max|ref|, "
        f"augmentation rel {aug_err:.2e}")
    # Gradients are held in norm to GRAD_TOL and element-wise to
    # GRAD_MAX_TOL: where two f32 paths' sums put a pre-activation on
    # opposite sides of zero (the flips above), that element's ReLU passes
    # its gradient in one path and not the other, and the deepest level's
    # BatchNorm averages over only 2048 samples per channel. The f64 step
    # tells rounding from a fault: the fused gradients must lie no farther
    # from it than WITNESS_RATIO times the unfused ones.
    witness_ok = all(worst64["fused"][i] <= WITNESS_RATIO * worst64["xla"][i] for i in (0, 1))
    if not (loss_rel <= 1e-4 and grad_rel <= GRAD_TOL and grad_max <= GRAD_MAX_TOL
            and stat_rel <= 1e-4 and witness_ok):
        raise AssertionError("f32 fused step disagrees with the plain step")
    return {"loss_rel": loss_rel, "grad_rel_norm": grad_rel, "grad_rel_max": grad_max,
            "relu_flips": sum(flips.values()), "stats_rel": stat_rel,
            "augment_rel": aug_err,
            "f64_witness": {k: {"grad_rel_max": v[0], "grad_rel_norm": v[1],
                                "relu_flips": sum(flips64[k].values())}
                            for k, v in worst64.items()}}


# Coarse classes of device kernels by name, for the train step's profile.
KERNEL_CLASSES = [
    ("fused conv kernel", ("conv_bf16_wgmma_kernel", "conv_f32_kernel")),
    ("shear kernel", ("shear_kernel", "shear_h_kernel")),
    ("cuDNN conv", ("conv", "xmma", "gemm", "cudnn", "cutlass", "wgrad", "dgrad")),
    ("optimizer", ("adam",)),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "where", "copy", "fill")),
]


def trace_kernels(fn) -> list[tuple[str, float, int]]:
    """(kernel name, device ms, launches) of one call of ``fn`` (after a
    warm-up call) under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # Kernel events only: the host-side operator rows carry the same
    # device time again.
    return [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


def profile_step(card: str, fn, calls: int = 1) -> dict:
    """``calls`` calls of ``fn`` under torch.profiler: per call, the device
    time per class of kernel (KERNEL_CLASSES, by name), the launches and the
    largest kernels."""
    rows = [(key, t / calls, n / calls)
            for key, t, n in trace_kernels(lambda: [fn() for _ in range(calls)])]
    total = sum(r[1] for r in rows)
    classes: dict = {}
    for key, t, count in rows:
        low = key.lower()
        name = next((c for c, subs in KERNEL_CLASSES if any(x in low for x in subs)), "other")
        ms, n = classes.get(name, (0.0, 0))
        classes[name] = (ms + t, n + count)
    if total == 0:
        log(f"  profile: the profiler saw no device time [{card}]")
        return {}
    log(f"  profile, per call over {calls}: {total:.3f} ms of device time in "
        f"{sum(r[2] for r in rows):g} kernel launches [{card}]")
    for name, (ms, n) in sorted(classes.items(), key=lambda kv: -kv[1][0]):
        log(f"    {name:18s} {ms:8.3f} ms {ms / total:6.1%} ({n:g} launches)")
    for key, t, count in sorted(rows, key=lambda r: -r[1])[:10]:
        log(f"    {t:8.3f} ms x{count:<6g} {key[:110]}")
    return {"device_ms": total, "launches": sum(r[2] for r in rows),
            "classes_ms": {k: v[0] for k, v in classes.items()}}


def _pack_keys(model) -> list:
    return [m._fused[0] for m in model.modules() if hasattr(m, "_fused")]


def run_training(card: str, device="cuda") -> dict:
    """Phase 8: augmentation + train steps of the full-width EF-UNet.
    ``device="cpu"`` rehearses the control flow at a small size
    (tests/test_torch_chip_smoke.py): no kernel launches and no device
    timing then."""
    on_card = torch.device(device).type == "cuda"
    data_root = os.path.join(WORK, "train_data")
    shutil.rmtree(WORK, ignore_errors=True)
    with Phase("training: write scenes"):
        write_scenes(data_root, TRAIN_SCENES, seed=1)
    ds = build_dataset(
        "floodplanet", "train", generate_image_slice_object(TILE, TILE, stride=TILE),
        sensor="PS", channels="ALL", root_dir=data_root, ignore_index=0, seed_num=0,
        train_split_pct=0.8,
    )
    loader = BatchLoader(ds, TRAIN_BATCH, shuffle=True, drop_last=True, n_workers=8)
    if len(loader) < TRAIN_STEPS + 1:
        raise AssertionError(f"{len(loader)} train batches, want {TRAIN_STEPS + 1}")
    eval_batch = _to_device(next(iter(BatchLoader(ds, TRAIN_BATCH))), device)
    log(f"  {len(ds)} train tiles, {len(loader)} batches of {TRAIN_BATCH}")

    model = build_model("ef_model", ds.n_channels, ds.n_classes, dtype=torch.bfloat16,
                        device=device, conv_impl="pallas_fused", base_feat_channels=BASE)
    state = create_train_state(
        model, state_dict_from_flax(seeded_flax_variables(4, 3, BASE, seed=0)), 1e-4, "adam")
    tp = TransformParams(rotate_impl="shear_pallas", dtype="bfloat16")
    augment_step = make_augment_step(tp, 0)
    train_step = make_train_step(model, 0, tp, fuse_augmentation=False)
    eval_step = make_eval_step(model, 0)
    gen = torch.Generator(device=device).manual_seed(0)

    sync(device)
    LAUNCHES.clear()  # the training path starts here
    eval_before = eval_step(state, eval_batch)  # packs the pre-training weights
    keys_before = _pack_keys(model)
    losses = []
    with Phase("training: steps through the loader"):
        t0 = time.perf_counter()
        for n, batch in enumerate(device_prefetch(iter(loader), device)):
            if n == TRAIN_STEPS:
                break
            fixed = augment_step(gen, batch)
            state, logs = train_step(state, fixed)
            losses.append(logs["loss"])
        sync(device)
        loop_s = time.perf_counter() - t0
    fixed_losses = []
    with Phase(f"training: {FIXED_STEPS} steps on one augmented batch"):
        for _ in range(FIXED_STEPS):
            state, logs = train_step(state, fixed)
            fixed_losses.append(logs["loss"])
        sync(device)
    eval_after = eval_step(state, eval_batch)
    keys_after = _pack_keys(model)
    # An optimizer step alone, with no forward (the last step's gradients):
    # the parameters move in place and the next eval must re-pack.
    state.optimizer.step()
    eval_after = eval_step(state, eval_batch)
    sync(device)
    launches = {k: LAUNCHES[k] for k in (conv_fused.KERNEL, rotate.KERNEL)}  # ends here
    keys_opt = _pack_keys(model)

    losses = [v.item() for v in losses]
    fixed_losses = [v.item() for v in fixed_losses]
    log(f"  losses through the loader: {[round(v, 4) for v in losses]}")
    log(f"  losses on one batch: {[round(v, 4) for v in fixed_losses]}")
    if not all(math.isfinite(v) for v in losses + fixed_losses):
        raise AssertionError("non-finite training loss")
    if not fixed_losses[-1] < fixed_losses[0]:
        raise AssertionError(f"{FIXED_STEPS} steps on one batch did not lower the loss")
    forwards = TRAIN_STEPS + FIXED_STEPS + 3  # train forwards + fused eval forwards
    expected = {conv_fused.KERNEL: 9 * forwards, rotate.KERNEL: 3 * TRAIN_STEPS}
    if not on_card:
        expected = {k: 0 for k in expected}  # a CPU tensor runs the plain versions
    log(f"  launches: {launches} for {forwards} forwards and {TRAIN_STEPS} augment steps")
    if launches != expected:
        raise AssertionError(f"expected launches {expected}, got {launches}")
    # Train steps move the parameters and the running statistics; the
    # optimizer step alone moves the parameters only.
    if on_card and any(a == b for a, b in zip(keys_before, keys_after)):
        raise AssertionError("the eval pack cache kept operands packed before the updates")
    if on_card and any(a == b for a, b in zip(keys_after, keys_opt)):
        raise AssertionError("the eval pack cache kept operands packed before an optimizer step")

    # The fused model after the updates against the unfused (cuDNN) model
    # on the same weights.
    model_xla = build_model("ef_model", ds.n_channels, ds.n_classes, dtype=torch.bfloat16,
                            device=device, conv_impl="xla", base_feat_channels=BASE)
    model_xla.load_state_dict(model.state_dict(), strict=True)
    eval_xla = make_eval_step(model_xla, 0)(state, eval_batch)
    cf, cx = eval_after["confusion"], eval_xla["confusion"]
    differ = ((cf - cx).abs().sum() / 2 / cx.sum()).item()
    loss_rel = _rel(eval_after["loss"].item(), eval_xla["loss"].item())
    log(f"  eval after the updates: fused loss {eval_after['loss'].item():.5f}, xla "
        f"{eval_xla['loss'].item():.5f} (rel {loss_rel:.2e}); confusion cells differ by "
        f"{differ:.2e} of the pixels; before the updates the fused loss was "
        f"{eval_before['loss'].item():.5f}")
    if not (loss_rel <= 1e-2 and differ <= 1e-3):
        raise AssertionError("fused and unfused eval disagree after the updates")

    result = {"launches": launches, "losses": losses, "fixed_losses": fixed_losses,
              "eval_loss_rel": loss_rel, "eval_confusion_differ": differ,
              "train_tiles_per_s": TRAIN_STEPS * TRAIN_BATCH / loop_s}
    log(f"  train tiles/s through the loader (host clock, loading, augmentation and "
        f"step included): {result['train_tiles_per_s']:.1f} [{card}]")
    result["f32_step"] = f32_step_check(card, eval_batch, device)

    if on_card:
        # Device times (CUDA events) at batch TRAIN_BATCH: the train step
        # without augmentation, the augment step with the kernel and with
        # the plain shear, and the eval forward, for both models.
        state_xla = create_train_state(model_xla, None, 1e-4, "adam")
        step_xla = make_train_step(model_xla, 0, tp, fuse_augmentation=False)
        ms = {
            "train_step_fused": cuda_ms(lambda: train_step(state, fixed), 5),
            "train_step_xla": cuda_ms(lambda: step_xla(state_xla, fixed), 5),
            "augment_kernel": cuda_ms(lambda: augment_step(gen, eval_batch), 10),
        }
        with plain_shear():
            ms["augment_plain"] = cuda_ms(lambda: augment_step(gen, eval_batch), 10)
        image = fixed["image"].permute(0, 3, 1, 2)
        for name, m in (("eval_forward_fused", model), ("eval_forward_xla", model_xla)):
            m.eval()
            with torch.inference_mode():
                ms[name] = cuda_ms(lambda: m({"image": image}), 5)
        for name, value in ms.items():
            log(f"  {name}: {value:.3f} ms per batch of {TRAIN_BATCH} [{card}]")
        result["ms"] = ms
        # Estimated: the loop's steps at these device times over its wall time.
        busy = TRAIN_STEPS * (ms["train_step_fused"] + ms["augment_kernel"]) / 1e3 / loop_s
        result["device_busy_share"] = busy
        log(f"  the loop through the loader kept the device busy ~{busy:.1%} of its "
            f"wall time [{card}]")
        # The augment step first: a short call, traced over ten calls.
        result["profile_augment_step"] = profile_step(
            card, lambda: augment_step(gen, eval_batch), calls=10)
        model.train()
        result["profile_train_step_fused"] = profile_step(card, lambda: train_step(state, fixed))
    shutil.rmtree(WORK, ignore_errors=True)
    return result


# -- 9. the fit loop -----------------------------------------------------------


def cache_parity(ds, device) -> dict:
    """Every batch of one shuffled epoch from the scene cache against the
    loader's at the same indices: bit-identical with norm_mode null, within
    LOCAL_TOL·max|ref| with local. Returns the worst local errors."""
    worst = {}
    order = np.random.default_rng((0, 0)).permutation(len(ds))
    loader = BatchLoader(ds, TRAIN_BATCH, shuffle=True, drop_last=True, n_workers=8)
    for norm in (None, "local"):
        ds.norm_mode = norm
        cache = build_device_cache(ds, 6 << 30, device)
        build = make_batch_builder(cache)
        loader.set_epoch(0)
        for k, want in enumerate(loader):
            got = build(cache.index_rows(ds, order[k * TRAIN_BATCH:(k + 1) * TRAIN_BATCH]))
            for key in ("image", "target", "mean", "std"):
                g, w = got[key].cpu().numpy(), want[key]
                if g.shape != w.shape or g.dtype != w.dtype:
                    raise AssertionError(f"cache {key} {g.shape} {g.dtype} vs loader {w.shape} {w.dtype}")
                err = float(np.abs(g.astype(np.float64) - w).max())
                rel = err / max(float(np.abs(w).max()), 1e-30)
                if (norm is None or key == "target") and not np.array_equal(g, w):
                    raise AssertionError(f"cache {key} differs from the loader's ({norm}): {err:.3e}")
                if rel > LOCAL_TOL:
                    raise AssertionError(f"cache {key} off by {rel:.3e}·max|ref| ({norm})")
                if norm == "local":
                    worst[key] = max(worst.get(key, 0.0), rel)
        log(f"  cache vs loader, norm {norm}: {len(loader)} batches of {TRAIN_BATCH}, "
            f"{'bit-identical' if norm is None else f'worst rel {worst}'}")
    ds.norm_mode = None
    return worst


def fit_overrides(data_root: str, exp: str, epochs: int, *extra: str) -> list[str]:
    return [
        "dataset.sensor=PS", f"dataset.dataset_kwargs.root_dir={data_root}",
        f"crop_height={TILE}", f"crop_width={TILE}", f"crop_stride={TILE}",
        f"batch_size={TRAIN_BATCH}", "n_workers=8", f"n_epochs={epochs}",
        f"limit_train_batches={FIT_LIMIT_TRAIN}", f"limit_val_batches={FIT_LIMIT_VAL}",
        "save_topk_models=2", "tpu.resume_every=2", "tpu.async_checkpoint=true",
        f"log_image_iter={FIT_LOG_IMAGE_ITER}", "tpu.conv_impl=pallas_fused",
        "tpu.compute_dtype=bfloat16", f"model.model_kwargs.base_feat_channels={BASE}",
        f"run.dir={exp}", *extra,
    ]


@contextlib.contextmanager
def watch_checkpoints():
    """Within the block, record every ``CheckpointManager.save`` (epoch,
    monitored metric, force, losses, written or not) and hold every
    ``restore`` to the file it read: model and optimizer tensors bit for
    bit, and the step."""
    saves, restores = [], []
    save, restore = ckpt.CheckpointManager.save, ckpt.CheckpointManager.restore

    def saving(self, state, epoch, metrics, force=False):
        path = save(self, state, epoch, metrics, force)
        saves.append({"epoch": epoch, "metric": metrics[ckpt.MONITOR_KEY], "force": force,
                      "losses": [metrics["train_loss"], metrics["valid_loss"]],
                      "written": path is not None})
        return path

    def restoring(self, path, state):
        state = restore(self, path, state)
        want = ckpt.read_checkpoint(path)
        got_model = state.model.state_dict()
        got_opt = state.optimizer.state_dict()["state"]
        same = all(torch.equal(got_model[k].cpu(), v) for k, v in want["model"].items())
        same &= all(torch.equal(got_opt[i][k].cpu(), v) for i, s in want["optimizer"]["state"].items()
                    for k, v in s.items())
        if not (same and state.step == want["step"]):
            raise AssertionError(f"the restored state differs from {path}")
        restores.append(path)
        return state

    ckpt.CheckpointManager.save, ckpt.CheckpointManager.restore = saving, restoring
    try:
        yield saves, restores
    finally:
        ckpt.CheckpointManager.save, ckpt.CheckpointManager.restore = save, restore


def expected_index(saves: list[dict], top_k: int, every: int) -> tuple[list, str]:
    """The retention rules, written out again: (kept (epoch, kind), latest
    epoch) after ``saves``; an epoch writes when it is forced or a resume
    point (full) or enters the top-k (slim)."""
    kept: list[tuple] = []  # (metric, epoch, kind)
    for s in saves:
        top = sorted((m for m, _, _ in kept), reverse=True)[:top_k]
        if s["force"] or s["epoch"] % every == 0:
            kind = "full"
        elif len(top) < top_k or s["metric"] > top[-1]:
            kind = "slim"
        else:
            continue
        kept = sorted(kept + [(s["metric"], s["epoch"], kind)], key=lambda e: -e[0])
        latest = max(e for _, e, k in kept if k == "full")
        kept = [e for i, e in enumerate(kept) if i < top_k or e[1] == latest]
    return sorted((e, k) for _, e, k in kept), latest


def check_fit_dir(exp: str, saves: list[dict]) -> dict:
    with open(os.path.join(exp, "checkpoints", "index.json")) as handle:
        index = json.load(handle)
    got = sorted((e["epoch"], e["kind"]) for e in index["entries"])
    want, latest = expected_index(saves, 2, 2)
    latest_epoch = next(e["epoch"] for e in index["entries"] if e["name"] == index["latest"])
    if got != want or latest_epoch != latest:
        raise AssertionError(f"index.json keeps {got} (latest {latest_epoch}); the retention "
                             f"rules keep {want} (latest {latest})")
    for s in saves:
        if not all(math.isfinite(v) for v in s["losses"]):
            raise AssertionError(f"non-finite loss in epoch {s['epoch']}: {s['losses']}")
    with open(os.path.join(exp, "timing.json")) as handle:
        return json.load(handle)


def fit_forwards(timing: dict, n_loader: int, n_valid_batches: int) -> int:
    """Forwards of a fit: train steps, validation batches, image panels."""
    epochs = timing["epochs"]
    steps = sum(e["n_train_batches"] for e in epochs)
    g0 = epochs[0]["epoch"] * n_loader
    panels = sum(1 for g in range(g0 + 1, g0 + steps + 1) if g % FIT_LOG_IMAGE_ITER == 0)
    return steps + len(epochs) * min(FIT_LIMIT_VAL, n_valid_batches) + panels


def run_fit(card: str, device="cuda") -> dict:
    """Phase 9: the fit loop through its CLI on the scene cache, a resume,
    a no-op re-run, the host loader, and serving from the best checkpoint.
    ``device="cpu"`` rehearses it at a small size
    (tests/test_torch_chip_smoke.py): no kernel launches and no device
    timing then."""
    on_card = torch.device(device).type == "cuda"
    data_root = os.path.join(WORK, "fit_data")
    exp, exp_host = os.path.join(WORK, "fit_exp"), os.path.join(WORK, "fit_exp_host")
    shutil.rmtree(WORK, ignore_errors=True)
    with Phase("fit: write scenes"):
        write_scenes(data_root, TRAIN_SCENES, seed=1)
    split = dict(sensor="PS", channels="ALL", root_dir=data_root, ignore_index=0,
                 seed_num=0, train_split_pct=0.8)
    slices = generate_image_slice_object(TILE, TILE, stride=TILE)
    ds = build_dataset("floodplanet", "train", slices, **split)
    n_valid = len(build_dataset("floodplanet", "valid", slices, **split))
    n_loader, n_valid_batches = len(ds) // TRAIN_BATCH, -(-n_valid // TRAIN_BATCH)
    with Phase("fit: cache parity"):
        local_worst = cache_parity(ds, device)
    cli = ["--device", str(device)]
    launches = {}

    def counted(name, fn):
        sync(device)
        LAUNCHES.clear()  # a main path starts here
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        launches[name] = LAUNCHES[conv_fused.KERNEL]  # and ends here
        return out, time.perf_counter() - t0

    with Phase(f"fit: {FIT_EPOCHS} epochs through the CLI"), watch_checkpoints() as (saves, _):
        _, fit_s = counted("fit", lambda: fit_cli.main(cli + fit_overrides(data_root, exp, FIT_EPOCHS)))
    timing = check_fit_dir(exp, saves)
    forwards = {"fit": fit_forwards(timing, n_loader, n_valid_batches)}
    # The resumed epoch runs under the fit's torch.profiler trace
    # (profiler=advanced): its device-busy share, measured.
    with Phase("fit: resume to one more epoch"), watch_checkpoints() as (saves_more, restores):
        counted("resume", lambda: fit_cli.main(cli + fit_overrides(
            data_root, exp, FIT_EPOCHS + 1, "profiler=advanced")))
    traced = trace_busy(os.path.join(exp, "profile", f"epoch{FIT_EPOCHS}.json"))
    log(f"  trace of the resumed epoch: the device busy {traced['busy_share']:.1%} of "
        f"{traced['span_ms']:.0f} ms, {traced['kernels']} kernels; {traced['gaps_over_1ms']} "
        f"idle gaps of 1 ms or more, {traced['gaps_ms']:.0f} ms in all; host time in CUDA "
        f"runtime calls {traced['runtime_ms']} [{card}]")
    timing_resume = check_fit_dir(exp, saves + saves_more)
    forwards["resume"] = fit_forwards(timing_resume, n_loader, n_valid_batches)
    if len(restores) != 1 or [e["epoch"] for e in timing_resume["epochs"]] != [FIT_EPOCHS]:
        raise AssertionError(f"the resumed fit restored {restores} and ran "
                             f"{timing_resume['epochs']}, want epoch {FIT_EPOCHS} alone")
    with Phase("fit: a finished experiment"):
        best, _ = counted("noop", lambda: fit_cli.main(cli + fit_overrides(data_root, exp, FIT_EPOCHS + 1)))
    forwards["noop"] = 0
    with Phase("fit: host loader"), watch_checkpoints() as (saves_host, _):
        counted("host", lambda: fit_cli.main(cli + fit_overrides(data_root, exp_host, 2,
                                                                  "tpu.device_data_bytes=0")))
    timing_host = check_fit_dir(exp_host, saves_host)
    forwards["host"] = fit_forwards(timing_host, n_loader, n_valid_batches)
    if not os.path.isfile(os.path.join(best, ckpt.CHECKPOINT_FILE)):
        raise AssertionError(f"no best checkpoint at {best!r}")

    # Serving from the best checkpoint on one warm model, both input paths.
    cfg = load_experiment_config(exp)
    cfg_host = load_experiment_config(exp)
    cfg_host.tpu.device_data_bytes = 0
    serve_ds = build_infer_dataset(cfg, "floodplanet", "all")
    model = load_model_for_eval(cfg, best, serve_ds, device)
    # In turns (cache, host, host, cache), so that neither path's first
    # use decides the comparison.
    serve_s = {"cache": 0.0, "host": 0.0}
    batch = int(cfg.tpu.inference_batch_size)
    for k, (name, c) in enumerate((("cache", cfg), ("host", cfg_host),
                                   ("host", cfg_host), ("cache", cfg))):
        with Phase(f"fit: serve the best checkpoint ({name})"):
            paths, seconds = counted(f"serve {k} {name}", lambda: infer(
                c, None, "floodplanet", "all", os.path.join(WORK, "fit_masks", str(k)),
                warm=model, dataset=serve_ds, device=device))
            serve_s[name] += seconds / 2
            check_masks(paths, TRAIN_SCENES)
        forwards[f"serve {k} {name}"] = -(-len(serve_ds) // batch)
    probs = {}
    for name, budget in (("cache", 6 << 30), ("host", 0)):
        probs[name] = {s["image_name"]: s["probabilities"] for s in sliding_window_predict(
            model, serve_ds, batch, n_workers=8, device=device, device_data_bytes=budget)}
    agree = min(float(np.mean(probs["cache"][k].argmax(-1) == probs["host"][k].argmax(-1)))
                for k in probs["host"])
    dprob = max(float(np.abs(probs["cache"][k] - probs["host"][k]).max()) for k in probs["host"])
    log(f"  served from {os.path.basename(best)}: cache vs host argmax agreement {agree}, "
        f"max |dp| {dprob:.3e}")
    if agree != 1.0 or not dprob <= PROB_TOL:
        raise AssertionError("serving through the cache disagrees with the host path")

    expected = {k: (9 * v if on_card else 0) for k, v in forwards.items()}
    log(f"  conv launches {launches} for forwards {forwards}")
    if launches != expected:
        raise AssertionError(f"expected conv launches {expected}, got {launches}")
    steady = {"cache": timing["steady_train_tiles_per_sec"],
              "host": timing_host["steady_train_tiles_per_sec"]}
    serve_rate = {k: len(serve_ds) / v for k, v in serve_s.items()}
    result = {
        "timing": {k: timing[k] for k in ("fit_wall", "setup_wall", "first_step_wall",
                                          "train_wall", "eval_wall", "ckpt_wall",
                                          "ckpt_bg_wall", "ckpt_drain_wall", "other_wall")},
        "timing_host": {k: timing_host[k] for k in ("fit_wall", "setup_wall", "train_wall",
                                                    "eval_wall", "ckpt_wall")},
        "steady_train_tiles_per_s": steady, "serve_tiles_per_s": serve_rate,
        "fit_cli_s": fit_s, "launches": launches, "local_norm_rel": local_worst,
        "resume_epoch_trace": traced,
        "epochs": [s["epoch"] for s in saves + saves_more],
        "val_iou": [s["metric"] for s in saves + saves_more],
    }
    # The writer fit_model chose: open_writer's choice in this process.
    writer, result["writer"] = open_writer(os.path.join(WORK, "writer_probe"))
    writer.close()
    log(f"  steady train tiles/s: cache {steady['cache']}, host loader {steady['host']}; "
        f"serving tiles/s: cache {serve_rate['cache']:.1f}, host {serve_rate['host']:.1f} "
        f"(host clock) [{card}]")
    if on_card:
        result["busy_share"] = fit_busy_shares(card, cfg, ds, timing, timing_host, model,
                                               serve_s, len(serve_ds), batch)
    shutil.rmtree(WORK, ignore_errors=True)
    return result


def host_enqueue_ms(fn, calls: int = 5) -> float:
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e3 * sorted(times)[calls // 2]


def trace_busy(path: str) -> dict:
    """The device-busy share of a torch.profiler chrome trace: the union of
    its kernels' intervals over the span from the trace's first event to
    its last kernel's end (the profiler's own host cost lowers it); the
    device's idle gaps of 1 ms or more; and the CUDA runtime calls that
    took the most host time."""
    with open(path) as handle:
        events = [e for e in json.load(handle)["traceEvents"] if e.get("ph") == "X"]
    kernels = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("cat") == "kernel")
    busy, end, gaps = 0.0, -math.inf, []
    for start, stop in kernels:
        if end > -math.inf and start - end >= 1e3:
            gaps.append(start - end)
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    span = (end - min(e["ts"] for e in events)) if kernels else 0.0
    runtime: dict = {}
    for e in events:
        if e.get("cat") == "cuda_runtime":
            runtime[e["name"]] = runtime.get(e["name"], 0.0) + e["dur"] / 1e3
    return {"busy_share": busy / span if span > 0 else 0.0, "span_ms": span / 1e3,
            "busy_ms": busy / 1e3, "kernels": len(kernels),
            "gaps_over_1ms": len(gaps), "gaps_ms": sum(gaps) / 1e3,
            "runtime_ms": dict(sorted(runtime.items(), key=lambda kv: -kv[1])[:6])}


def fit_busy_shares(card, cfg, ds, timing, timing_host, model, serve_s, n_serve, batch) -> dict:
    """Estimated device-busy shares: the device times (CUDA events) of one
    augment step, train step and cache gather at the fit's shapes, times
    the steady epochs' steps, over their train wall; and of one serving
    forward times a request's batches over its wall."""
    train_model = build_model("ef_model", ds.n_channels, ds.n_classes, dtype=torch.bfloat16,
                              conv_impl="pallas_fused", base_feat_channels=BASE)
    state = create_train_state(init_weights(train_model, 0), None, 1e-4)
    tp = dataclasses.replace(TransformParams.from_config(cfg.transforms), dtype="bfloat16")
    augment_step = make_augment_step(tp, 0)
    train_step = make_train_step(train_model, 0, tp, fuse_augmentation=False)
    cache = build_device_cache(ds, 6 << 30, "cuda")
    build = make_batch_builder(cache)
    rows = cache.index_rows(ds, np.arange(TRAIN_BATCH))
    batch0 = build(rows)
    gen = torch.Generator(device="cuda").manual_seed(0)
    fixed = augment_step(gen, batch0)
    ms = {"gather": cuda_ms(lambda: build(rows), 10),
          "augment": cuda_ms(lambda: augment_step(gen, batch0), 10),
          "train_step": cuda_ms(lambda: train_step(state, fixed), 5),
          "forward": forward_ms(model)}
    # Host clock to enqueue one call on an idle card (median of 5): near or
    # above the device time, the loop waits on the host.
    out = {"ms": ms, "host_enqueue_ms": {
        "augment": host_enqueue_ms(lambda: augment_step(gen, batch0)),
        "train_step": host_enqueue_ms(lambda: train_step(state, fixed))}}
    # The fit's per-step work alone (gather, augment, train step; no
    # logging, validation or checkpoint), host clock over 10 steps.
    order = np.random.default_rng((0, 0)).permutation(len(ds))
    sync("cuda")
    t0 = time.perf_counter()
    for k in range(10):
        rows_k = cache.index_rows(ds, order[k * TRAIN_BATCH:(k + 1) * TRAIN_BATCH])
        train_step(state, augment_step(gen, build(rows_k)))
    sync("cuda")
    out["bare_loop_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / 10
    # One image panel of the fit (train/logging.py) on a batch-8 train
    # batch, through the writer the fit uses, host clock.
    writer, _ = open_writer(os.path.join(WORK, "panel_probe"))
    t0 = time.perf_counter()
    for k in range(3):
        log_image_panel(writer, "probe", fixed["image"][0].float().cpu().numpy(),
                        fixed["mean"][0].cpu().numpy(), fixed["std"][0].cpu().numpy(),
                        np.zeros((TILE, TILE, 3), np.float32),
                        fixed["target"][0].cpu().numpy(), ds.to_RGB, k)
    out["panel_ms"] = (time.perf_counter() - t0) * 1e3 / 3
    writer.close()
    for name, t, extra in (("fit_cache", timing, ms["gather"]), ("fit_host", timing_host, 0.0)):
        steady = t["epochs"][1:]
        steps = sum(e["n_train_batches"] for e in steady)
        wall = sum(e["train_wall"] for e in steady)
        out[name] = steps * (ms["augment"] + ms["train_step"] + extra) / 1e3 / wall
    for name, wall in serve_s.items():
        out[f"serve_{name}"] = -(-n_serve // batch) * ms["forward"] / 1e3 / wall
    log(f"  device times {ms} ms, host enqueue {out['host_enqueue_ms']} ms, the bare "
        f"step loop {out['bare_loop_ms_per_step']:.1f} ms per step, one image panel "
        f"{out['panel_ms']:.1f} ms (host clock); estimated busy shares "
        f"{ {k: round(v, 3) for k, v in out.items() if 'ms' not in k} } [{card}]")
    return out


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
    with Phase("shear parity"):
        shear_worst = shear_parity()
    with Phase("shear timing"):
        shear_row = shear_timing(card)
    with Phase("training"):
        train = run_training(card)
    with Phase("fit"):
        fit = run_fit(card)

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
        # The main paths: serving (9 per forward), training (9 per
        # train-step forward and per fused eval forward) and the fit loop
        # (9 per train step, validation batch and image panel, and per
        # serving forward from its best checkpoint).
        "launches": (result["launches"] + train["launches"][conv_fused.KERNEL]
                     + sum(fit["launches"].values())),
        "launches_by_path": {"serving": result["launches"],
                             "training": train["launches"][conv_fused.KERNEL],
                             "fit": sum(fit["launches"].values())},
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
    }, {
        "name": rotate.KERNEL,
        "route": "cuda",
        "source": "floodplanet_code_tpu_torch/ops/csrc/rotate.cu",
        "replaces": "floodplanet_code_tpu/ops/rotate.py:193",
        "launches": train["launches"][rotate.KERNEL],  # 3 per augment step
        # Parity over both shapes, axes, orders and types, and the timed launch.
        "max_abs_err": max(shear_worst[torch.bfloat16][1], shear_worst[torch.float32][1],
                           shear_row["max_abs_err"]),
        "max_rel_err_f32": shear_worst[torch.float32][0],
        "max_rel_err_bf16": shear_worst[torch.bfloat16][0],
        # Times are per launch at [8, 512, 512, 6] bf16: ms is the kernel's
        # device time from a trace, wrapper_ms the wrapper's time per call
        # (CUDA events); library_ms is one F.grid_sample of the same shear
        # (bilinear on every channel).
        "ms": shear_row["ms"],
        "wrapper_ms": shear_row["wrapper_ms"],
        "launches_per_call": shear_row["launches_per_call"],
        "axis1_ms": shear_row["axis1_ms"],  # the shear along H, trace
        "plain_ms": shear_row["plain_ms"],
        "bound_ms": shear_row["bound_ms"],
        "bound_by": shear_row["bound_by"],
        "library_ms": shear_row["library_ms"],
    }]}
    log(json.dumps({"slice": {k: v for k, v in result.items() if k != "launches"}}))
    log(json.dumps({"train": {k: v for k, v in train.items() if k != "launches"}}))
    log(json.dumps({"fit": fit}))
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
