"""Benchmark of the PyTorch port: UNet train throughput on 512x512 tiles,
per card (the counterpart of bench.py, which times the JAX package).

    python3 bench_torch.py [--conv_impl xla|pallas_fused] [--device cuda]

Prints ONE JSON line with bench.py's keys:

    {"metric": "...", "value": N, "unit": "tiles/s/chip", "vs_baseline": N,
     "augmented_recipe_value": N, "augmented_recipe_vs_baseline": N,
     "inference_value": N, "flops": N, "mfu": N, "inference_flops": N,
     "inference_mfu": N}

The workload is bench.py's: batch 8 per card of 512^2 tiles, 4 PlanetScope
bands, 3 classes, a seed-0 numpy image with ``target = image[..., 0] > 0``,
the early-fusion UNet (``ef_model``) with bf16 compute, f32 parameters and
Adam at 1e-4. Three things are timed, each over 3 warm-up and ``steps``
timed steps between two ``torch.cuda.synchronize()`` calls (host clock):

- ``value``: the bare train step (``make_train_step``: forward, loss,
  backward, Adam, the BatchNorm update, the confusion matrix);
- ``augmented_recipe_value``: the reference recipe, ``make_augment_step``
  (flips and rotation at p=0.5, bf16, the roll shear, as the fit runs it)
  feeding the train step;
- ``inference_value``: ``make_predict_step``'s forward and softmax.

The train steps run inside ``train/fit.py::deterministic_algorithms``, as
``fit_model`` runs them. ``vs_baseline`` is against bench.py's estimated
reference-GPU figure, ``REF_GPU_TILES_PER_SEC``.

``flops`` counts the convolutions' work from the model's own shapes,
2·N·H·W·C_in·C_out·k² per conv: the fused kernel and cuDNN do the same
work, so it does not depend on ``conv_impl``. A train step is the forward
plus twice the forward (the input and weight gradients), less the first
conv's input gradient, which nothing computes. ``mfu`` is that count over
the step's time times the card's dense bf16 peak (``device.PEAKS``; an
unknown card raises); on the CPU ``mfu`` and ``inference_mfu`` are null.
There is no ``bytes_accessed`` or ``hbm_util``: the port has no
counterpart of XLA's cost analysis, from which bench.py takes them.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from floodplanet_code_tpu_torch.config import compose
from floodplanet_code_tpu_torch.data.augment import TransformParams
from floodplanet_code_tpu_torch.device import peaks, resolve_device
from floodplanet_code_tpu_torch.inference.sliding import make_predict_step
from floodplanet_code_tpu_torch.models import build_model
from floodplanet_code_tpu_torch.models.unet import DoubleConv, UNetDecoder
from floodplanet_code_tpu_torch.train import (
    create_train_state,
    init_weights,
    make_augment_step,
    make_train_step,
)
from floodplanet_code_tpu_torch.train.fit import (
    deterministic_algorithms,
    set_cublas_workspace_config,
)

REF_GPU_TILES_PER_SEC = 16.0  # bench.py's estimated reference-GPU figure

TILE = 512
BATCH = 8
CHANNELS = 4
N_CLASSES = 3
WARMUP = 3


def conv_flops(model, inputs: dict) -> tuple[float, float]:
    """(forward FLOPs, the first conv's input-gradient FLOPs) of ``model``
    on ``inputs``: every DoubleConv's two 3x3 convs at the height and width
    it runs at, and the decoder's 1x1 head, counted from one forward."""
    flops, first = [], []

    def conv(n, h, w, weight):
        c_out, c_in, kh, kw = weight.shape
        return 2.0 * n * h * w * c_in * c_out * kh * kw

    def double_conv(module, args):
        n, _, h, w = args[0].shape
        for c in (module.conv0, module.conv1):
            flops.append(conv(n, h, w, c.weight))
        if not first:
            first.append(flops[-2])

    def decoder(module, args):
        n, _, h, w = args[0][0].shape
        flops.append(conv(n, h, w, module.outc.weight))

    hooks = [m.register_forward_pre_hook(double_conv) for m in model.modules()
             if isinstance(m, DoubleConv)]
    hooks += [m.register_forward_pre_hook(decoder) for m in model.modules()
              if isinstance(m, UNetDecoder)]
    try:
        with torch.inference_mode():
            model.eval()
            model(inputs)
    finally:
        for hook in hooks:
            hook.remove()
    return sum(flops), first[0]


def _timed(fn, steps: int, device: torch.device) -> float:
    """Seconds per call of ``fn`` over ``steps`` calls after WARMUP."""
    for _ in range(WARMUP):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / steps


def main(conv_impl: str | None = None, device="cuda", tile: int = TILE, batch: int = BATCH,
         base_feat_channels: int = 64, steps: int = 20) -> dict:
    set_cublas_workspace_config()
    device = resolve_device(device)
    conv_impl = conv_impl or str(compose().tpu.conv_impl)
    image = np.random.default_rng(0).standard_normal((batch, tile, tile, CHANNELS)).astype(
        np.float32)
    data = {"image": torch.from_numpy(image).to(device),
            "target": torch.from_numpy((image[..., 0] > 0).astype(np.int64)).to(device)}
    model = build_model("ef_model", {"ms_image": CHANNELS}, N_CLASSES, dtype=torch.bfloat16,
                        device=device, conv_impl=conv_impl,
                        base_feat_channels=base_feat_channels)
    init_weights(model, 0)
    inputs = {"image": data["image"].permute(0, 3, 1, 2)}
    forward_flops, first_dgrad = conv_flops(model, inputs)
    train_flops = 3 * forward_flops - first_dgrad
    state = create_train_state(model, None, lr=1e-4, optimizer_name="adam")
    train_step = make_train_step(model, 0, TransformParams(False, 0, False, 0, False, 0),
                                 fuse_augmentation=False)
    augment_step = make_augment_step(TransformParams(dtype="bfloat16"), 0)
    generator = torch.Generator(device=device).manual_seed(0)
    with deterministic_algorithms():
        bare_s = _timed(lambda: train_step(state, data), steps, device)
        recipe_s = _timed(lambda: train_step(state, augment_step(generator, data)), steps, device)
    model.eval()
    predict_step = make_predict_step(model)
    infer_s = _timed(lambda: predict_step(inputs), steps, device)

    bare, recipe, infer = batch / bare_s, batch / recipe_s, batch / infer_s
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    peak = peaks(name)[0] if device.type == "cuda" else None
    result = {
        "metric": f"{tile}x{tile} PS train tiles/sec/chip (EF-UNet bf16, torch, {name}, "
                  f"conv_impl={conv_impl})",
        "value": round(bare, 2),
        "unit": "tiles/s/chip",
        "vs_baseline": round(bare / REF_GPU_TILES_PER_SEC, 3),
        "augmented_recipe_value": round(recipe, 2),
        "augmented_recipe_vs_baseline": round(recipe / REF_GPU_TILES_PER_SEC, 3),
        "inference_value": round(infer, 2),
        "flops": train_flops,
        "mfu": None if peak is None else round(train_flops / (bare_s * peak), 4),
        "inference_flops": forward_flops,
        "inference_mfu": None if peak is None else round(forward_flops / (infer_s * peak), 4),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--conv_impl", choices=("xla", "pallas_fused"), default=None,
                        help="default: the port config's tpu.conv_impl")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(conv_impl=args.conv_impl, device=args.device)
