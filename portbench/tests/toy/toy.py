"""A toy segmentation model that is not a UNet, in plain PyTorch, float32:
a 3x3 stride-2 patch embedding with a bias, a LayerNorm over channels (eps
1e-6), a residual MLP (Linear, GELU, Linear), a bilinear 2x upsample
(align_corners False) and a biased 1x1 head; no running statistics.

The reference module of the tests' toy configuration (``"reference":
"toy"``), copied as ``portbench/reference/toy.py`` into a copy of the
benchmark: the six functions of ``portbench/reference/__init__.py``, with
its own initialisation and its own operation counts.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench import counts
from portbench.reference import common

EPS = 1e-6


def tensor_shapes(config: dict) -> list:
    c_in, c, n = config["in_channels"], config["model_kwargs"]["width"], config["n_classes"]
    return [("stem.weight", (c, c_in, 3, 3), "conv"), ("stem.bias", (c,), "bias"),
            ("norm.weight", (c,), "scale"), ("norm.bias", (c,), "bias"),
            ("fc1.weight", (2 * c, c), "linear"), ("fc1.bias", (2 * c,), "bias"),
            ("fc2.weight", (c, 2 * c), "linear"), ("fc2.bias", (c,), "bias"),
            ("head.weight", (n, c, 1, 1), "conv"), ("head.bias", (n,), "bias")]


def weights(config: dict, seed: int, device) -> dict:
    """One normal draw on ``device`` from the seed: convs He-normal, linears
    std sqrt(1 / fan_in), biases 0.1 n, the LayerNorm's scale 1 + 0.1 n."""
    shapes = tensor_shapes(config)
    state = np.random.SeedSequence((int(seed), 4)).generate_state(1, np.uint64)
    g = torch.Generator(device=device).manual_seed(int(state[0]) >> 1)
    z = torch.randn(sum(math.prod(s) for _, s, _ in shapes), generator=g, device=device)
    out, at = {}, 0
    for name, shape, kind in shapes:
        v = z[at:at + math.prod(shape)].view(shape)
        at += math.prod(shape)
        if kind == "conv":
            out[name] = v * math.sqrt(2.0 / math.prod(shape[1:]))
        elif kind == "linear":
            out[name] = v * math.sqrt(1.0 / shape[1])
        else:
            out[name] = v * 0.1 + (1.0 if kind == "scale" else 0.0)
    return out


def _logits(p: dict, image, quant=None):
    q = (lambda x: x) if quant is None else quant
    x = q(F.conv2d(q(image), q(p["stem.weight"]), q(p["stem.bias"]), stride=2, padding=1))
    t = x.permute(0, 2, 3, 1)
    h = q(F.layer_norm(t, t.shape[-1:], p["norm.weight"], p["norm.bias"], EPS))
    h = q(F.gelu(q(F.linear(h, q(p["fc1.weight"]), q(p["fc1.bias"])))))
    t = t + q(F.linear(h, q(p["fc2.weight"]), q(p["fc2.bias"])))
    x = q(F.interpolate(t.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                        align_corners=False))
    return q(F.conv2d(x, q(p["head.weight"]), q(p["head.bias"])))


def train_steps(config: dict, weights: dict, batches: list, ignore_index: int,
                quant=None) -> dict:
    return common.adam_steps(lambda p, image: (_logits(p, image, quant), {}), config, weights,
                             set(), batches, ignore_index)


def probabilities(config: dict, weights: dict, image, tta: bool, quant=None):
    return common.probabilities(lambda x: _logits(weights, x, quant), image, tta)


def batch_statistics(config: dict, weights: dict, image) -> dict:
    return {}


def _op(name: str, kind: str, flops: float, x: int, w: int, y: int, dgrad: bool = True):
    moved = {"fwd": x + w + y, "dgrad": y + w + x, "wgrad": x + y + w}
    if not dgrad:
        del moved["dgrad"]
    return counts.Op(name, kind, {p: flops for p in moved}, moved)


def work(config: dict, batch: int, height: int, width: int) -> list:
    """The stem (a conv whose input needs no gradient), the two Linears
    (kind ``matmul``) over every patch, the head (a 1x1 conv)."""
    c_in, c, n = config["in_channels"], config["model_kwargs"]["width"], config["n_classes"]
    size = counts.DTYPE_BYTES[config["compute_dtype"]]
    m = batch * (height // 2) * (width // 2)
    return [_op("stem", "conv", 2.0 * m * c_in * c * 9, batch * height * width * c_in * size,
                c_in * c * 9 * size, m * c * size, dgrad=False),
            _op("fc1", "matmul", 2.0 * m * c * 2 * c, m * c * size, 2 * c * c * size,
                m * 2 * c * size),
            _op("fc2", "matmul", 2.0 * m * 2 * c * c, m * 2 * c * size, 2 * c * c * size,
                m * c * size),
            counts.conv("head", batch, height, width, c, n, 1, size)]
