"""What a run is given, made from ``--seed`` alone: synthetic scenes and
chips, and the model's weights.

Each scene or chip is a function of (seed, its index) only, drawn on the
card with a ``torch.Generator`` in a few large calls, so the reference can
make any one of them again after the window. The contents follow the
published formats (PlanetScope 4-band uint16 stored HWC with CSDAP labels
{0 nodata, 1 dry, 2 flood}; Sen1Floods11 S1 VV/VH float32 dB with labels
{-1, 0, 1}) and the synthetic recipe the repository's tests use: band 0
(VV) follows the flood label, the rest is uniform noise.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch


def _generator(seed: int, *key: int, device="cuda") -> torch.Generator:
    state = np.random.SeedSequence((int(seed), *map(int, key))).generate_state(2, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]) >> 1)


def ps_scene(seed: int, index: int, h: int, w: int, device="cuda"):
    """(image [h, w, 4] uint16, label [h, w] uint8) numpy arrays."""
    g = _generator(seed, 1, index, device=device)
    u = torch.rand((h, w), generator=g, device=device)
    label = (u >= 0.1).to(torch.uint8) + (u >= 0.7).to(torch.uint8)
    image = torch.randint(0, 8000, (h, w, 4), generator=g, device=device, dtype=torch.int32)
    image[..., 0] = torch.where(label == 2, 7200, 800)
    return image.cpu().numpy().astype(np.uint16), label.cpu().numpy()


def s1_chip(seed: int, index: int, size: int, device="cuda"):
    """(image [size, size, 2] float32 dB, label [size, size] int16) numpy
    arrays; the TIFF holds the image band-sequential."""
    g = _generator(seed, 2, index, device=device)
    u = torch.rand((size, size), generator=g, device=device)
    label = (u >= 0.1).to(torch.int16) + (u >= 0.7).to(torch.int16) - 1
    image = torch.rand((size, size, 2), generator=g, device=device) * 35.0 - 30.0
    image[..., 0] = torch.where(label == 1, 4.0, -25.0)
    return image.cpu().numpy(), label.cpu().numpy()


def scene(config: dict, seed: int, index: int, hw, device="cuda"):
    """The raw (image HWC, label) of ``config``'s sensor."""
    if config["sensor"] == "PS":
        return ps_scene(seed, index, hw[0], hw[1], device)
    if config["sensor"] == "S1":
        return s1_chip(seed, index, hw[0], device)
    raise ValueError(f"no synthetic data for sensor {config['sensor']!r}")


def write_scene(config: dict, root: str, name: str, image: np.ndarray, label: np.ndarray,
                region: str, imwrite) -> str:
    """Write one scene in its dataset's layout under ``root`` with the
    system's TIFF writer ``imwrite``; returns the image's path."""
    if config["dataset"] == "floodplanet":
        base = os.path.join(root, "CSDAP_complete", region)
        os.makedirs(os.path.join(base, "labels"), exist_ok=True)
        os.makedirs(os.path.join(base, config["sensor"]), exist_ok=True)
        path = os.path.join(base, config["sensor"], name + ".tif")
        imwrite(os.path.join(base, "labels", name + ".tif"), label)
        imwrite(path, image, planar_as_chw=False)
        return path
    if config["dataset"] == "sen1floods11":
        stem = f"{region}_{name}"
        for sub in ("S1Hand", "LabelHand"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
        path = os.path.join(root, "S1Hand", f"{stem}_S1Hand.tif")
        imwrite(os.path.join(root, "LabelHand", f"{stem}_LabelHand.tif"), label)
        imwrite(path, np.ascontiguousarray(image.transpose(2, 0, 1)))
        return path
    raise ValueError(f"no layout for dataset {config['dataset']!r}")


def weights(shapes: list, seed: int, device="cuda") -> dict:
    """float32 tensors for [(name, shape, kind)] (a reference module's
    ``tensor_shapes``) from ``seed``, in two draws on the card: He-normal
    conv weights (std sqrt(2 / fan_in)); BatchNorm scale 1 + 0.1 n and bias
    0.1 n; conv biases 0.1 n; running mean 0 and variance 1."""
    g = _generator(seed, 3, device=device)
    convs = [(n, s) for n, s, k in shapes if k == "conv"]
    vecs = [(n, s, k) for n, s, k in shapes if k in ("scale", "bias", "conv_bias")]
    z = torch.randn(sum(math.prod(s) for _, s in convs), generator=g, device=device)
    zv = torch.randn(sum(math.prod(s) for _, s, _ in vecs), generator=g, device=device)
    out, at = {}, 0
    for name, shape in convs:
        n = math.prod(shape)
        fan_in = shape[1] * shape[2] * shape[3]
        out[name] = z[at:at + n].view(shape) * math.sqrt(2.0 / fan_in)
        at += n
    at = 0
    for name, shape, kind in vecs:
        n = math.prod(shape)
        v = zv[at:at + n].view(shape) * 0.1
        out[name] = v + 1.0 if kind == "scale" else v
        at += n
    for name, shape, kind in shapes:
        if kind == "mean":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "var":
            out[name] = torch.ones(shape, device=device)
    return out
