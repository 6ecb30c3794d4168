"""Plain reference of the input side: scene tiling, radiometric range
normalization, label binarization, the training crops' padding, and the
training augmentation (flips and the three-shear rotation), in float32.

Frozen from the reference's description (st_water_seg datasets/utils.py
``get_crop_slices`` mode "exact", floodplanet.py's per-sensor loaders and
labels, torchvision-style rotation as the system computes it: a quarter
turn and three shears, each resampling one axis with a linear blend, labels
nearest). It reads only raw arrays that the benchmark generated.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def crop_slices(height: int, width: int, crop: int, stride: int) -> list:
    """[h0, w0, h, w] windows over a scene (mode "exact"): full crops at
    ``stride`` that fit, then remainder windows along the right edge, the
    bottom edge and the corner. The stride is clamped to the scene."""
    sh, sw = min(stride, height), min(stride, width)

    def fitting(extent, step):
        n = 0
        while n * step + crop <= extent:
            n += 1
        return n

    nh, nw = fitting(height, sh), fitting(width, sw)
    out = [[i * sh, j * sw, crop, crop] for i in range(nh) for j in range(nw)]
    rh, rw = height - nh * sh, width - nw * sw
    if rw:
        out += [[i * sh, nw * sw, crop, rw] for i in range(nh)]
    if rh:
        out += [[nh * sh, j * sw, rh, crop] for j in range(nw)]
    if rh and rw:
        out.append([nh * sh, nw * sw, rh, rw])
    return out


def normalize(raw: np.ndarray, sensor: str) -> np.ndarray:
    """[H, W, C] raw bands -> float32 in the sensor's range (PS uint16 / 2^16;
    S1 dB clip((x + 50) / 100, 0, 1) with NaN as 0)."""
    if sensor == "PS":
        return raw.astype(np.float32) / np.float32(65536.0)
    if sensor == "S1":
        return np.nan_to_num(np.clip((raw.astype(np.float32) + 50.0) / 100.0, 0.0, 1.0))
    raise ValueError(f"no reference normalization for sensor {sensor!r}")


def binarize(raw_label: np.ndarray, dataset: str, ignore_index: int) -> np.ndarray:
    """Class labels: FloodPlanet raw {0 nodata, 1 dry, 2 flood} -> 2 is 1,
    1 is 0, 0 is ``ignore_index``; Sen1Floods11 {-1, 0, 1} -> -1 is
    ``ignore_index``."""
    raw = raw_label.astype(np.int32)
    if dataset == "floodplanet":
        out = (raw == 2).astype(np.int32)
        out[raw == 0] = ignore_index
        return out
    if dataset == "sen1floods11":
        return np.where(raw == -1, ignore_index, raw)
    raise ValueError(f"no reference labels for dataset {dataset!r}")


def crop(image: np.ndarray, label: np.ndarray, window, size: int, ignore_index: int):
    """(image [size, size, C] zero-padded, label [size, size] padded with
    ``ignore_index``) of one window of a normalized scene."""
    h0, w0, h, w = window
    img = np.zeros((size, size, image.shape[2]), np.float32)
    lbl = np.full((size, size), ignore_index, np.int32)
    img[:h, :w] = image[h0:h0 + h, w0:w0 + w]
    lbl[:h, :w] = label[h0:h0 + h, w0:w0 + w]
    return img, lbl


# -- augmentation -------------------------------------------------------------


def draws(u: torch.Tensor, p_h: float, p_v: float, p_r: float, lo: float, hi: float):
    """Per-sample flips and angle in degrees from four uniforms per sample,
    ``u`` [4, B] in the order hflip, vflip, rotate, angle."""
    do_h, do_v, do_r = u[0] < p_h, u[1] < p_v, u[2] < p_r
    angles = (u[3] * (hi - lo) + lo) * (math.pi / 180.0)
    angles = torch.where(do_r, angles, torch.zeros_like(angles))
    return do_h, do_v, angles * (180.0 / math.pi)


def _shear(x: torch.Tensor, shear: torch.Tensor, axis: int, nearest_from: int):
    """Shift each line of x [B, H, W, C] along ``axis`` (2: along W, one
    shift per row; 1: along H, one per column) by shear * (line - (n-1)/2),
    linear blend (nearest for channels >= nearest_from), zero outside."""
    lines = x if axis == 2 else x.transpose(1, 2)
    b, n, length, c = lines.shape
    shift = shear[:, None] * (torch.arange(n, device=x.device, dtype=torch.float32)
                              - (n - 1) / 2.0)
    src = torch.arange(length, device=x.device, dtype=torch.float32)[None, None] + shift[..., None]
    i0 = torch.floor(src)
    frac = (src - i0)[..., None].expand(b, n, length, c).clone()
    frac[..., nearest_from:] = torch.round(frac[..., nearest_from:])
    i0 = i0.long()

    def take(idx):
        ok = ((idx >= 0) & (idx < length))[..., None]
        got = torch.take_along_dim(lines, idx.clamp(0, length - 1)[..., None].expand(b, n, length, c),
                                   dim=2)
        return torch.where(ok, got, torch.zeros((), dtype=x.dtype, device=x.device))

    out = take(i0) * (1 - frac) + take(i0 + 1) * frac
    return out if axis == 2 else out.transpose(1, 2)


def rotate_flip(x: torch.Tensor, angles_deg: torch.Tensor, do_h: torch.Tensor,
                do_v: torch.Tensor, nearest_from: int) -> torch.Tensor:
    """hflip, then vflip, then a counter-clockwise rotation about the centre,
    of square x [B, H, W, C]: the residual angle in (-45, 45] by three shears
    (ShearX(-tan(t/2)), ShearY(sin t), ShearX(-tan(t/2))), its sign turned
    for an odd number of flips, then one dihedral element for the quarter
    turns and both flips."""
    angles = angles_deg.float() % 360.0
    turns = torch.floor((angles + 45.0) / 90.0)
    k = turns.long() % 4
    residual = angles - 90.0 * turns
    sigma = torch.where(do_h ^ do_v, -1.0, 1.0)
    theta = sigma * residual * (math.pi / 180.0)
    a, b = -torch.tan(theta / 2.0), torch.sin(theta)
    out = _shear(x, a, 2, nearest_from)
    out = _shear(out, b, 1, nearest_from)
    out = _shear(out, a, 2, nearest_from)
    transpose = (k % 2) == 1
    flip_rows = torch.stack([do_v, ~do_h, ~do_v, do_h]).gather(0, k[None])[0]
    flip_cols = torch.stack([do_h, do_v, ~do_h, ~do_v]).gather(0, k[None])[0]

    def where(cond, p, q):
        return torch.where(cond[:, None, None, None], p, q)

    out = where(transpose, out.transpose(1, 2), out)
    out = where(flip_rows, out.flip(1), out)
    return where(flip_cols, out.flip(2), out)


def augment(image: torch.Tensor, target: torch.Tensor, u: torch.Tensor, t: dict,
            label_fill: float = 0.0):
    """The training augmentation of image [B, H, W, C] f32 and target
    [B, H, W] for the uniforms ``u`` [4, B]; ``t`` the transforms' settings
    (hflip, vflip, rotate likelihoods and the angle range). Pixels rotated in
    from outside take label ``label_fill``."""
    do_h, do_v, deg = draws(u, t["hflip"], t["vflip"], t["rotate"], t["min_angle"],
                            t["max_angle"])
    c = image.shape[-1]
    both = torch.cat([image, target[..., None].float(), torch.ones_like(image[..., :1])], dim=-1)
    out = rotate_flip(both, deg, do_h, do_v, nearest_from=c)
    inside = out[..., c + 1] > 0.5
    label = torch.where(inside, out[..., c], torch.full_like(out[..., c], label_fill))
    return out[..., :c], torch.round(label).long()
