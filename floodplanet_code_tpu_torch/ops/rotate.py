"""Batched image rotation for on-device augmentation: the port of
``floodplanet_code_tpu/ops/rotate.py``.

Rotation by the 3-shear (Paeth) decomposition
``R(theta) = ShearX(a) . ShearY(b) . ShearX(a)``, ``a = -tan(theta/2)``,
``b = sin(theta)``, after reducing the angle to a residual in (-45, 45]
degrees and a quarter turn. Each shear resamples along one axis with one
fractional shift per line. Public functions keep the JAX layout,
``[B, H, W, C]``.

Shear backends (``impl``):

- ``"pallas"``: the Pallas row-shear's function (fraction quantized to
  1/65536, shifts clipped to the kernel's pad). On a CUDA tensor it launches
  the hand-written kernel ``csrc/rotate.cu`` (``shear_cuda``); on a CPU
  tensor it runs ``shear_plain``, the same function in plain PyTorch and the
  oracle the kernel is held to.
- ``"gather"`` and ``"roll"``: one plain PyTorch gather
  (``_shear_x_gather``'s arithmetic, blend in the image dtype). The JAX
  roll backend computes the same function: its clip to +-s_max never binds
  at the slopes the rotation uses.

Semantics follow torchvision ``F.rotate``: counter-clockwise about the
image center, bilinear (order 1) or nearest (order 0), constant fill;
channels >= ``nearest_from`` resample nearest-neighbour in an order-1 pass.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from floodplanet_code_tpu_torch.ops import LAUNCHES, cuda_build

KERNEL = "shear"
_NAME = "rotate"  # csrc/rotate.cu; its C functions carry the prefix rs_
IMPLS = ("pallas", "gather", "roll")


def _row_shifts(shear: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Per-line signed shift ``shear * (y - (n-1)/2)``: [B] -> [B, n]."""
    rows = torch.arange(n_rows, dtype=torch.float32, device=shear.device)
    return shear[:, None] * (rows - (n_rows - 1) / 2.0)


def _pad(n_lines: int) -> int:
    """The Pallas kernel's pad (rotate.py:330-331): covers |shift| up to
    sin(45 deg) * n/2, rounded up to a multiple of 4."""
    pad = int(np.ceil(n_lines * 0.5 * 0.7072)) + 2
    return ((pad + 3) // 4) * 4


def _quantize(shifts: torch.Tensor, order: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-line (tap offset k, fraction * 65536) as int32 [B, n_lines], with
    the Pallas path's clip and arithmetic (rotate.py:326-334, 248-275): the
    shift is clipped to +-(pad-1) and split in padded coordinates. The CUDA
    kernel computes the same per line (``csrc/rotate.cu::quantize``)."""
    pad = _pad(shifts.shape[1])
    src = shifts.float().clamp(-pad + 1, pad - 1) + pad
    if order == 0:
        k = torch.round(src)
        frac = torch.zeros_like(src)
    else:
        k = torch.floor(src)
        frac = src - k
    fq = torch.round(frac * 65536.0).to(torch.int32)
    return (k.to(torch.int32) - pad).contiguous(), fq.contiguous()


def _check(img: torch.Tensor, shifts: torch.Tensor, axis: int) -> None:
    if img.dim() != 4:
        raise ValueError(f"want img [B,H,W,C], got {tuple(img.shape)}")
    if axis not in (1, 2):
        raise ValueError(f"shear axis must be 1 or 2, got {axis}")
    n_lines = img.shape[1] if axis == 2 else img.shape[2]
    if tuple(shifts.shape) != (img.shape[0], n_lines):
        raise ValueError(
            f"want shifts [B={img.shape[0]}, {n_lines}] for axis {axis}, "
            f"got {tuple(shifts.shape)}"
        )
    if shifts.device != img.device:
        raise ValueError("img and shifts must be on one device")


def _nearest_mask(n_channels: int, nearest_from: int | None, device) -> torch.Tensor:
    chan = torch.arange(n_channels, device=device)
    limit = n_channels if nearest_from is None else nearest_from
    return chan >= limit


def _gather_line(x: torch.Tensor, idx: torch.Tensor, cval) -> torch.Tensor:
    """x [B, N, L, C] gathered along L at idx [B, N, L]; cval outside."""
    n = x.shape[2]
    valid = ((idx >= 0) & (idx < n))[..., None]
    safe = idx.clamp(0, n - 1).long()[..., None].expand(*idx.shape, x.shape[3])
    got = torch.take_along_dim(x, safe, dim=2)
    return torch.where(valid, got, torch.as_tensor(cval, dtype=x.dtype, device=x.device))


def _lines(img: torch.Tensor, axis: int) -> torch.Tensor:
    """View with the shear axis at position 2: [B, n_lines, len, C]."""
    return img if axis == 2 else img.transpose(1, 2)


def shear_plain(img, shifts, order=1, cval=0.0, nearest_from=None, axis=2):
    """The Pallas row-shear in plain PyTorch, on any device.

    img [B,H,W,C] f32 or bf16; shifts [B, n_lines] f32 (n_lines = H for
    axis 2, shear along W; W for axis 1, shear along H). Returns a new
    contiguous [B,H,W,C] in img's dtype: the blend runs in f32 and rounds
    once.
    """
    _check(img, shifts, axis)
    koff, fq = _quantize(shifts, order)
    x = _lines(img, axis)
    pos = torch.arange(x.shape[2], device=img.device, dtype=torch.int32)
    s0 = pos[None, None, :] + koff[:, :, None]
    f = (fq.float() * (1.0 / 65536.0))[:, :, None, None]
    f = torch.where(_nearest_mask(x.shape[3], nearest_from, img.device), torch.round(f), f)
    p0 = _gather_line(x, s0, cval).float()
    p1 = _gather_line(x, s0 + 1, cval).float()
    out = (p0 * (1.0 - f) + p1 * f).to(img.dtype)
    return _lines(out, axis).contiguous()


def _declare(lib: ctypes.CDLL) -> None:
    lib.rs_shear.restype = ctypes.c_int
    lib.rs_shear.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]


def build() -> tuple[str, str]:
    """Compile ``rotate.cu`` (``ops/cuda_build.py``); returns (library
    path, ``ptxas -v`` report, empty when it was built already)."""
    return cuda_build.build(_NAME)


def shear_cuda(img, shifts, order=1, cval=0.0, nearest_from=None, axis=2):
    """Launch the CUDA kernel: ``shear_plain``'s function on a card, in one
    launch (the kernel quantizes each line's shift itself, as
    ``_quantize`` does). Raises on a CPU tensor, another dtype than
    f32/bf16, a bad shape, or a launch error."""
    _check(img, shifts, axis)
    if not img.is_cuda:
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got {img.device}")
    if img.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel supports float32 and bfloat16, not {img.dtype}")
    if shifts.dtype != torch.float32:
        raise TypeError(f"shifts must be float32, not {shifts.dtype}")
    bsz, h, w, c = img.shape
    if bsz * h * w * c >= 2**31:
        raise ValueError(f"img {tuple(img.shape)} too large for int32 indexing")
    img = img.contiguous()
    shifts = shifts.contiguous()
    out = torch.empty_like(img)
    if out.numel() == 0:
        return out
    dev = img.device
    lib = cuda_build.load(_NAME, "rs", _declare, dev)
    cv = float(torch.tensor(cval, dtype=img.dtype))  # the padded value, as P holds it
    aligned = int(img.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        err = lib.rs_shear(
            img.data_ptr(), out.data_ptr(), shifts.data_ptr(), bsz, h, w, c, axis,
            int(order), _pad(shifts.shape[1]), c if nearest_from is None else int(nearest_from),
            cv, int(img.dtype == torch.bfloat16), aligned,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{KERNEL} launch failed: {cuda_build.error_string(lib, 'rs', err)} "
            f"(img {tuple(img.shape)} {img.dtype}, axis {axis})"
        )
    LAUNCHES[KERNEL] += 1
    return out


def shear(img, shifts, order=1, cval=0.0, nearest_from=None, axis=2):
    """The Pallas row-shear: the kernel on a CUDA tensor, ``shear_plain``
    on a CPU tensor."""
    if img.is_cuda:
        return shear_cuda(img, shifts, order, cval, nearest_from, axis)
    if img.device.type == "cpu":
        return shear_plain(img, shifts, order, cval, nearest_from, axis)
    raise ValueError(f"no {KERNEL} for device {img.device}")


def shear_gather(img, shifts, order=1, cval=0.0, nearest_from=None, axis=2):
    """``_shear_x_gather``'s function (rotate.py:60-96) along ``axis``:
    source position ``x + shift`` unquantized, blend in img's dtype;
    order 0 is nearest on every channel."""
    _check(img, shifts, axis)
    x = _lines(img, axis)
    n = x.shape[2]
    src = torch.arange(n, dtype=torch.float32, device=img.device)[None, None, :]
    src = src + shifts.float()[:, :, None]
    if order == 0:
        out = _gather_line(x, torch.round(src).int(), cval)
    else:
        idx0 = torch.floor(src)
        frac = (src - idx0)[..., None]
        frac = torch.where(
            _nearest_mask(x.shape[3], nearest_from, img.device), torch.round(frac), frac
        ).to(img.dtype)
        idx0 = idx0.int()
        g0 = _gather_line(x, idx0, cval)
        g1 = _gather_line(x, idx0 + 1, cval)
        out = g0 * (1 - frac) + g1 * frac
    return _lines(out, axis).contiguous()


def _shear_fn(impl: str):
    if impl == "pallas":
        return shear
    if impl in ("gather", "roll"):
        return shear_gather
    raise ValueError(f"impl must be one of {IMPLS}, not {impl!r}")


def _three_shears(img, a, b, order, cval, impl, nearest_from):
    """ShearX(a) . ShearY(b) . ShearX(a) (rotate.py:441-443)."""
    fn = _shear_fn(impl)
    h, w = img.shape[1], img.shape[2]
    out = fn(img, _row_shifts(a, h), order, cval, nearest_from, axis=2)
    out = fn(out, _row_shifts(b, w), order, cval, nearest_from, axis=1)
    return fn(out, _row_shifts(a, h), order, cval, nearest_from, axis=2)


def _reduce_angles(angles_deg: torch.Tensor, device):
    """(quarter turns k, residual degrees in (-45, 45])."""
    angles = torch.as_tensor(angles_deg, dtype=torch.float32, device=device) % 360.0
    turns = torch.floor((angles + 45.0) / 90.0)
    return turns.long() % 4, angles - 90.0 * turns


def _where_b(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(cond[:, None, None, None], a, b)


def dihedral_batch(img, transpose, flip_h, flip_w):
    """Per-sample dihedral element: transpose (H <-> W), then flip rows
    (axis 1) and columns (axis 2); img [B,H,W,C] with H == W."""
    out = _where_b(transpose, img.transpose(1, 2), img)
    out = _where_b(flip_h, out.flip(1), out)
    return _where_b(flip_w, out.flip(2), out)


def rotate_flip_batch(
    img: torch.Tensor,
    angles_deg: torch.Tensor,
    flip_h: torch.Tensor,
    flip_v: torch.Tensor,
    order: int = 1,
    cval: float = 0.0,
    impl: str = "roll",
    nearest_from: int | None = None,
) -> torch.Tensor:
    """hflip (axis 2) -> vflip (axis 1) -> rotate(angle), fused.

    img [B,H,W,C] square; angles [B] CCW degrees; flips [B] bool. The
    residual rotation runs first on the raw image with the sign of the
    angle flipped for an odd number of flips, then one composed dihedral
    element does the quarter turn and both flips (rotate.py:401-452).
    """
    if img.shape[1] != img.shape[2]:
        raise ValueError(f"rotate_flip_batch requires square tiles; got {tuple(img.shape)}")
    k, residual = _reduce_angles(angles_deg, img.device)
    h = torch.as_tensor(flip_h, dtype=torch.bool, device=img.device)
    v = torch.as_tensor(flip_v, dtype=torch.bool, device=img.device)
    sigma = torch.where(h ^ v, -1.0, 1.0)
    theta = sigma * residual * (math.pi / 180.0)
    a = -torch.tan(theta / 2.0)
    b = torch.sin(theta)
    out = _three_shears(img, a, b, order, cval, impl, nearest_from)
    # D = Q_k . F as (transpose, flipH, flipW), the D4 table of
    # rotate.py:445-451: k=0 (0, v, h), k=1 (1, ~h, v), k=2 (0, ~v, ~h),
    # k=3 (1, h, ~v).
    t = (k % 2) == 1
    fh = torch.stack([v, ~h, ~v, h]).gather(0, k[None]).squeeze(0)
    fw = torch.stack([h, v, ~h, ~v]).gather(0, k[None]).squeeze(0)
    return dihedral_batch(out, t, fh, fw)


def _quarter_turns(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-sample rotation by k * 90 degrees CCW."""
    r1 = img.transpose(1, 2).flip(1)
    r2 = img.flip(1).flip(2)
    r3 = img.transpose(1, 2).flip(2)
    out = _where_b(k == 1, r1, img)
    out = _where_b(k == 2, r2, out)
    return _where_b(k == 3, r3, out)


def rotate_batch(img, angles_deg, order=1, cval=0.0, impl="gather", nearest_from=None):
    """Rotate each sample about its center by its own angle (quarter turn,
    then the 3-shear residual; rotate.py:455-488). img [B,H,W,C] square."""
    if img.shape[1] != img.shape[2]:
        raise ValueError(
            "rotate_batch requires square tiles (quarter-turn reduction); "
            f"got {tuple(img.shape)}"
        )
    k, residual = _reduce_angles(angles_deg, img.device)
    theta = residual * (math.pi / 180.0)
    out = _quarter_turns(img, k)
    return _three_shears(out, -torch.tan(theta / 2.0), torch.sin(theta), order, cval,
                         impl, nearest_from)
