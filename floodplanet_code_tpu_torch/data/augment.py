"""On-device batched augmentation (flips + rotation): the port of
``floodplanet_code_tpu/data/augment.py``.

The reference augments per sample on the host with torchvision
(coin-flip hflip/vflip and a uniform rotation, image bilinear, label
nearest, fill 0). Here the whole batch is augmented on the device in two
steps:

- ``draw_augmentation``: the per-sample coins and angles from an explicit
  ``torch.Generator``, in the JAX order and arithmetic (augment.py:118-140);
  the angle comes out in radians, as there.
- ``apply_augmentation``: the transforms for given draws, so the same draws
  can be fed to this package and to the JAX one.

Rotation runs one of two ways, as in the JAX package (augment.py:143-235):
square crops by default through the three-shear rotation of
``ops/rotate.py``, which also applies the flips; crops whose height differs
from their width, or ``rotate_impl="map_coordinates"``, by the flips and
then a direct bilinear resampling, ``jax.scipy.ndimage.map_coordinates`` in
constant mode (``_rotate_map_coordinates``).

``augment_batch`` is the two together. Images are [B, H, W, C] and targets
[B, H, W], the loader's layout. ``fill_ignore=True`` fills rotated-out label
pixels with ``ignore_index`` instead of 0 (the reference's quirk is the
default).
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass

import torch

from floodplanet_code_tpu_torch.ops.rotate import rotate_flip_batch

# rotate_impl -> ops/rotate.py backend. "auto" is the JAX package's
# default, the pure-XLA roll shear there, the plain gather here.
_SHEAR_IMPLS = {"auto": "roll", "shear_roll": "roll", "shear": "gather",
                "shear_pallas": "pallas"}


@dataclass(frozen=True)
class TransformParams:
    """Static augmentation config (conf/config.yaml ``transforms``)."""

    hflip_active: bool = True
    hflip_likelihood: float = 0.5
    vflip_active: bool = True
    vflip_likelihood: float = 0.5
    rotate_active: bool = True
    rotate_likelihood: float = 0.5
    min_rot_angle: float = 0.0
    max_rot_angle: float = 360.0
    fill_ignore: bool = False
    # dtype of the fused rotate+flip pass ("float32" or "bfloat16"; the
    # train step consumes the compute dtype anyway).
    dtype: str = "float32"
    # "auto" / "shear_roll" / "shear": plain PyTorch gather shear;
    # "shear_pallas": the CUDA row-shear kernel on a card;
    # "map_coordinates": direct bilinear resampling (non-square crops take
    # it whatever this says).
    rotate_impl: str = "auto"

    @classmethod
    def from_config(cls, transforms_cfg) -> "TransformParams":
        if transforms_cfg is None:
            return cls(False, 0, False, 0, False, 0)
        t = transforms_cfg
        return cls(
            hflip_active=bool(t.hflip.active),
            hflip_likelihood=float(t.hflip.likelihood),
            vflip_active=bool(t.vflip.active),
            vflip_likelihood=float(t.vflip.likelihood),
            rotate_active=bool(t.rotate.active),
            rotate_likelihood=float(t.rotate.likelihood),
            min_rot_angle=float(t.rotate.min_rot_angle),
            max_rot_angle=float(t.rotate.max_rot_angle),
            fill_ignore=bool(t.select("rotate.fill_ignore", False))
            if hasattr(t, "select")
            else bool(getattr(t.rotate, "fill_ignore", False)),
        )

    @property
    def any_active(self) -> bool:
        return self.hflip_active or self.vflip_active or self.rotate_active


@dataclass
class AugmentDraws:
    """Per-sample draws: flips and rotation coins [B] bool, angles [B] f32
    radians (0 where the sample does not rotate)."""

    do_h: torch.Tensor
    do_v: torch.Tensor
    do_r: torch.Tensor
    angles: torch.Tensor


def draw_augmentation(
    generator: torch.Generator, batch_size: int, params: TransformParams, device
) -> AugmentDraws:
    """Draw on ``generator``'s device, return on ``device``. Four uniforms
    per sample, always drawn in the order hflip, vflip, rotate, angle."""
    u = torch.rand(4, batch_size, generator=generator, device=generator.device)
    u = u.to(device)
    off = torch.zeros(batch_size, dtype=torch.bool, device=device)
    do_h = u[0] < params.hflip_likelihood if params.hflip_active else off
    do_v = u[1] < params.vflip_likelihood if params.vflip_active else off
    do_r = u[2] < params.rotate_likelihood if params.rotate_active else off
    lo, hi = params.min_rot_angle, params.max_rot_angle
    angles = (u[3] * (hi - lo) + lo) * (math.pi / 180.0)
    angles = torch.where(do_r, angles, torch.zeros_like(angles))
    return AugmentDraws(do_h, do_v, do_r, angles)


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """``lax.round``: halves away from zero (``torch.round`` takes them to
    even). ``x - trunc(x)`` is exact, so the test is too."""
    t = torch.trunc(x)
    return t + torch.where((x - t).abs() >= 0.5, torch.sign(x), torch.zeros_like(x))


def _taps(coord: torch.Tensor, order: int) -> list[tuple[torch.Tensor, torch.Tensor | None]]:
    """(index, weight) pairs along one axis (map_coordinates' nodes); order
    0's single weight is 1 (None)."""
    if order == 0:
        return [(_round_half_away(coord).long(), None)]
    lower = torch.floor(coord)
    upper_weight = coord - lower
    index = lower.long()
    return [(index, 1 - upper_weight), (index + 1, upper_weight)]


def _map_coordinates(img: torch.Tensor, src_y: torch.Tensor, src_x: torch.Tensor,
                     order: int, cval: float) -> torch.Tensor:
    """``jax.scipy.ndimage.map_coordinates(mode="constant")`` of every
    channel of img [B,H,W,C] at the [B,H,W] source coordinates, all C in one
    gather per tap. A tap outside the image contributes ``cval`` times its
    weight (the weights are not renormalized); the taps' products sum in
    f32, in map_coordinates' order, and the sum is cast to img's dtype."""
    b, h, w, _ = img.shape
    rows = torch.arange(b, device=img.device).view(b, 1, 1)
    fill = torch.tensor(cval, dtype=img.dtype, device=img.device)
    out = None
    for iy, wy in _taps(src_y, order):
        for ix, wx in _taps(src_x, order):
            valid = ((iy >= 0) & (iy < h) & (ix >= 0) & (ix < w))[..., None]
            value = torch.where(valid, img[rows, iy.clamp(0, h - 1), ix.clamp(0, w - 1)], fill)
            term = value.float() if order == 0 else (wy * wx)[..., None] * value
            out = term if out is None else out + term
    return out.to(img.dtype)


def _rotate_map_coordinates(image, target, angles, label_fill):
    """Rotate each sample about its centre by ``angles`` [B] radians (JAX
    augment.py:78-100): the image bilinear with 0 fill, in its own dtype;
    the label nearest-neighbour with ``label_fill``, as f32, then cast back
    to its dtype. The source coordinates are computed in f32, from cos and
    sin of the f32 angle taken in f64 and rounded once: f32 cos and sin
    round differently from one library to the next, and a coordinate tens
    of pixels from the centre moves with them."""
    b, h, w, _ = image.shape
    dev = image.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1)
    xx = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w)
    angles = angles.to(device=dev, dtype=torch.float32).view(b, 1, 1).double()
    cos, sin = torch.cos(angles).float(), torch.sin(angles).float()
    src_y = cos * (yy - cy) + sin * (xx - cx) + cy
    src_x = -sin * (yy - cy) + cos * (xx - cx) + cx
    image = _map_coordinates(image, src_y, src_x, 1, 0.0)
    label = _map_coordinates(target[..., None].float(), src_y, src_x, 0, label_fill)
    return image, label[..., 0].to(target.dtype)


def apply_augmentation(
    image: torch.Tensor,
    target: torch.Tensor,
    draws: AugmentDraws,
    params: TransformParams,
    ignore_index: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The transforms of ``draws`` on image [B,H,W,C] and target [B,H,W].

    With rotation on a square crop (the shear backends), one pass rotates
    ``[image | label | validity]`` in ``params.dtype`` (label and validity
    nearest-neighbour, exact in bf16), so the image comes back in that
    dtype. Flips alone and the map_coordinates rotation keep the image's
    dtype. Returns (image, target in target's dtype).
    """
    if not params.any_active:
        return image, target
    impl = params.rotate_impl
    if impl != "map_coordinates" and impl not in _SHEAR_IMPLS:
        raise ValueError(f"rotate_impl must be one of {sorted(_SHEAR_IMPLS)} or "
                         f"'map_coordinates', not {impl!r}")
    if params.rotate_active and image.shape[1] != image.shape[2]:
        # The shear reduces angles by quarter turns, which needs a square.
        warnings.warn(
            f"rotation of non-square crops {image.shape[1]}x{image.shape[2]} uses the "
            "map_coordinates path (a gather per tap) instead of the shear; use square "
            "crops for the shear backend",
            stacklevel=2,
        )
        impl = "map_coordinates"
    label_fill = float(ignore_index) if params.fill_ignore else 0.0
    if params.rotate_active and impl in _SHEAR_IMPLS:
        dt = torch.bfloat16 if params.dtype == "bfloat16" else torch.float32
        n_img = image.shape[-1]
        combined = torch.cat(
            [image.to(dt), target[..., None].to(dt),
             torch.ones(target.shape + (1,), dtype=dt, device=image.device)],
            dim=-1,
        )
        rotated = rotate_flip_batch(
            combined,
            draws.angles * (180.0 / math.pi),
            draws.do_h,
            draws.do_v,
            order=1,
            cval=0.0,
            impl=_SHEAR_IMPLS[impl],
            nearest_from=n_img,
        )
        inside = rotated[..., n_img + 1] > 0.5
        label = torch.where(
            inside, rotated[..., n_img], torch.tensor(label_fill, dtype=dt, device=image.device)
        )
        return rotated[..., :n_img], torch.round(label.float()).to(target.dtype)
    # Flips (augment.py:212-219): hflip reverses W, vflip H.
    fh = draws.do_h[:, None, None]
    fv = draws.do_v[:, None, None]
    image = torch.where(fh[..., None], image.flip(2), image)
    target = torch.where(fh, target.flip(2), target)
    image = torch.where(fv[..., None], image.flip(1), image)
    target = torch.where(fv, target.flip(1), target)
    if params.rotate_active:
        image, target = _rotate_map_coordinates(image, target, draws.angles, label_fill)
    return image, target


def augment_batch(
    generator: torch.Generator,
    image: torch.Tensor,
    target: torch.Tensor,
    params: TransformParams,
    ignore_index: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw and apply: image [B,H,W,C] float, target [B,H,W] int."""
    if not params.any_active:
        return image, target
    draws = draw_augmentation(generator, image.shape[0], params, image.device)
    return apply_augmentation(image, target, draws, params, ignore_index)
