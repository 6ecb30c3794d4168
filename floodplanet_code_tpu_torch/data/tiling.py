"""Pure tile/crop math for sliding-window training and inference.

Behavior contract comes from the reference's crop machinery
(st_water_seg/datasets/utils.py:22-212): ``get_crop_slices`` enumerates crop
windows over a scene in three modes and ``CropParams`` carries enough
geometry to pad undersized edge tiles back to the model's fixed input size.

TPU note: mode="exact" produces *ragged* remainder tiles at the right/bottom
edges. Ragged shapes are poison for XLA (every distinct shape is a fresh
compilation), so every consumer in this framework pads each tile to the
fixed ``(max_crop_height, max_crop_width)`` before batching; the valid
region is tracked via ``CropParams`` and masked with the stitcher's weight
canvas at reassembly. One compiled shape serves the whole pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple


@dataclass(frozen=True)
class ImageSlice:
    """Queryable crop-slice description (reference: datasets/utils.py:55-83)."""

    height: int
    width: int
    stride: int
    scale: float = 1.0


def generate_image_slice_object(
    height: int,
    width: int | None = None,
    stride: int | None = None,
    scale: float = 1.0,
) -> ImageSlice:
    """Build an ImageSlice; width/stride default to height (utils.py:73-77)."""
    if width is None:
        width = height
    if stride is None:
        stride = height
    return ImageSlice(height=height, width=width, stride=stride, scale=scale)


@dataclass(frozen=True)
class CropParams:
    """Geometry of one crop of a scene (reference: datasets/utils.py:22-52).

    Attributes:
        h0, w0: top-left pixel of the crop within the scene.
        height, width: actual crop extent (may be smaller at scene edges).
        og_height, og_width: full scene dimensions.
        max_crop_height, max_crop_width: the fixed model input size that
            undersized edge crops are zero-padded up to.
    """

    h0: int
    w0: int
    height: int
    width: int
    og_height: int
    og_width: int
    max_crop_height: int
    max_crop_width: int
    hE: int = field(init=False)
    wE: int = field(init=False)

    def __post_init__(self) -> None:
        object.__setattr__(self, "hE", self.h0 + self.height)
        object.__setattr__(self, "wE", self.w0 + self.width)

    def __str__(self) -> str:
        return (
            f"CropParams[{self.h0}:{self.hE}, {self.w0}:{self.wE}] "
            f"of {self.og_height}x{self.og_width}"
        )


def get_crop_slices(
    height: int,
    width: int,
    crop_height: int,
    crop_width: int,
    step: int | Tuple[int, int] | None = None,
    mode: str = "exact",
) -> List[List[int]]:
    """Enumerate crop windows ``[h0, w0, h, w]`` over a ``height x width`` scene.

    Modes (reference: datasets/utils.py:86-212):
      - ``exact``: interior tiles of full crop size plus remainder tiles of
        irregular size along the right/bottom edges — full coverage, no
        overrun past the scene bounds.
      - ``over``: fixed-size tiles covering the scene; the final row/column
        may overrun the scene bounds.
      - ``under``: fixed-size tiles only; edge remainders are dropped.

    Note: the reference emits height-remainder tiles as
    ``[h0, w0, rem_h, crop_height]`` (utils.py:203), i.e. with *crop_height*
    as the width — harmless there because all its crops are square. This
    implementation uses ``crop_width``, which is the evident intent.
    """
    if step is not None:
        if isinstance(step, tuple):
            h_step, w_step = step
        elif isinstance(step, int):
            h_step, w_step = step, step
        else:
            raise TypeError(
                f"step must be an int or (h, w) tuple, got {type(step)}"
            )
        if h_step <= 0 or w_step <= 0:
            raise ValueError(
                f"stride must be positive, got ({h_step}, {w_step})"
            )
        if h_step > height or w_step > width:
            raise ValueError(
                f"stride ({h_step}, {w_step}) exceeds the scene extent "
                f"({height}, {width})"
            )
    else:
        h_step, w_step = crop_height, crop_width

    # Number of fixed-size crops that fit entirely inside the scene.
    def n_fitting(extent: int, crop: int, stride: int) -> int:
        n = 0
        while (n * stride) + crop <= extent:
            n += 1
        return n

    num_h = n_fitting(height, crop_height, h_step)
    num_w = n_fitting(width, crop_width, w_step)

    crop_slices: List[List[int]] = []
    if mode == "over":
        for i in range(num_h + 1):
            for j in range(num_w + 1):
                crop_slices.append([i * h_step, j * w_step, crop_height, crop_width])
    elif mode == "under":
        for i in range(num_h):
            for j in range(num_w):
                crop_slices.append([i * h_step, j * w_step, crop_height, crop_width])
    elif mode == "exact":
        for i in range(num_h):
            for j in range(num_w):
                crop_slices.append([i * h_step, j * w_step, crop_height, crop_width])

        rem_h = height - (num_h * h_step)
        rem_w = width - (num_w * w_step)

        # Remainder crops along the right edge (full height, ragged width).
        if rem_w != 0:
            for i in range(num_h):
                crop_slices.append([i * h_step, num_w * w_step, crop_height, rem_w])
        # Remainder crops along the bottom edge (ragged height, full width).
        if rem_h != 0:
            for j in range(num_w):
                crop_slices.append([num_h * h_step, j * w_step, rem_h, crop_width])
        # Bottom-right corner remainder.
        if rem_h != 0 and rem_w != 0:
            crop_slices.append([num_h * h_step, num_w * w_step, rem_h, rem_w])
    else:
        raise NotImplementedError(
            f'no crop-slice mode "{mode}" (choose exact | over | under)'
        )

    return crop_slices


def crop_params_for_scene(
    scene_height: int,
    scene_width: int,
    slice_params: ImageSlice,
    mode: str = "exact",
) -> List[CropParams]:
    """All CropParams covering one scene (reference: floodplanet.py:115-133)."""
    slices = get_crop_slices(
        scene_height,
        scene_width,
        slice_params.height,
        slice_params.width,
        slice_params.stride,
        mode=mode,
    )
    return [
        CropParams(
            h0,
            w0,
            h,
            w,
            scene_height,
            scene_width,
            slice_params.height,
            slice_params.width,
        )
        for h0, w0, h, w in slices
    ]
