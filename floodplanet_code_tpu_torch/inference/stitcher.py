"""Overlap-averaged scene stitching (port of
``floodplanet_code_tpu/inference/stitcher.py``).

The reference reassembles full scenes from overlapping tile predictions with
``ImageStitcher_v2`` (utils_image.py:364-571): per-scene accumulation canvas
plus hit-count weight canvas, divided at the end (+1e-5) and NaN-scrubbed.

- ``ImageStitcher``: that class on the host (numpy), tile by tile, saving
  each combined canvas as a GeoTIFF (``geo/tiff.py``) or through PIL.
- ``DeviceStitcher``: both canvases are tensors on the inference device;
  batches of fixed-shape tiles are added into them in place (the canvases
  are the only copy, so no second scene-sized buffer is allocated), and
  each scene is finalized and copied to the host once. Edge tiles carry a
  validity mask so zero-padded regions add zero weight.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from floodplanet_code_tpu_torch.geo import tiff


class ImageStitcher:
    """Host-side overlap-average stitcher (reference utils_image.py:364;
    the JAX package's ``ImageStitcher``)."""

    def __init__(
        self,
        save_dir: str,
        image_type_name: str = "",
        save_backend: str = "tifffile",
        save_ext: str = ".tif",
    ):
        self.save_dir = save_dir
        self.save_ext = save_ext
        self.save_backend = save_backend
        self.image_type_name = image_type_name
        self._images_combined = False
        os.makedirs(save_dir, exist_ok=True)
        self.image_canvas: dict[str, np.ndarray] = {}
        self.weight_canvas: dict[str, np.ndarray] = {}
        self.geo_sources: dict[str, str] = {}

    def add_image(
        self,
        image: np.ndarray,
        image_name: str,
        crop_info,
        og_height: int,
        og_width: int,
        geo_from: str | None = None,
    ) -> None:
        """Accumulate one tile ([h,w] or [h,w,c]) into the scene canvas at
        ``crop_info``'s (h0, w0, hE, wE); ``geo_from``: a GeoTIFF whose geo
        tags the saved scene carries."""
        h0, w0, h_end, w_end = crop_info.h0, crop_info.w0, crop_info.hE, crop_info.wE
        if image.ndim not in (2, 3):
            raise NotImplementedError(f"tiles of {image.ndim} dimensions")
        if image_name not in self.image_canvas:
            shape = (og_height, og_width) + image.shape[2:]
            self.image_canvas[image_name] = np.zeros(shape, dtype=np.float32)
            self.weight_canvas[image_name] = np.zeros((og_height, og_width), dtype=np.float32)
        if geo_from is not None:
            self.geo_sources.setdefault(image_name, geo_from)
        self.image_canvas[image_name][h0:h_end, w0:w_end] += image[:h_end - h0, :w_end - w0]
        self.weight_canvas[image_name][h0:h_end, w0:w_end] += 1.0

    def add_images(self, images, image_names, crop_info, og_heights, og_widths):
        for img, name, crop, oh, ow in zip(images, image_names, crop_info, og_heights,
                                           og_widths):
            self.add_image(img, name, crop, oh, ow)

    def _combine_images(self) -> None:
        if self._images_combined:
            return
        for name, canvas in self.image_canvas.items():
            weights = self.weight_canvas[name] + 1e-5
            if canvas.ndim == 3:
                weights = weights[:, :, None]
            self.image_canvas[name] = np.nan_to_num(canvas / weights)
        self._images_combined = True

    def get_combined_images(self) -> dict:
        self._combine_images()
        return self.image_canvas

    def save_images(self, save_class: bool = False):
        """Save each combined canvas to ``<save_dir>/<name>/<image_type_name>
        <save_ext>``; returns (paths, names, sizes). ``save_class``
        thresholds at 0.5 (utils_image.py:522-525). ``tifffile``: an f32
        (Geo)TIFF through ``geo/tiff.py``, [C, H, W] for a multi-channel
        canvas, with the geo tags of the scene's ``geo_from``; ``PIL``: uint8,
        times 255 when the canvas is at most 1."""
        save_paths, image_names, image_sizes = [], [], []
        self._combine_images()
        for name, canvas in self.image_canvas.items():
            img_dir = os.path.join(self.save_dir, name)
            os.makedirs(img_dir, exist_ok=True)
            path = os.path.join(img_dir, self.image_type_name + self.save_ext)
            image = canvas.copy()
            if save_class:
                image = (image >= 0.5).astype(np.float32)
            if self.save_backend == "tifffile":
                tiff.imwrite(path, image if image.ndim == 2 else np.transpose(image, (2, 0, 1)),
                             geo_from=self.geo_sources.get(name))
            elif self.save_backend == "PIL":
                from PIL import Image

                out = image * 255 if image.max() <= 1.0 else image
                Image.fromarray(out.astype(np.uint8)).save(path)
            else:
                raise NotImplementedError(f'No save backend "{self.save_backend}"')
            save_paths.append(path)
            image_names.append(name)
            image_sizes.append(canvas.shape)
        return save_paths, image_names, image_sizes


def stitch_batch(
    canvas: torch.Tensor,  # [H, W, C] float32
    weights: torch.Tensor,  # [H, W] float32
    tiles: torch.Tensor,  # [B, h, w, C] float32 (fixed tile shape)
    offsets: np.ndarray,  # [B, 2] int (y0, x0), host
    tile_valid: torch.Tensor,  # [B, h, w] float32 validity, on canvas's device
) -> None:
    """Add a batch of tiles into one scene canvas, in place.

    Callers size the canvas so every tile fits entirely (``H >= max(y0) +
    tile_h``): DeviceStitcher allocates one tile of slack and crops at
    finalize, as the JAX package does. Offsets stay on the host, so no
    device round trip is needed to place a tile.
    """
    h, w = tiles.shape[1], tiles.shape[2]
    contrib = tiles * tile_valid[..., None]
    for i, (y0, x0) in enumerate(np.asarray(offsets).tolist()):
        canvas[y0 : y0 + h, x0 : x0 + w] += contrib[i]
        weights[y0 : y0 + h, x0 : x0 + w] += tile_valid[i]


def finalize_canvas(canvas: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Divide by hit counts (+1e-5) and NaN-scrub (utils_image.py:465-494)."""
    return torch.nan_to_num(canvas / (weights[:, :, None] + 1e-5))


def make_tile_valid_mask(
    crop_heights: np.ndarray,
    crop_widths: np.ndarray,
    tile_h: int,
    tile_w: int,
    batch_valid: np.ndarray | None = None,
) -> np.ndarray:
    """[B, tile_h, tile_w] 0/1 mask of the in-scene region of each tile."""
    rows = np.arange(tile_h)[None, :, None] < np.asarray(crop_heights)[:, None, None]
    cols = np.arange(tile_w)[None, None, :] < np.asarray(crop_widths)[:, None, None]
    mask = (rows & cols).astype(np.float32)
    if batch_valid is not None:
        mask = mask * np.asarray(batch_valid, dtype=np.float32)[:, None, None]
    return mask


class DeviceStitcher:
    """Accumulates batches of tile predictions into per-scene canvases on
    the device; ``pop_combined`` finalizes one scene and returns numpy.

    A scene whose canvas (+slack +weights) would exceed ``max_canvas_bytes``
    is accumulated on the host instead (numpy, per batch): 10k+ px rasters
    appear when deploying over a time series, and their f32 canvases do not
    belong in device memory.
    """

    def __init__(self, n_channels: int, device="cuda", max_canvas_bytes: int = 1 << 30):
        self.n_channels = n_channels
        self.device = torch.device(device)
        self.max_canvas_bytes = max_canvas_bytes
        self._canvas: dict[str, torch.Tensor] = {}
        self._weights: dict[str, torch.Tensor] = {}
        self._host: dict[str, HostCanvas] = {}
        self._og_shape: dict[str, tuple] = {}
        self.geo_sources: dict[str, str] = {}

    def _canvas_bytes(self, pad_h: int, pad_w: int) -> int:
        return pad_h * pad_w * (self.n_channels + 1) * 4

    def ensure_scene(
        self, name: str, og_height: int, og_width: int, tile_h: int, tile_w: int
    ):
        if name in self._canvas or name in self._host:
            return
        # One tile of slack so edge tiles (y0 + tile_h > H) fit; cropped at
        # finalize.
        pad_h, pad_w = og_height + tile_h, og_width + tile_w
        if self._canvas_bytes(pad_h, pad_w) > self.max_canvas_bytes:
            self._host[name] = HostCanvas(og_height, og_width, self.n_channels)
        else:
            self._canvas[name] = torch.zeros(
                (pad_h, pad_w, self.n_channels), dtype=torch.float32, device=self.device
            )
            self._weights[name] = torch.zeros(
                (pad_h, pad_w), dtype=torch.float32, device=self.device
            )
        self._og_shape[name] = (og_height, og_width)

    def add_batch(
        self,
        name: str,
        og_height: int,
        og_width: int,
        tiles: torch.Tensor,
        offsets: np.ndarray,
        tile_valid: np.ndarray,
        geo_from: str | None = None,
    ):
        """``tiles`` [B, h, w, C] float32; ``offsets`` [B, 2] and
        ``tile_valid`` [B, h, w] as host numpy."""
        self.ensure_scene(
            name, og_height, og_width, int(tiles.shape[1]), int(tiles.shape[2])
        )
        if geo_from is not None:
            self.geo_sources.setdefault(name, geo_from)
        if name in self._host:
            self._host[name].add_batch(
                tiles.float().cpu().numpy(), np.asarray(offsets), np.asarray(tile_valid)
            )
            return
        valid = torch.from_numpy(np.asarray(tile_valid, np.float32)).to(
            self.device, non_blocking=True
        )
        stitch_batch(
            self._canvas[name], self._weights[name], tiles.float(), offsets, valid
        )

    def scene_names(self):
        return list(self._canvas.keys()) + list(self._host.keys())

    def combined(self, name: str) -> np.ndarray:
        h, w = self._og_shape[name]
        if name in self._host:
            return self._host[name].combined()
        full = finalize_canvas(self._canvas[name][:h, :w], self._weights[name][:h, :w])
        return full.cpu().numpy()

    def pop_combined(self, name: str) -> np.ndarray:
        out = self.combined(name)
        self._canvas.pop(name, None)
        self._weights.pop(name, None)
        self._host.pop(name, None)
        del self._og_shape[name]
        return out


class HostCanvas:
    """Host (numpy) accumulation canvas for scenes too large for the device
    (the JAX package's ImageStitcherLike).

    Same accumulate/divide semantics as stitch_batch/finalize_canvas;
    edge tiles are cropped to the scene bounds instead of using slack.
    """

    def __init__(self, og_height: int, og_width: int, n_channels: int):
        self.h, self.w = og_height, og_width
        self.canvas = np.zeros((og_height, og_width, n_channels), np.float32)
        self.weights = np.zeros((og_height, og_width), np.float32)

    def add_batch(
        self, tiles: np.ndarray, offsets: np.ndarray, tile_valid: np.ndarray
    ) -> None:
        for i in range(tiles.shape[0]):
            y0, x0 = int(offsets[i, 0]), int(offsets[i, 1])
            th = min(tiles.shape[1], self.h - y0)
            tw = min(tiles.shape[2], self.w - x0)
            if th <= 0 or tw <= 0:
                continue
            v = tile_valid[i, :th, :tw]
            self.canvas[y0 : y0 + th, x0 : x0 + tw] += (
                tiles[i, :th, :tw] * v[:, :, None]
            )
            self.weights[y0 : y0 + th, x0 : x0 + tw] += v

    def combined(self) -> np.ndarray:
        return np.nan_to_num(self.canvas / (self.weights[:, :, None] + 1e-5))
