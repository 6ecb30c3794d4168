"""Overlap-averaged scene stitching on the device (port of
``floodplanet_code_tpu/inference/stitcher.py``).

The reference reassembles full scenes from overlapping tile predictions with
``ImageStitcher_v2`` (utils_image.py:364-571): per-scene accumulation canvas
plus hit-count weight canvas, divided at the end (+1e-5) and NaN-scrubbed.
Here both canvases are tensors on the inference device; batches of
fixed-shape tiles are added into them in place (the canvases are the only
copy, so no second scene-sized buffer is allocated), and each scene is
finalized and copied to the host once. Edge tiles carry a validity mask
so zero-padded regions add zero weight.
"""

from __future__ import annotations

import numpy as np
import torch


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
