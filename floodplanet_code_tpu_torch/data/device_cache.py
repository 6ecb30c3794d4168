"""Device-resident scene cache: the port of
``floodplanet_code_tpu/data/device_cache.py`` (one device).

Every scene of a dataset is loaded once into two stacks on the card:
images [N, Hp, Wp, C] f32 (range-normalized) and labels [N, Hp, Wp] int32
(binarized, ``ignore_index`` outside the scene). A batch is then assembled
on the card from [B, 5] int32 index rows (scene, h0, w0, h_len, w_len): one
gather of the fixed-size crops, the ragged-edge mask, ``norm_mode`` null /
local / global and the zero / ``ignore_index`` padding, as
``FloodPlanetDataset.load_example`` computes them on the host. Only the
rows cross from the host, through pinned memory: 160 bytes per batch of 8
against ~8 MB of pixels for 512^2 crops.

``cache_batches`` walks a dataset order in such batches, the short final
one dropped or padded. ``build_device_cache`` returns None, after one line
saying why, when the padded stacks exceed the byte budget or a scene has
no label raster; the caller then uses the host loader. Any other error
raises. The JAX package's pod-sharded stacks and builder wait for more
than one device (ROADMAP.md Queue 1 item 4).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from floodplanet_code_tpu_torch.data.tiling import CropParams
from floodplanet_code_tpu_torch.device import resolve_device


@dataclass
class DeviceSceneCache:
    """Scene stacks on the card + host-side index metadata."""

    images: torch.Tensor  # [N, Hp, Wp, C] f32 (range-normalized)
    labels: torch.Tensor  # [N, Hp, Wp] int32 (binarized, ignore sentinel)
    scene_index: dict  # image_path -> stack slot
    crop_hw: tuple  # (max_crop_height, max_crop_width)
    ignore_index: int
    norm_mode: str | None
    global_mean: torch.Tensor | None  # [C] f32 when norm_mode == "global"
    global_std: torch.Tensor | None
    nbytes: int

    def index_rows(self, dataset, indices) -> np.ndarray:
        """[len(indices), 5] int32: (scene, h0, w0, h_len, w_len)."""
        rows = np.empty((len(indices), 5), np.int32)
        for pos, index in enumerate(indices):
            example = dataset.dataset[index]
            cp = example.crop_params
            rows[pos] = (
                self.scene_index[example.image_path],
                cp.h0,
                cp.w0,
                cp.height,
                cp.width,
            )
        return rows


def build_device_cache(
    dataset, max_bytes: int = 6 << 30, device="cuda", n_workers: int = 4
) -> DeviceSceneCache | None:
    """Load every scene of ``dataset`` into stacks on ``device``, reading
    up to ``n_workers`` scenes at once, or return None (see the module
    docstring). Raises without a card unless ``device="cpu"``."""
    device = resolve_device(device)
    paths = sorted({e.image_path for e in dataset.dataset})
    for path in paths:
        if not os.path.exists(dataset._label_path(path)):
            print(f"[device cache] {path} has no label raster: host loader")
            return None
    ch, cw = dataset.slice_params.height, dataset.slice_params.width
    shapes = []
    for path in paths:
        info = dataset._tiff_info(dataset._label_path(path))
        shapes.append((info.height, info.width))
    # Pad so a fixed-size crop at any valid origin stays inside the stack.
    hp = max(h for h, _ in shapes) + ch
    wp = max(w for _, w in shapes) + cw
    n_channels = dataset.n_channels.get(
        "ms_image", next(iter(dataset.n_channels.values()))
    )
    nbytes = len(paths) * hp * wp * (n_channels * 4 + 4)
    if nbytes > max_bytes:
        print(
            f"[device cache] the padded scene stacks ({nbytes / 1e9:.2f} GB) "
            f"exceed tpu.device_data_bytes ({max_bytes / 1e9:.2f} GB): host loader"
        )
        return None

    def load(slot: int):
        h, w = shapes[slot]
        cp = CropParams(0, 0, h, w, h, w, h, w)
        chw = dataset._load_crop_norm_image(paths[slot], cp)
        lbl = dataset._load_label_image(dataset._label_path(paths[slot]), cp)
        return np.asarray(chw, np.float32), lbl.astype(np.int32)

    images = torch.zeros((len(paths), hp, wp, n_channels), dtype=torch.float32,
                         device=device)
    labels = torch.full((len(paths), hp, wp), int(dataset.ignore_index),
                        dtype=torch.int32, device=device)
    # Scenes decode on worker threads (the native reader and numpy release
    # the GIL); each is copied as it comes and turned HWC on the device.
    with ThreadPoolExecutor(max_workers=max(1, n_workers)) as pool:
        for slot, (chw, lbl) in enumerate(pool.map(load, range(len(paths)))):
            h, w = shapes[slot]
            images[slot, :h, :w] = torch.from_numpy(chw).to(device).permute(1, 2, 0)
            labels[slot, :h, :w] = torch.from_numpy(lbl).to(device)
    scene_index = {path: slot for slot, path in enumerate(paths)}

    gm = gs = None
    if dataset.norm_mode == "global":
        params = dataset.global_norm_params[dataset.sensor_key]
        gm = torch.tensor(params["mean"], dtype=torch.float32, device=device)
        gs = torch.tensor(params["std"], dtype=torch.float32, device=device)
    return DeviceSceneCache(
        images=images,
        labels=labels,
        scene_index=scene_index,
        crop_hw=(ch, cw),
        ignore_index=int(dataset.ignore_index),
        norm_mode=dataset.norm_mode,
        global_mean=gm,
        global_std=gs,
        nbytes=int(nbytes),
    )


def make_batch_builder(cache: DeviceSceneCache):
    """``build(rows [B, 5] int32 numpy) -> {image, target, mean, std}`` on
    the cache's device: image [B, ch, cw, C] f32, target [B, ch, cw] int32,
    mean and std [B, 1, 1, C] f32, the host loader's batch layout.

    Local statistics are summed in f64 over the crop's inside and rounded
    to f32 once, so they sit within an f32 rounding of the host's.
    """
    device = cache.images.device
    ch, cw = cache.crop_hw
    rows_h = torch.arange(ch, device=device)
    cols_w = torch.arange(cw, device=device)
    n_channels = int(cache.images.shape[-1])

    def build(rows: np.ndarray) -> dict:
        r = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int32))
        if device.type == "cuda":
            r = r.pin_memory().to(device, non_blocking=True)
        scene, h0, w0, h_len, w_len = r.long().unbind(1)
        hi = (h0[:, None] + rows_h)[:, :, None]  # [B, ch, 1]
        wi = (w0[:, None] + cols_w)[:, None, :]  # [B, 1, cw]
        s = scene[:, None, None]
        img = cache.images[s, hi, wi]  # [B, ch, cw, C]
        lbl = cache.labels[s, hi, wi]  # [B, ch, cw]
        inside = (rows_h[None, :, None] < h_len[:, None, None]) & (
            cols_w[None, None, :] < w_len[:, None, None]
        )
        b = img.shape[0]
        if cache.norm_mode == "local":
            m = inside[..., None].double()
            n = m.sum(dim=(1, 2)).clamp_min(1.0)  # [B, 1]
            x = img.double()
            mean = (x * m).sum(dim=(1, 2)) / n
            var = ((x - mean[:, None, None]) ** 2 * m).sum(dim=(1, 2)) / n
            mean, std = mean.float(), var.sqrt().float()
            std = torch.where(std == 0, torch.ones_like(std), std)
        elif cache.norm_mode == "global":
            mean = cache.global_mean.expand(b, n_channels)
            std = cache.global_std.expand(b, n_channels)
        elif cache.norm_mode is None:
            mean = torch.zeros((b, n_channels), dtype=torch.float32, device=device)
            std = torch.ones((b, n_channels), dtype=torch.float32, device=device)
        else:
            raise NotImplementedError(
                f'Normalization mode "{cache.norm_mode}" not implemented.'
            )
        mean4, std4 = mean[:, None, None, :], std[:, None, None, :]
        img = torch.where(inside[..., None], (img - mean4) / std4, 0.0)
        lbl = torch.where(inside, lbl, cache.ignore_index)
        return {"image": img, "target": lbl, "mean": mean4.contiguous(),
                "std": std4.contiguous()}

    return build


def cache_batches(cache: DeviceSceneCache, dataset, batch_size: int, order,
                  drop_last: bool = False):
    """``(batch, indices, n_real)`` for each run of ``batch_size`` dataset
    indices in ``order``: a short final run is dropped (``drop_last``) or
    padded with index 0 to the fixed batch, its first ``n_real`` rows real."""
    build = make_batch_builder(cache)
    for start in range(0, len(order), batch_size):
        idx = np.asarray(order[start : start + batch_size])
        n_real = len(idx)
        if n_real < batch_size and drop_last:
            break
        idx = np.concatenate([idx, np.zeros(batch_size - n_real, idx.dtype)])
        yield build(cache.index_rows(dataset, idx)), idx, n_real
