"""Sliding-window full-scene inference (port of
``floodplanet_code_tpu/inference/sliding.py``).

1. enumerates fixed-shape tiles over each scene (same exact-mode crop math
   as training; the dataset does this),
2. runs the forward in batches on the device, fed from the HBM scene
   cache (data/device_cache.py: the scenes are loaded once, crops are
   gathered on the card from index rows) when the dataset fits
   ``device_data_bytes``, else by the host loader plus a pinned-memory
   side-stream prefetch,
3. softmaxes on the device and adds the predictions into device-resident
   per-scene canvases (inference/stitcher.py) — no per-tile host traffic,
4. finalizes each scene once, as soon as its last tile has landed.

Yields host numpy canvases per scene for the CLIs to export/report on; for
``predict`` also the stitched input and label canvases and per-crop
confusion matrices.
"""

from __future__ import annotations

import itertools
import os
from typing import Callable, Iterator

import numpy as np
import torch

from floodplanet_code_tpu_torch.data import BatchLoader, device_prefetch
from floodplanet_code_tpu_torch.data.device_cache import (
    build_device_cache,
    cache_batches,
)
from floodplanet_code_tpu_torch.device import resolve_device
from floodplanet_code_tpu_torch.inference.stitcher import (
    DeviceStitcher,
    make_tile_valid_mask,
)
from floodplanet_code_tpu_torch.models.water_seg import AUX_FEATURE_KEYS
from floodplanet_code_tpu_torch.ops.metrics import confusion_from_preds


def _d4_elements(square: bool):
    """The dihedral group as (transpose, flip_h, flip_w) triples.

    Non-square tiles keep only the 4 flip-only elements (transposing would
    change the tile shape).
    """
    ts = (False, True) if square else (False,)
    return list(itertools.product(ts, (False, True), (False, True)))


# On NCHW tensors: H is dim 2, W is dim 3.
def _d4_apply(x: torch.Tensor, t: bool, fh: bool, fw: bool) -> torch.Tensor:
    if t:
        x = x.transpose(2, 3)
    if fh:
        x = x.flip(2)
    if fw:
        x = x.flip(3)
    return x


def _d4_invert(x: torch.Tensor, t: bool, fh: bool, fw: bool) -> torch.Tensor:
    # apply = transpose then flips, so invert = unflip then untranspose.
    if fh:
        x = x.flip(2)
    if fw:
        x = x.flip(3)
    if t:
        x = x.transpose(2, 3)
    return x


def predict_probs(model, batch: dict, tta: bool = False) -> torch.Tensor:
    """Forward -> softmax probabilities [B, H, W, n_classes] (f32).

    ``batch``: a dict of NCHW tensors on the model's device (``image`` plus
    optional aux rasters). ``tta=True`` averages the softmax over the 8
    dihedral transforms of the input (4 flip-only ones for non-square
    tiles), each inverted exactly back to canvas orientation.
    """
    model_batch = {"image": batch["image"]}
    for key in AUX_FEATURE_KEYS:
        if key in batch:
            model_batch[key] = batch[key]
    if not tta:
        probs = torch.softmax(model(model_batch), dim=1)
    else:
        shape = model_batch["image"].shape
        elements = _d4_elements(square=shape[2] == shape[3])
        probs = None
        for t, fh, fw in elements:
            tb = {k: _d4_apply(v, t, fh, fw) for k, v in model_batch.items()}
            p = _d4_invert(torch.softmax(model(tb), dim=1), t, fh, fw)
            probs = p if probs is None else probs + p
        probs = probs / len(elements)
    return probs.permute(0, 2, 3, 1)


def make_predict_step(model, tta: bool = False) -> Callable:
    """``predict_step(batch) -> predict_probs(model, batch, tta)`` under
    inference mode."""

    @torch.inference_mode()
    def predict_step(batch: dict) -> torch.Tensor:
        return predict_probs(model, batch, tta)

    return predict_step


def resolve_inference_batch_size(cfg) -> int:
    """``tpu.inference_batch_size`` when set, else the training
    ``batch_size`` (one card: no rounding to a device multiple)."""
    batch_size = int(cfg.select("tpu.inference_batch_size", 0) or 0)
    return batch_size if batch_size > 0 else int(cfg.batch_size)


def _to_model_layout(batch: dict) -> dict:
    """NHWC image-like tensors -> NCHW views (channels_last memory, no copy)."""
    out = {}
    for key in ("image", *AUX_FEATURE_KEYS):
        if key in batch:
            out[key] = batch[key].permute(0, 3, 1, 2)
    return out


def _device_cache_batches(dataset, batch_size: int, device_data_bytes: int, device,
                          n_workers: int):
    """Index-driven batches from the HBM scene cache with host-side
    ``valid`` flags and ``metadata``, or None when the dataset does not fit
    (``build_device_cache`` says why)."""
    cache = build_device_cache(dataset, device_data_bytes, device, n_workers)
    if cache is None:
        return None

    def batches():
        order = np.arange(len(dataset))
        for batch, idx, n_real in cache_batches(cache, dataset, batch_size, order):
            valid = [k < n_real for k in range(batch_size)]
            batch["valid"] = valid
            batch["metadata"] = [
                {
                    "image_path": dataset.dataset[i].image_path,
                    "crop_params": dataset.dataset[i].crop_params,
                    "region_name": dataset.dataset[i].region_name,
                }
                if ok
                else None
                for i, ok in zip(idx, valid)
            ]
            yield batch

    return batches()


def sliding_window_predict(
    model,
    dataset,
    batch_size: int,
    n_workers: int = 4,
    device="cuda",
    tta: bool = False,
    device_data_bytes: int = 6 << 30,
    collect_extras: bool = False,
    per_crop_ignore_index: int | None = None,
    forward_events: list | None = None,
    predict_step: Callable | None = None,
) -> Iterator[dict]:
    """Run tiled inference over a dataset; yield per-scene results.

    Yields dicts with keys region, image_name, image_path and
    probabilities [H, W, C] (overlap-averaged softmax, numpy f32), and
    optionally (``collect_extras``) the stitched ``rgb`` [H, W, C_in]
    un-normalized input canvas (``image * std + mean``) and ``gt`` [H, W]
    label canvas for report generation (predict.py:268-347 of the
    reference).

    ``per_crop_ignore_index``: when set, every scene result also carries
    ``crop_confusions`` [n_tiles, C, C], one confusion matrix per crop as
    the model saw it (ragged-edge mask applied, this ignore_index dropped),
    computed on the device for a whole batch at once; the reference's
    per-crop metric tallies (predict.py:236-261).

    ``device_data_bytes``: the HBM scene cache's budget (0 = host loader).
    ``forward_events``: a list that receives one (start, end) pair of CUDA
    events around each batch's forward, for a caller that times the
    forward on the device without a sync per batch. ``predict_step``: run
    this (NCHW batch dict -> [B, H, W, n_classes] probabilities; an
    exported program, tools/export_model.py) instead of
    ``make_predict_step(model, tta)``; ``model`` and ``tta`` are then not
    read. Raises without a card unless ``device="cpu"``.
    """
    device = resolve_device(device)
    if predict_step is None:
        predict_step = make_predict_step(model, tta=tta)
    timed = forward_events is not None and device.type == "cuda"

    n_classes = dataset.n_classes
    pred_stitcher = DeviceStitcher(n_classes, device=device)
    extra_stitchers: dict[str, DeviceStitcher] = {}
    scene_info: dict[str, dict] = {}
    tiles_remaining: dict[str, int] = {}
    crop_cms: dict[str, list] = {}
    # Pre-count tiles per scene so finished scenes can be finalized (and
    # freed) as soon as their last tile lands.
    for example in dataset.dataset:
        key = f"{example.region_name}/{_image_name(example.image_path)}"
        tiles_remaining[key] = tiles_remaining.get(key, 0) + 1

    batches = (
        _device_cache_batches(dataset, batch_size, device_data_bytes, device, n_workers)
        if device_data_bytes
        else None
    )
    if batches is None:
        loader = BatchLoader(
            dataset,
            batch_size=batch_size,
            shuffle=False,
            n_workers=n_workers,
            drop_last=False,
            output_metadata=True,
            pad_final=True,
        )
        batches = device_prefetch(_host_flags(loader), device, size=2)
    for batch in batches:
        if timed:
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        probs = predict_step(_to_model_layout(batch))
        if timed:
            events[1].record()
            forward_events.append(events)
        metadata = batch["metadata"]
        batch_valid = batch["valid"]

        # Group the batch by scene for the canvas adds.
        tile_h, tile_w = int(probs.shape[1]), int(probs.shape[2])
        by_scene: dict[str, list[int]] = {}
        for i, md in enumerate(metadata):
            if not batch_valid[i] or md is None:
                continue
            key = f"{md['region_name']}/{_image_name(md['image_path'])}"
            by_scene.setdefault(key, []).append(i)

        unnorm = None
        if collect_extras:
            # mean/std are [B, 1, 1, C]: broadcast over [B, H, W, C].
            unnorm = batch["image"] * batch["std"] + batch["mean"]
        for key, idxs in by_scene.items():
            md0 = metadata[idxs[0]]
            cp0 = md0["crop_params"]
            scene_info.setdefault(
                key,
                {
                    "region": md0["region_name"],
                    "image_name": _image_name(md0["image_path"]),
                    "image_path": md0["image_path"],
                    "og_height": cp0.og_height,
                    "og_width": cp0.og_width,
                },
            )
            crops = [metadata[i]["crop_params"] for i in idxs]
            offsets = np.array([[cp.h0, cp.w0] for cp in crops], np.int64)
            valid_mask = make_tile_valid_mask(
                [cp.height for cp in crops], [cp.width for cp in crops], tile_h, tile_w
            )
            sel = torch.as_tensor(idxs, device=probs.device)
            tiles = probs.index_select(0, sel)
            pred_stitcher.add_batch(
                key, cp0.og_height, cp0.og_width, tiles, offsets, valid_mask,
                geo_from=md0["image_path"],
            )
            if per_crop_ignore_index is not None:
                mask = torch.from_numpy(valid_mask).to(device, non_blocking=True)
                crop_cms.setdefault(key, []).append(confusion_from_preds(
                    tiles.argmax(dim=-1), batch["target"].index_select(0, sel),
                    n_classes, per_crop_ignore_index, mask, per_sample=True,
                ))
            if collect_extras:
                if "rgb" not in extra_stitchers:
                    extra_stitchers["rgb"] = DeviceStitcher(int(unnorm.shape[-1]), device=device)
                    extra_stitchers["gt"] = DeviceStitcher(1, device=device)
                extra_stitchers["rgb"].add_batch(
                    key, cp0.og_height, cp0.og_width, unnorm.index_select(0, sel),
                    offsets, valid_mask,
                )
                extra_stitchers["gt"].add_batch(
                    key, cp0.og_height, cp0.og_width,
                    batch["target"].index_select(0, sel).float()[..., None], offsets,
                    valid_mask,
                )
            tiles_remaining[key] -= len(idxs)
            if tiles_remaining[key] == 0:
                result = dict(scene_info.pop(key))
                result["probabilities"] = pred_stitcher.pop_combined(key)
                if per_crop_ignore_index is not None:
                    result["crop_confusions"] = torch.cat(crop_cms.pop(key)).cpu().numpy()
                if collect_extras:
                    result["rgb"] = extra_stitchers["rgb"].pop_combined(key)
                    result["gt"] = extra_stitchers["gt"].pop_combined(key)[:, :, 0]
                yield result


def _host_flags(loader) -> Iterator[dict]:
    """Batches whose ``valid`` flags stay a host list: only the host reads
    them, so they need not cross to the device and back."""
    for batch in loader:
        batch["valid"] = batch["valid"].tolist()
        yield batch


def _image_name(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]
