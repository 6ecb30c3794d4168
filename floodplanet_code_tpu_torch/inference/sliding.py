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

More than one device stays one process: ``make_replicated_predict_step``
runs a replica of the model on each device of a list, each batch split in
equal parts that launch on their devices without a sync between them, and
gathers the probabilities to the first device, where the stitcher lives.
"""

from __future__ import annotations

import copy
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
from floodplanet_code_tpu_torch.utils import trace


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


def replicate(model, devices) -> list:
    """A replica of ``model`` on each of ``devices``: the model itself on
    the first, when it is there, and a copy on every other."""
    first = next(model.parameters()).device
    return [model if k == 0 and d == first else copy.deepcopy(model).to(d)
            for k, d in enumerate(devices)]


def split_apply(fns, devices, batch: dict) -> list:
    """``fns[k]`` on part k of ``batch``'s rows, copied to ``devices[k]``:
    the rows split in ``len(devices)`` equal parts, and every part launched
    before any result is gathered. Returns the parts' results, each on its
    device. The batch must split evenly (``split_batch_size``)."""
    n = len(devices)
    rows = int(batch["image"].shape[0])
    if rows % n:
        raise ValueError(f"a batch of {rows} does not split over {n} devices")
    per = rows // n
    return [fn({k: v[i * per:(i + 1) * per].to(d, non_blocking=True) for k, v in batch.items()})
            for i, (d, fn) in enumerate(zip(devices, fns))]


def make_replicated_predict_step(model, devices, tta: bool = False) -> Callable:
    """``predict_step(batch) -> probabilities`` over a replica of ``model``
    on each of ``devices`` (``replicate``): each device's share of the
    batch's rows runs there (``split_apply``), and the probabilities are
    concatenated on ``devices[0]``."""
    devices = [torch.device(d) for d in devices]
    steps = [make_predict_step(m, tta) for m in replicate(model, devices)]

    def predict_step(batch: dict) -> torch.Tensor:
        return torch.cat([p.to(devices[0], non_blocking=True)
                          for p in split_apply(steps, devices, batch)])

    return predict_step


def inference_devices(cfg, device="cuda", devices=None) -> list[torch.device]:
    """The devices an inference call runs on: ``devices`` when given, else
    ``tpu.n_devices`` of ``device``'s type (``mesh.device_list``: raises
    when fewer cards are present), else ``device`` alone. The JAX package
    takes every device when ``tpu.n_devices`` is unset; the port's entry
    points run on the one device they are given unless asked for more."""
    if devices:
        return [resolve_device(d) for d in devices]
    n = int(cfg.select("tpu.n_devices") or 1)
    if n > 1:
        from floodplanet_code_tpu_torch.parallel.mesh import device_list

        return [resolve_device(d) for d in device_list(n, device)]
    return [resolve_device(device)]


def resolve_inference_batch_size(cfg, n_devices: int = 1) -> int:
    """Inference batch size: ``tpu.inference_batch_size`` when set, else
    the training ``batch_size``; rounded down to a multiple of
    ``n_devices`` and up to at least one tile per device (JAX
    ``inference/sliding.py:166-181``)."""
    batch_size = int(cfg.select("tpu.inference_batch_size", 0) or 0)
    if batch_size <= 0:
        batch_size = int(cfg.batch_size)
    return split_batch_size(batch_size, n_devices)


def split_batch_size(batch_size: int, n_devices: int) -> int:
    """``batch_size`` rounded down to a multiple of ``n_devices``, and up
    to at least one row per device."""
    batch_size = max(int(batch_size), n_devices)
    return batch_size - batch_size % n_devices


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

    Spans (``utils/trace.py``): ``predict.forward`` (launching a batch's
    forward), ``stitch.add`` (the batch's grouping, masks and canvas adds)
    and ``stitch.fetch`` (a finished scene's canvas to the host, waiting for
    the queued work); the scene cache and its gathers have their own.
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
        with trace.span("predict.forward"):  # the launches; the device runs on
            if timed:
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
            probs = predict_step(_to_model_layout(batch))
            if timed:
                events[1].record()
                forward_events.append(events)
        with trace.span("stitch.add"):
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
            finished = []
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
                trace.count("h2d_bytes", sel.nbytes)
                tiles = probs.index_select(0, sel)
                pred_stitcher.add_batch(
                    key, cp0.og_height, cp0.og_width, tiles, offsets, valid_mask,
                    geo_from=md0["image_path"],
                )
                if per_crop_ignore_index is not None:
                    mask = torch.from_numpy(valid_mask)
                    trace.count("h2d_bytes", mask.nbytes)
                    mask = mask.to(device, non_blocking=True)
                    crop_cms.setdefault(key, []).append(confusion_from_preds(
                        tiles.argmax(dim=-1), batch["target"].index_select(0, sel),
                        n_classes, per_crop_ignore_index, mask, per_sample=True,
                    ))
                if collect_extras:
                    if "rgb" not in extra_stitchers:
                        extra_stitchers["rgb"] = DeviceStitcher(int(unnorm.shape[-1]),
                                                                device=device)
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
                    finished.append(key)
        # Yielded outside the spans: the caller's work is not the stitch's.
        for key in finished:
            with trace.span("stitch.fetch"):
                result = dict(scene_info.pop(key))
                result["probabilities"] = pred_stitcher.pop_combined(key)
                if per_crop_ignore_index is not None:
                    confusions = torch.cat(crop_cms.pop(key))
                    trace.count("d2h_bytes", confusions.nbytes)
                    result["crop_confusions"] = confusions.cpu().numpy()
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
