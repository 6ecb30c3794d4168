"""Evaluation + scene-prediction CLI (port of
``floodplanet_code_tpu/inference/predict.py``; reference: st_water_seg/predict.py).

Given a checkpoint, rebuilds the eval dataset, runs sliding-window
inference on the card (through the HBM scene cache when the scenes fit
``tpu.device_data_bytes``), and writes the reference's report layout under
``<exp>/predictions/<dataset>/<region-or-split>/<ckpt>/``:

- ``metrics.json``           aggregate test metrics (predict.py:385-392)
- ``ranked_images_*.txt``    per-image F1/mIoU rankings (predict.py:73-107)
- ``ranked_regions_*.txt``   per-region rankings (predict.py:109-126)
- per scene under ``image_predictions/<region>/<image>/``:
  ``rgb.png``, ``pred_softmax.png``, ``gt.png``, ``pred_class.tif``
  (georeferenced), ``cm.png`` confusion-matrix image, ``rgb_cm.gif``
  (predict.py:268-383)

As in the JAX package: by default the ranked reports score each stitched
scene once (every pixel counted once); ``--per_crop_stats`` ranks by the
mean of per-crop metrics (the reference's semantics, predict.py:236-261).
``metrics.json`` always comes from the scene-level confusion matrix.

The checkpoint is a directory written by the port's ``fit_model`` (its EMA
weights when it has them) or a weights file
(``tools/import_jax_params.save_weights``); the experiment config is read
two levels above it (``inference/infer.py::load_model_for_eval``).

    python -m floodplanet_code_tpu_torch.inference.predict \\
        <experiment>/checkpoints/<entry> [--per_crop_stats] [--tta] \\
        [--no-predict_images] [--eval_region R] [--eval_dataset_split test] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict, deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from floodplanet_code_tpu_torch.config import load_experiment_config
from floodplanet_code_tpu_torch.data import build_dataset, generate_image_slice_object
from floodplanet_code_tpu_torch.geo import tiff
from floodplanet_code_tpu_torch.inference.infer import load_model_for_eval
from floodplanet_code_tpu_torch.inference.sliding import (
    inference_devices,
    make_replicated_predict_step,
    resolve_inference_batch_size,
    sliding_window_predict,
)
from floodplanet_code_tpu_torch.ops.metrics import (
    compute_binary_class_metrics,
    compute_metrics,
    confusion_from_preds,
    torchmetrics_key_names,
)
from floodplanet_code_tpu_torch.train.fit import resolve_ignore_index
from floodplanet_code_tpu_torch.utils import trace
from floodplanet_code_tpu_torch.utils.image import create_conf_matrix_pred_image, create_gif


def save_image_stats(image_stats: dict, pred_dir: str, metric_name: str) -> None:
    """Ranked per-image metric report (reference predict.py:73-107)."""
    per_image = {name: float(np.mean(values)) for name, values in image_stats.items()}
    ranked = sorted(per_image.items(), key=lambda kv: kv[1], reverse=True)
    path = os.path.join(pred_dir, f"ranked_images_{metric_name}.txt")
    with open(path, "w") as handle:
        handle.write(f"Ranked image {metric_name} \n")
        handle.write("---------------------- \n")
        for name, value in ranked:
            short = os.path.splitext(os.path.basename(name))[0]
            handle.write(f"{short}: {value * 100}% \n")


def save_region_stats(region_stats: dict, pred_dir: str, metric_name: str) -> None:
    """Ranked per-region metric report (reference predict.py:109-126)."""
    per_region = {name: float(np.mean(values)) for name, values in region_stats.items()}
    ranked = sorted(per_region.items(), key=lambda kv: kv[1], reverse=True)
    path = os.path.join(pred_dir, f"ranked_regions_{metric_name}.txt")
    with open(path, "w") as handle:
        handle.write(f"Ranked region {metric_name} \n")
        handle.write("---------------------- \n")
        for name, value in ranked:
            handle.write(f"{name}: {value * 100}% \n")


# Scenes whose artifacts may be in the writer pool at once: each holds its
# canvases (hundreds of MB for a 7-megapixel scene) until written.
_MAX_PENDING_SCENES = 2


def _submit_scene_artifacts(pool, scene_dir: str, scene: dict, probs, gt, water_pred,
                            to_rgb, spent: list) -> list:
    """Queue rgb.png, pred_softmax.png, gt.png, pred_class.tif (geo tags of
    the source scene), cm.png and rgb_cm.gif (predict.py:268-383) on
    ``pool``, one file per task: PNG and GIF encoding release the GIL, so
    they run beside each other and beside the next scenes' inference.
    Returns the futures; each task appends its host seconds to ``spent``."""
    from PIL import Image

    os.makedirs(scene_dir, exist_ok=True)
    rgb = to_rgb(np.transpose(scene["rgb"], (2, 0, 1)))
    rgb_u8 = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    cm_img = create_conf_matrix_pred_image(water_pred, gt == 1)

    def timed(fn, *args):
        def run():
            # A root of its own: the task outlives the span that queued it.
            with trace.span("predict.artifact") as task:
                fn(*args)
            spent.append(task.seconds)
        return pool.submit(run)

    def png(array, name):
        Image.fromarray(array).save(os.path.join(scene_dir, name))

    return [
        timed(png, rgb_u8, "rgb.png"),
        timed(png, (np.clip(probs[..., 1], 0, 1) * 255).astype(np.uint8), "pred_softmax.png"),
        timed(png, ((gt == 1) * 255).astype(np.uint8), "gt.png"),
        timed(tiff.imwrite, os.path.join(scene_dir, "pred_class.tif"), water_pred,
              scene["image_path"]),
        timed(png, cm_img, "cm.png"),
        timed(create_gif, [rgb_u8, cm_img], os.path.join(scene_dir, "rgb_cm.gif")),
    ]


def predict(
    cfg,
    experiment_dir: str,
    checkpoint_path: str,
    eval_dataset_name: str,
    predict_images: bool = True,
    eval_region=None,
    eval_dataset_split: str = "test",
    n_workers: int | None = None,
    per_crop_stats: bool = False,
    tta: bool = False,
    device="cuda",
    timing: dict | None = None,
    on_scene=None,
    devices=None,
) -> dict:
    """Evaluate a checkpoint; returns the aggregate metrics dict (also
    written to ``metrics.json``).

    ``per_crop_stats``: rank images/regions by the mean of per-crop
    metrics (reference semantics) instead of one score per stitched scene.
    ``tta``: dihedral test-time augmentation (8 forwards per tile).
    Scene artifacts are written on ``n_workers`` threads beside the
    inference of the next scenes; all are written when ``predict`` returns.
    ``timing``: a dict that receives where the time went, from the spans
    of the same names (``utils/trace.py``): ``setup_s`` (dataset and model,
    ``predict.setup``), ``loop_s`` (loading, forward and stitching, as the
    scenes arrive, ``predict.loop``), ``forward_ms`` (the forwards' device
    time from CUDA events; on a card only), ``metrics_s``
    (``predict.metrics``), ``artifacts_s`` (host seconds of the writer
    tasks, summed over threads, ``predict.artifact``), ``artifacts_wait_s``
    (what the artifacts added to predict's wall: preparing them and waiting
    for the writers, ``predict.artifacts_wait``), ``scenes``, ``tiles`` and
    ``batches``. ``on_scene``: called as
    ``on_scene(scene, pred_class, confusion)`` for every scene after its
    metrics (the sliding-window result dict, its argmax map and its [C, C]
    confusion matrix). ``devices``: a replica of the model per device, each
    batch split over them, as ``infer`` takes it (``inference_devices``).
    Raises without a card unless ``device="cpu"``.
    """
    devices = inference_devices(cfg, device, devices)
    device = devices[0]
    with trace.span("predict.setup") as setup:
        slice_params = generate_image_slice_object(cfg.crop_height, cfg.crop_width, cfg.crop_stride)
        if eval_region:
            cfg.eval_region = eval_region
        dataset_kwargs = cfg.dataset.get("dataset_kwargs") or {}
        eval_dataset = build_dataset(
            eval_dataset_name,
            eval_dataset_split,
            slice_params,
            sensor=cfg.dataset.sensor,
            channels=cfg.dataset.channels,
            norm_mode=cfg.norm_mode,
            eval_region=cfg.eval_region,
            ignore_index=cfg.ignore_index,
            seed_num=cfg.select("seed_num"),
            train_split_pct=cfg.select("train_split_pct", 0.8),
            output_metadata=True,
            **dataset_kwargs,
        )
        n_classes = eval_dataset.n_classes
        ignore_index = resolve_ignore_index(cfg.ignore_index, n_classes)
        model = load_model_for_eval(cfg, checkpoint_path, eval_dataset, device)
        batch_size = resolve_inference_batch_size(cfg, len(devices))

        ckpt_name = os.path.basename(os.path.normpath(checkpoint_path))
        region_key = (
            f"split_pct_{cfg.select('train_split_pct', 0.8)}"
            if cfg.eval_region is None
            else "-".join(
                cfg.eval_region
                if isinstance(cfg.eval_region, (list, tuple))
                else [cfg.eval_region]
            )
        )
        pred_dir = os.path.join(experiment_dir, "predictions", eval_dataset_name, region_key,
                                ckpt_name)
        os.makedirs(pred_dir, exist_ok=True)

        total_confusion = np.zeros((n_classes, n_classes), np.float32)
        image_stats_f1, region_stats_f1 = defaultdict(list), defaultdict(list)
        image_stats_iou, region_stats_iou = defaultdict(list), defaultdict(list)
        events: list = []
        spent = {"metrics_s": 0.0, "artifacts_wait_s": 0.0, "loop_s": 0.0}
        writer_s: list = []  # per writer task, host seconds
        workers = n_workers or cfg.n_workers
        pool = ThreadPoolExecutor(max_workers=max(1, workers)) if predict_images else None
        pending: deque = deque()  # per scene, its writer futures
    setup_s = setup.seconds
    scenes = sliding_window_predict(
        model,
        eval_dataset,
        batch_size=batch_size,
        n_workers=workers,
        device=device,
        tta=tta,
        device_data_bytes=int(cfg.select("tpu.device_data_bytes", 6 << 30) or 0),
        collect_extras=True,
        per_crop_ignore_index=ignore_index if per_crop_stats else None,
        forward_events=events,
        predict_step=make_replicated_predict_step(model, devices, tta) if len(devices) > 1
        else None,
    )

    def drain(futures) -> None:
        for future in futures:
            future.result()  # raises what the writer raised

    n_scenes = 0
    try:
        while True:
            with trace.span("predict.loop") as step:
                scene = next(scenes, None)
            spent["loop_s"] += step.seconds
            if scene is None:
                break
            n_scenes += 1
            with trace.span("predict.metrics") as step:
                probs = scene["probabilities"]  # [H, W, n_classes]
                gt = np.rint(scene["gt"]).astype(np.int32)
                pred_class = probs.argmax(axis=-1)
                # Binary water mask: classes clipped to {0, 1} as the reference
                # does (predict.py:305-308): class-2 ("unknown") predictions
                # count as water.
                water_pred = np.minimum(pred_class, 1).astype(np.uint8)
                confusion = confusion_from_preds(
                    torch.from_numpy(pred_class), torch.from_numpy(gt), n_classes, ignore_index
                ).numpy()
                total_confusion += confusion
                if per_crop_stats:
                    # Reference semantics: one score per crop, reports average them.
                    ranked = [compute_metrics(torch.from_numpy(cm), ignore_index=ignore_index)
                              for cm in scene["crop_confusions"]]
                else:
                    ranked = [compute_metrics(torch.from_numpy(confusion),
                                              ignore_index=ignore_index)]
                for metrics in ranked:
                    f1 = float(metrics["F1Score"])
                    iou = float(metrics["JaccardIndex"])
                    image_stats_f1[scene["image_path"]].append(f1)
                    image_stats_iou[scene["image_path"]].append(iou)
                    region_stats_f1[scene["region"]].append(f1)
                    region_stats_iou[scene["region"]].append(iou)
            spent["metrics_s"] += step.seconds
            if on_scene is not None:
                on_scene(scene, pred_class, confusion)
            if predict_images:
                with trace.span("predict.artifacts_wait") as step:
                    scene_dir = os.path.join(pred_dir, "image_predictions", scene["region"],
                                             scene["image_name"])
                    while len(pending) >= _MAX_PENDING_SCENES:
                        drain(pending.popleft())
                    pending.append(_submit_scene_artifacts(
                        pool, scene_dir, scene, probs, gt, water_pred, eval_dataset.to_RGB,
                        writer_s))
                spent["artifacts_wait_s"] += step.seconds
        with trace.span("predict.artifacts_wait") as step:
            while pending:
                drain(pending.popleft())
        spent["artifacts_wait_s"] += step.seconds
    finally:
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)

    # Aggregate metrics with the reference's exported key names.
    with trace.span("predict.metrics") as step:
        confusion = torch.from_numpy(total_confusion)
        metrics = compute_metrics(confusion, "test_", ignore_index=ignore_index)
        metrics.update(compute_binary_class_metrics(confusion, 1, "test_"))
        key_map = torchmetrics_key_names("test_")
        all_metrics = {key_map.get(k, k): float(v) for k, v in metrics.items()}
        all_metrics["eval_dataset"] = eval_dataset_name
        with open(os.path.join(pred_dir, "metrics.json"), "w") as handle:
            json.dump(all_metrics, handle, indent=4)

        save_image_stats(image_stats_f1, pred_dir, "F1-score")
        save_image_stats(image_stats_iou, pred_dir, "mIoU")
        if region_stats_iou:
            save_region_stats(region_stats_f1, pred_dir, "F1-Score")
            save_region_stats(region_stats_iou, pred_dir, "iou")
    spent["metrics_s"] += step.seconds
    if timing is not None:
        if events:
            torch.cuda.synchronize(device)
        timing.update(spent, setup_s=setup_s, artifacts_s=sum(writer_s), scenes=n_scenes,
                      tiles=len(eval_dataset),
                      batches=-(-len(eval_dataset) // batch_size),
                      forward_ms=sum(a.elapsed_time(b) for a, b in events) if events else None,
                      pred_dir=pred_dir)
    return all_metrics


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Evaluate a checkpoint and reconstruct scene predictions."
    )
    parser.add_argument("checkpoint_path", type=str)
    parser.add_argument("--eval_dataset_name", type=str, default=None)
    parser.add_argument(
        "--predict_images",
        default=True,
        action=argparse.BooleanOptionalAction,
        help="Write per-scene images (disable with --no-predict_images).",
    )
    parser.add_argument("--eval_region", type=str, default=None)
    parser.add_argument("--eval_dataset_split", type=str, default="test")
    parser.add_argument("--n_workers", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument(
        "--per_crop_stats",
        action="store_true",
        help="Rank images/regions by mean per-crop metrics (reference "
        "predict.py semantics) instead of one score per stitched scene.",
    )
    parser.add_argument(
        "--tta",
        action="store_true",
        help="Dihedral test-time augmentation: average tile softmax over "
        "the 8 square-symmetry transforms (~8x forward cost).",
    )
    args = parser.parse_args(argv)

    # Experiment dir = two levels above the checkpoint
    # (<exp>/checkpoints/<name>), matching the reference layout.
    experiment_dir = os.path.dirname(os.path.dirname(os.path.normpath(args.checkpoint_path)))
    cfg = load_experiment_config(experiment_dir)
    metrics = predict(
        cfg,
        experiment_dir,
        args.checkpoint_path,
        eval_dataset_name=args.eval_dataset_name or cfg.dataset.name,
        predict_images=args.predict_images,
        eval_region=args.eval_region,
        eval_dataset_split=args.eval_dataset_split,
        n_workers=args.n_workers,
        per_crop_stats=args.per_crop_stats,
        tta=args.tta,
        device=args.device,
    )
    print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main()
