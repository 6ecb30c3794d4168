"""Training logs: the port of ``floodplanet_code_tpu/train/logging.py`` and
of the writer ``fit_model`` opens (``train/fit.py:635-654`` there).

``open_writer`` returns tensorboardX's ``SummaryWriter`` when that package
imports (the JAX package's writer), else ``torch.utils.tensorboard``'s,
else a ``JsonlWriter`` with the same ``add_scalar``/``add_image``/``close``
interface. ``log_image_panel`` renders the first batch element as a
stacked RGB / prediction-confusion panel (the reference's disabled image
logging, water_seg_model.py:115-134, made functional).
"""

from __future__ import annotations

import json
import os

import numpy as np

from floodplanet_code_tpu_torch.utils.image import create_conf_matrix_pred_image


class JsonlWriter:
    """Scalars as JSON lines in ``<logdir>/scalars.jsonl`` (one
    ``{"tag", "value", "step"}`` object per line) and images as
    ``<logdir>/images/<tag>_<step>.npy`` (CHW float arrays)."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._file = open(os.path.join(logdir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value, step: int) -> None:
        record = {"tag": tag, "value": float(value), "step": int(step)}
        self._file.write(json.dumps(record) + "\n")

    def add_image(self, tag: str, image, step: int) -> None:
        image_dir = os.path.join(self.logdir, "images")
        os.makedirs(image_dir, exist_ok=True)
        np.save(os.path.join(image_dir, f"{tag}_{int(step)}.npy"), np.asarray(image))

    def close(self) -> None:
        self._file.close()


def open_writer(logdir: str):
    """(writer, name) for ``logdir``: tensorboardX, torch.utils.tensorboard
    or ``JsonlWriter``, the first whose package imports."""
    try:
        from tensorboardX import SummaryWriter

        return SummaryWriter(logdir), "tensorboardX"
    except ImportError:
        pass
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(logdir), "torch.utils.tensorboard"
    except ImportError:
        pass
    return JsonlWriter(logdir), "jsonl"


def log_image_panel(
    writer,
    tag: str,
    image_nhwc: np.ndarray,
    mean: np.ndarray,
    std: np.ndarray,
    logits_nhwc: np.ndarray,
    target_hw: np.ndarray,
    to_rgb_fn,
    global_step: int,
) -> None:
    """Write one RGB|CM panel (reference log_image_to_tensorflow analog).

    Args:
        image_nhwc: [H,W,C] normalized input (first batch element).
        mean, std: [1,1,C] normalization stats for un-normalization
            (water_seg_model.py:117 ``images * std + mean``).
        logits_nhwc: [H,W,n_classes] raw logits.
        target_hw: [H,W] int labels.
        to_rgb_fn: CHW multi-band -> HW3 visualization callable.
    """
    image = np.asarray(image_nhwc) * np.asarray(std) + np.asarray(mean)
    rgb = to_rgb_fn(np.transpose(image, (2, 0, 1)))
    rgb = np.clip(np.nan_to_num(rgb), 0.0, 1.0)

    pred = np.asarray(logits_nhwc).argmax(axis=-1)
    target = np.asarray(target_hw)
    cm = create_conf_matrix_pred_image(
        (pred == 1).astype(np.uint8), (target == 1).astype(np.uint8)
    ).astype(np.float32) / 255.0

    panel = np.concatenate([rgb, cm], axis=0)  # stacked vertically
    writer.add_image(tag, panel.transpose(2, 0, 1), global_step)
