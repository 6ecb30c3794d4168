"""Second-stage statistical normalization and label binarization.

Behavior contract:
  - ``normalize_stats`` mirrors BaseDataset.normalize
    (st_water_seg/datasets/base_dataset.py:77-113): mode ``global`` uses
    precomputed per-dataset per-sensor mean/std; ``local`` uses the crop's
    own per-channel statistics; ``None`` is identity. Returns
    ``(image, mean, std)`` with mean/std shaped [C, 1, 1] so they can ride
    along in the batch and be inverted for RGB export (predict.py:321-322).
    Unlike the reference (quirk: base_dataset.py:109-111 mutates the caller's
    array in place), this returns a fresh array.
  - ``binarize_label`` mirrors _load_label_image's value mapping
    (floodplanet.py:584-597): raw {0: nodata, 1: dry, 2: flood} ->
    {ignore_index, 0, 1}.
  - Global norm parameters are stored as JSON (``dataset_norm_params.json``)
    instead of the reference's pickle (datasets/utils.py:215-230), written by
    ``floodplanet_code_tpu/tools/compute_norm_params.py`` (not yet ported).
"""

from __future__ import annotations

import json
import os

import numpy as np


def normalize_stats(
    image: np.ndarray,
    norm_mode: str | None,
    global_params: dict | None = None,
    input_type: str | None = None,
):
    """Normalize a CHW float image; returns (image, mean[C,1,1], std[C,1,1])."""
    c = image.shape[0]
    if norm_mode == "global":
        if global_params is None or input_type is None:
            raise ValueError("global norm_mode requires global_params and input_type")
        params = global_params[input_type]
        mean = np.asarray(params["mean"], dtype=np.float32).reshape(c, 1, 1)
        std = np.asarray(params["std"], dtype=np.float32).reshape(c, 1, 1)
    elif norm_mode == "local":
        flat = image.reshape(c, -1)
        mean = flat.mean(axis=1).reshape(c, 1, 1).astype(np.float32)
        std = flat.std(axis=1).reshape(c, 1, 1).astype(np.float32)
        # Constant crops (e.g. fully padded edge tiles) have std 0; the
        # reference divides by it and produces NaNs — guard instead.
        std = np.where(std == 0, np.float32(1.0), std)
    elif norm_mode is None:
        mean = np.zeros((c, 1, 1), dtype=np.float32)
        std = np.ones((c, 1, 1), dtype=np.float32)
    else:
        raise NotImplementedError(
            f'Normalization mode "{norm_mode}" not implemented.'
        )
    out = (np.asarray(image, dtype=np.float32) - mean) / std
    return out, mean, std


def binarize_label(label: np.ndarray, ignore_index: int) -> np.ndarray:
    """Map raw label {0: nodata, 1: dry, 2: flood} -> {ignore, 0, 1}.

    Output dtype follows the reference: uint8 canvas written with
    ignore_index (floodplanet.py:586-596) — callers that use ignore_index=-1
    get the int16 equivalent so the sentinel survives.
    """
    dtype = np.uint8 if ignore_index >= 0 else np.int16
    binary = np.zeros(label.shape, dtype=dtype)
    binary[label == 2] = 1
    binary[label == 0] = ignore_index
    return binary


def pad_to_shape(
    image: np.ndarray,
    desired_height: int,
    desired_width: int,
    constant_value: float = 0,
) -> np.ndarray:
    """Zero-pad [H,W] or [C,H,W] up to a fixed shape; no-op if already large.

    Mirrors BaseDataset._add_buffer_to_image (base_dataset.py:271-325):
    content is anchored at the top-left, fill value is configurable (labels
    use ignore_index, floodplanet.py:622-625).
    """
    if image.ndim == 2:
        h, w = image.shape
        if h >= desired_height and w >= desired_width:
            return image
        canvas = np.full(
            (desired_height, desired_width), constant_value, dtype=image.dtype
        )
        canvas[:h, :w] = image
        return canvas
    if image.ndim == 3:
        c, h, w = image.shape
        if h >= desired_height and w >= desired_width:
            return image
        canvas = np.full(
            (c, desired_height, desired_width), constant_value, dtype=image.dtype
        )
        canvas[:, :h, :w] = image
        return canvas
    raise NotImplementedError(
        f'Cannot add buffer to image with "{image.ndim}" dimensions.'
    )


NORM_PARAMS_FILENAME = "dataset_norm_params.json"


def load_global_norm_params(dataset_name: str, norm_param_path: str | None = None):
    """Load precomputed global normalization parameters.

    Native format is JSON next to this package (or an explicit path) for
    safety and diffability. The reference's ``dataset_norm_params.p``
    pickles (datasets/utils.py:215-230, same ``{dataset: {input_type:
    {'mean','std'}}}`` structure with ndarray values) load transparently,
    so precomputed stats migrate with the checkpoints.
    """
    if norm_param_path is None:
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(__file__)))
        norm_param_path = os.path.join(pkg_root, NORM_PARAMS_FILENAME)
    if norm_param_path.endswith((".p", ".pkl", ".pickle")):
        import pickle

        with open(norm_param_path, "rb") as handle:
            all_params = pickle.load(handle)
    else:
        with open(norm_param_path, "r") as handle:
            all_params = json.load(handle)
    if dataset_name not in all_params:
        raise KeyError(
            f'Normalization parameters not available for dataset "{dataset_name}"'
        )
    return all_params[dataset_name]


def _jsonable(value):
    """ndarray/scalar leaves -> plain lists/floats (pickle-sourced params)."""
    if isinstance(value, dict):
        return {k: _jsonable(v) for k, v in value.items()}
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, (np.floating, np.integer)):
        return value.item()
    return value


def save_global_norm_params(
    dataset_name: str, params: dict, norm_param_path: str | None = None
) -> str:
    """Merge ``params`` into the stats file (JSON, or the reference's
    pickle format when the path says so — both directions of migration)."""
    if norm_param_path is None:
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(__file__)))
        norm_param_path = os.path.join(pkg_root, NORM_PARAMS_FILENAME)
    as_pickle = norm_param_path.endswith((".p", ".pkl", ".pickle"))
    all_params = {}
    if os.path.exists(norm_param_path):
        if as_pickle:
            import pickle

            with open(norm_param_path, "rb") as handle:
                all_params = pickle.load(handle)
        else:
            with open(norm_param_path, "r") as handle:
                all_params = json.load(handle)
    all_params[dataset_name] = params
    if as_pickle:
        import pickle

        with open(norm_param_path, "wb") as handle:
            pickle.dump(all_params, handle)
    else:
        with open(norm_param_path, "w") as handle:
            json.dump(_jsonable(all_params), handle, indent=2)
    return norm_param_path
