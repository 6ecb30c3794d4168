"""Per-sensor band handling: radiometric normalization, channel subsets, RGB.

Behavior contract (reference: st_water_seg/datasets/floodplanet.py:288-527
per-sensor ``_load_crop_norm_*`` and base_dataset.py:367-492 ``to_RGB``):

  Sentinel-1 (S1), 2 bands (VV, VH) float32 dB-like:
      keep first 2 bands, normalize ``clip((x + 50) / 100, 0, 1)``, NaN->0.
  Sentinel-2 (S2), 10 bands uint16:
      RGB = bands [3,2,1]; RGB_NIR = [3,2,1,7]; normalize clip(x / 2^12, 0, 1).
  PlanetScope (PS), 4 bands (B,G,R,NIR), stored HWC:
      keep first 4 bands; RGB = [2,1,0]; RGB_NIR = [2,1,0,3];
      divide by 2^16 only when dtype is uint16.
  Landsat-8 (L8), 7 bands:
      normalize clip(x, 0, 18607.72) / 18607.72 (the reference's empirical
      reflectance ceiling, floodplanet.py:525).

All functions are pure numpy on CHW float arrays so they are trivially
testable; the on-device (jit) variants used by the input pipeline live in
``floodplanet_code_tpu/data/augment.py`` (not yet ported).
"""

from __future__ import annotations

import numpy as np

SENSORS = ("S1", "S2", "PS", "L8")

# Reflectance ceiling used by the reference for Landsat-8 (floodplanet.py:525).
L8_MAX_REFLECTANCE = 18607.72

# Channel-count table (reference: floodplanet.py:234-286).
_N_CHANNELS = {
    "S2": {"RGB": 3, "RGB_NIR": 4, "ALL": 10},
    "PS": {"RGB": 3, "RGB_NIR": 4, "ALL": 4},
    "S1": {"ALL": 2},
    "L8": {"ALL": 7},
}


def sensor_n_channels(sensor: str, channels: str = "ALL") -> int:
    try:
        return _N_CHANNELS[sensor][channels]
    except KeyError:
        raise NotImplementedError(
            f'Cannot get number of {sensor} channels for channel query "{channels}"'
        )


def get_n_channels(
    sensor: str,
    channels: str = "ALL",
    dem: bool = False,
    slope: bool = False,
    preflood: bool = False,
    pre_post_difference: bool = False,
    hand: bool = False,
) -> dict:
    """Input-feature channel dict fed to models (floodplanet.py:234-286)."""
    n_channels = {"ms_image": sensor_n_channels(sensor, channels)}
    if dem:
        n_channels["dem"] = 1
    if slope:
        n_channels["slope"] = 1
    if preflood:
        n_channels["preflood"] = sensor_n_channels(sensor, channels)
    if pre_post_difference:
        n_channels["pre_post_difference"] = sensor_n_channels(sensor, channels)
    if hand:
        n_channels["hand"] = 1
    return n_channels


def ensure_chw(image: np.ndarray) -> np.ndarray:
    """Transpose HWC->CHW when the channel dim is clearly last.

    Matches the reference's heuristic for S1 (floodplanet.py:320-324) and the
    unconditional transpose for PS (floodplanet.py:432-435).
    """
    if image.ndim == 2:
        return image[None]
    c, h, w = image.shape
    if c > h or c > w:
        image = np.ascontiguousarray(np.transpose(image, (2, 0, 1)))
    return image


def select_channels(image: np.ndarray, sensor: str, channels: str) -> np.ndarray:
    """Band subsetting on a CHW array (reference band orderings cited above)."""
    if channels == "ALL":
        if sensor == "S1" and image.shape[0] > 2:
            image = image[:2]
        elif sensor == "PS" and image.shape[0] > 4:
            image = image[:4]
        return image
    if sensor == "S2":
        if channels == "RGB":
            return np.stack([image[3], image[2], image[1]], axis=0)
        if channels == "RGB_NIR":
            return np.stack([image[3], image[2], image[1], image[7]], axis=0)
    elif sensor == "PS":
        if image.shape[0] > 4:
            image = image[:4]
        if channels == "RGB":
            return np.stack([image[2], image[1], image[0]], axis=0)
        if channels == "RGB_NIR":
            return np.stack([image[2], image[1], image[0], image[3]], axis=0)
    elif sensor == "L8":
        # The reference's RGB/RGB_NIR paths for L8 are dead code guarded by
        # breakpoint() (floodplanet.py:501-509); we implement the evident
        # band order for completeness.
        if channels == "RGB":
            return np.stack([image[2], image[1], image[0]], axis=0)
        if channels == "RGB_NIR":
            return np.stack([image[2], image[1], image[0], image[3]], axis=0)
    raise NotImplementedError(
        f'No method to subselect {sensor} images with "{channels}" channel query.'
    )


def normalize_sensor_range(image: np.ndarray, sensor: str) -> np.ndarray:
    """Sensor-specific radiometric range normalization to (roughly) [0, 1]."""
    image = np.asarray(image)
    if sensor == "S1":
        out = np.clip((image.astype(np.float32) + 50.0) / 100.0, 0.0, 1.0)
        return np.nan_to_num(out)
    if sensor == "S2":
        return np.clip(image.astype(np.float32) / float(2**12), 0.0, 1.0)
    if sensor == "PS":
        if image.dtype == np.uint16:
            return image.astype(np.float32) / float(2**16)
        return image.astype(np.float32)
    if sensor == "L8":
        out = np.clip(image.astype(np.float32), 0.0, L8_MAX_REFLECTANCE)
        return out / np.float32(L8_MAX_REFLECTANCE)
    raise NotImplementedError(f'No normalization for sensor "{sensor}"')


# RGB visualization gammas per sensor (base_dataset.py:367-465).
_RGB_GAMMA = {"S2": 0.8, "L8": 0.8, "S1": 1.0, "PS": 0.6}

# (r, g, b) band indices into the *loaded* channel layout, keyed by
# (sensor, channels) — base_dataset.py:367-465.
_RGB_BANDS = {
    ("S2", "RGB"): (0, 1, 2),
    ("S2", "RGB_NIR"): (0, 1, 2),
    ("S2", "ALL"): (3, 2, 1),
    ("L8", "RGB"): (0, 1, 2),
    ("L8", "RGB_NIR"): (0, 1, 2),
    ("L8", "ALL"): (3, 2, 1),
    ("S1", "ALL"): (0, 1, 1),
    ("PS", "RGB"): (0, 1, 2),
    ("PS", "RGB_NIR"): (0, 1, 2),
    ("PS", "ALL"): (2, 1, 0),
}


def to_rgb(
    image: np.ndarray, sensor: str, channels: str = "ALL", gamma: float | None = None
) -> np.ndarray:
    """CHW multi-band image -> HW3 gamma-adjusted RGB visualization."""
    try:
        r, g, b = _RGB_BANDS[(sensor, channels)]
    except KeyError:
        raise NotImplementedError(
            f'No RGB mapping for sensor "{sensor}" channels "{channels}"'
        )
    if gamma is None:
        gamma = _RGB_GAMMA[sensor]
    bands = [image[r], image[g], image[b]]
    bands = [np.power(np.clip(band, 0.0, None), gamma) for band in bands]
    return np.stack(bands, axis=2)


def make_to_rgb_fn(sensor: str, channels: str = "ALL"):
    """Bound to_RGB callable, the analog of BaseDataset.to_RGB."""

    def _fn(image: np.ndarray, gamma: float | None = None) -> np.ndarray:
        return to_rgb(image, sensor, channels, gamma=gamma)

    return _fn
