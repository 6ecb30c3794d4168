"""FloodPlanet dataset: region discovery, splits, and tile loading.

The PyTorch port's own copy of ``floodplanet_code_tpu/data/dataset.py``
(Sen1Floods11 subclasses it in data/sen1floods11.py). It is plain numpy,
so the port keeps it as it is; OpenCV is imported only on the resize paths.

Mirrors the reference's Floodplanet_Dataset behavior
(st_water_seg/datasets/floodplanet.py:19-658) with a windowed data path:

- Scene discovery over ``<root>/CSDAP_complete/<region>/<sensor>/*.tif`` with
  labels at ``<region>/labels/<name>.tif`` (floodplanet.py:76-95).
- Leave-region-out or seeded random image-level splits
  (floodplanet.py:141-232).
- Tile enumeration via exact-mode crop slices over label-sized scenes
  (floodplanet.py:115-133).
- Per-tile load: sensor range normalization -> statistical normalization ->
  fixed-shape padding, exactly the reference's __getitem__ ordering
  (floodplanet.py:600-658) — but through *windowed* GeoTIFF reads plus a
  small LRU scene cache, instead of re-reading and resizing the whole scene
  for every tile (the reference's main inefficiency, floodplanet.py:605-609).
- Output arrays are NHWC numpy (image [H,W,C], target [H,W]); viewed as
  NCHW tensors they are already ``channels_last`` in memory, which is the
  layout the port's kernels read.

Augmentation is deliberately *not* applied here: training augmentation
runs batched on the device (data/augment.py).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from dataclasses import dataclass
from glob import glob
from typing import Any, List, Sequence

import numpy as np

from floodplanet_code_tpu_torch.data import sensors as sensor_lib
from floodplanet_code_tpu_torch.data.normalize import (
    binarize_label,
    load_global_norm_params,
    normalize_stats,
    pad_to_shape,
)
from floodplanet_code_tpu_torch.data.tiling import CropParams, ImageSlice, get_crop_slices
from floodplanet_code_tpu_torch.geo import tiff


@dataclass
class Example:
    """One (scene, tile) training example (reference floodplanet.py:124-135)."""

    image_path: str
    label_path: str
    region_name: str
    crop_params: CropParams


class FloodPlanetDataset:
    """Tiled multi-sensor flood segmentation dataset (CSDAP layout)."""

    # Raw label semantics (floodplanet.py:587-591).
    n_classes = 3

    def __init__(
        self,
        root_dir: str,
        split: str,
        slice_params: ImageSlice,
        eval_region: str | Sequence[str] | None = None,
        transforms: Any = None,
        sensor: str = "PS",
        channels: str | None = None,
        dset_name: str = "floodplanet",
        seed_num: int | None = 0,
        output_metadata: bool = False,
        norm_mode: str | None = None,
        dem: bool = False,
        slope: bool = False,
        preflood: bool = False,
        pre_post_difference: bool = False,
        hand: bool = False,
        ignore_index: int = -1,
        train_split_pct: float = 0.8,
        scene_cache_size: int = 256,
        scene_cache_bytes: int = 8 << 30,
        norm_param_path: str | None = None,
    ):
        if not 0 <= train_split_pct <= 1:
            raise ValueError(
                f"Train split pct must be between 0 and 1. Invalid value: {train_split_pct}"
            )
        self.root_dir = root_dir
        self.split = split
        self.slice_params = slice_params
        self.eval_region = eval_region
        self.transforms = transforms
        # Multi-sensor fusion: "PS+S1" stacks the band sets of several
        # sensors channel-wise per scene (heterogeneous per-sensor
        # radiometric normalization; an extension over the reference, which
        # is strictly single-sensor — BASELINE.json configs[2]).
        self.sensors = [s.strip() for s in sensor.split("+") if s.strip()]
        self.sensor = self.sensors[0]
        self.channels = channels or "ALL"
        self.dset_name = dset_name
        self.seed_num = seed_num
        self.output_metadata = output_metadata
        self.norm_mode = norm_mode
        self.dem = dem
        self.slope = slope
        self.preflood = preflood
        self.pre_post_difference = pre_post_difference
        self.hand = hand
        self.ignore_index = ignore_index
        self.train_split_pct = train_split_pct

        if dem or slope:
            raise NotImplementedError(
                f'DEM/slope auxiliary rasters are not published for "{dset_name}" '
                "(reference floodplanet.py:105-113 raises likewise)."
            )

        self.global_norm_params = None
        if self.norm_mode == "global":
            self.global_norm_params = load_global_norm_params(
                self.dset_name, norm_param_path
            )

        self._rng = np.random.default_rng(seed_num if seed_num is not None else None)
        # LRU over decoded+resized scenes, bounded by count AND bytes. The
        # old count-8 default thrashed under shuffled training (40+ scene
        # epochs -> ~80% miss rate, each miss a full decode + Lanczos
        # resize; measured 12-19 tiles/s loader-bound vs 60+ compute-bound).
        self._scene_cache: OrderedDict[str, np.ndarray] = OrderedDict()
        self._scene_cache_size = scene_cache_size
        self._scene_cache_bytes = scene_cache_bytes
        self._scene_cache_used = 0
        self._cache_lock = threading.Lock()
        self._info_cache: dict = {}

        self._prepare_data()
        self.n_channels = sensor_lib.get_n_channels(
            self.sensor,
            self.channels,
            dem=dem,
            slope=slope,
            preflood=preflood,
            pre_post_difference=pre_post_difference,
            hand=hand,
        )
        if len(self.sensors) > 1:
            # Stacked-channel fusion: ms_image carries every sensor's bands.
            self.n_channels["ms_image"] = sum(
                sensor_lib.sensor_n_channels(s, self.channels)
                for s in self.sensors
            )
            if self.norm_mode == "global" and self.global_norm_params:
                combined = {
                    "mean": sum(
                        (list(self.global_norm_params[s]["mean"]) for s in self.sensors),
                        [],
                    ),
                    "std": sum(
                        (list(self.global_norm_params[s]["std"]) for s in self.sensors),
                        [],
                    ),
                }
                self.global_norm_params = dict(self.global_norm_params)
                self.global_norm_params["+".join(self.sensors)] = combined
                self.sensor_key = "+".join(self.sensors)
            else:
                self.sensor_key = self.sensor
        else:
            self.sensor_key = self.sensor

    # -- discovery / splits -------------------------------------------------

    def _prepare_data(self) -> None:
        region_dirs = sorted(
            glob(os.path.join(self.root_dir, "CSDAP_complete") + "/*/")
        )
        region_dirs_dict = {p.rstrip("/").split("/")[-1]: p for p in region_dirs}

        image_paths = self._split_data(region_dirs_dict)

        self.dataset: List[Example] = []
        n_images = 0
        n_skipped = 0
        kept_paths = []
        for image_path, region_name in image_paths:
            label_path = self._label_path(image_path)
            if not os.path.exists(label_path):
                # Scenes without labels are skipped with a warning (the
                # reference drops into pdb here, floodplanet.py:97-99).
                n_skipped += 1
                continue
            if len(self.sensors) > 1:
                # Multi-sensor fusion requires the same scene in every
                # sensor's directory.
                siblings = [
                    self._sibling_sensor_path(image_path, s)
                    for s in self.sensors[1:]
                ]
                if not all(os.path.exists(p) for p in siblings):
                    n_skipped += 1
                    continue
            label_info = tiff.info(label_path)
            label_height, label_width = label_info.height, label_info.width

            # Clamp the stride to the scene extent: scenes smaller than the
            # stride would otherwise fail step validation (the reference
            # would crash likewise; small scenes yield one remainder tile).
            stride = (
                min(self.slice_params.stride, label_height),
                min(self.slice_params.stride, label_width),
            )
            crops = get_crop_slices(
                label_height,
                label_width,
                self.slice_params.height,
                self.slice_params.width,
                stride,
                mode="exact",
            )
            for h0, w0, h, w in crops:
                self.dataset.append(
                    Example(
                        image_path=image_path,
                        label_path=label_path,
                        region_name=region_name,
                        crop_params=CropParams(
                            h0,
                            w0,
                            h,
                            w,
                            label_height,
                            label_width,
                            self.slice_params.height,
                            self.slice_params.width,
                        ),
                    )
                )
            n_images += 1
            kept_paths.append((image_path, region_name))
        if n_skipped:
            print(
                f"[dataset] warning: skipped {n_skipped} scenes with missing "
                f"labels ({self.split} split)"
            )
        if not self.dataset:
            raise ValueError(
                f"No labeled scenes for split '{self.split}' "
                f"(sensor {self.sensor}, root {self.root_dir})"
            )
        self.image_paths = kept_paths

    def _split_data(self, region_dirs: dict) -> List[tuple]:
        if not region_dirs:
            raise ValueError(
                f'No regions found for dataset "{self.dset_name}" and sensor '
                f'"{self.sensor}" under {self.root_dir}'
            )

        eval_region = self.eval_region
        if eval_region is not None:
            if isinstance(eval_region, str):
                eval_region = [eval_region]
            if not isinstance(eval_region, (list, tuple)):
                raise ValueError(
                    f"Eval regions variable is not a list but a {type(eval_region)}"
                )
            eval_region = list(eval_region)
            self.eval_region = eval_region

            region_names = list(region_dirs.keys())
            if self.split == "train":
                for region in eval_region:
                    if region not in region_names:
                        raise ValueError(
                            f"Eval region {region} not found in available "
                            f"regions {region_names}"
                        )
                region_dirs = {
                    name: path
                    for name, path in region_dirs.items()
                    if name not in eval_region
                }
            elif self.split in ("valid", "test"):
                region_dirs = {
                    name: region_dirs[name]
                    for name in eval_region
                    if name in region_dirs
                }
            elif self.split == "all":
                pass
            else:
                raise ValueError(
                    f'Cannot handle split "{self.split}" for splitting data by region.'
                )

        image_paths = []
        for region_name, region_dir in sorted(region_dirs.items()):
            paths = sorted(glob(os.path.join(region_dir, self.sensor, "*.tif")))
            for path in paths:
                image_paths.append((path, region_name))

        if self.eval_region is None:
            # Seeded image-level shuffle split (floodplanet.py:210-221).
            shuffle_rng = np.random.default_rng(
                self.seed_num if self.seed_num is not None else None
            )
            order = shuffle_rng.permutation(len(image_paths))
            image_paths = [image_paths[i] for i in order]
            n_train = int(len(image_paths) * self.train_split_pct)
            if self.split == "train":
                image_paths = image_paths[:n_train]
            elif self.split == "all":
                pass
            else:
                image_paths = image_paths[n_train:]

        if not image_paths:
            raise ValueError(
                f'No images found for eval regions "{self.eval_region}" and '
                f'sensor "{self.sensor}"'
            )
        return image_paths

    # -- loading ------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.dataset)

    def _tiff_info(self, path: str):
        """Memoized tiff.info — header parse per (path) instead of per crop."""
        nfo = self._info_cache.get(path)
        if nfo is None:
            nfo = tiff.info(path)
            self._info_cache[path] = nfo
        return nfo

    def _cache_get(self, key: str) -> np.ndarray | None:
        with self._cache_lock:
            value = self._scene_cache.get(key)
            if value is not None:
                self._scene_cache.move_to_end(key)
            return value

    def _cache_put(self, key: str, value: np.ndarray) -> None:
        with self._cache_lock:
            if key not in self._scene_cache:
                self._scene_cache[key] = value
                self._scene_cache_used += value.nbytes
                while self._scene_cache and (
                    len(self._scene_cache) > self._scene_cache_size
                    or self._scene_cache_used > self._scene_cache_bytes
                ):
                    _, evicted = self._scene_cache.popitem(last=False)
                    self._scene_cache_used -= evicted.nbytes

    def _load_scene_resized(
        self, image_path: str, target_hw: tuple, sensor: str | None = None
    ) -> np.ndarray:
        """Full scene, resized to label dims, range-normalized; LRU-cached.

        Only used when scene dims differ from label dims (e.g. S1 scenes are
        lower resolution than their labels). The cache fixes the reference's
        per-tile full re-read + Lanczos resize (floodplanet.py:605-609).
        """
        sensor = sensor or self.sensor
        key = f"{image_path}@{target_hw[0]}x{target_hw[1]}@{self.channels}"
        cached = self._cache_get(key)
        if cached is not None:
            return cached
        raw = tiff.imread(image_path)
        if raw.ndim == 2:
            raw = raw[None]
        # Native reader always returns band-sequential CHW, so no HWC
        # heuristic is needed here (cf. reference floodplanet.py:320-324).
        raw = sensor_lib.select_channels(raw, sensor, self.channels)
        # Lanczos resize to label dims, matching resize_image's default
        # (utils_image.py:11-54); cv2 wants HWC. OpenCV is imported only
        # on this path: same-size scenes never need it.
        import cv2

        th, tw = target_hw
        hwc = np.transpose(raw, (1, 2, 0)).astype(np.float32)
        resized = cv2.resize(hwc, dsize=(tw, th), interpolation=cv2.INTER_LANCZOS4)
        if resized.ndim == 2:
            resized = resized[:, :, None]
        chw = np.ascontiguousarray(np.transpose(resized, (2, 0, 1)))
        chw = sensor_lib.normalize_sensor_range(chw, sensor)
        self._cache_put(key, chw)
        return chw

    def _label_path(self, image_path: str) -> str:
        """Label path convention: <region>/labels/<image_name>.tif
        (reference floodplanet.py:94-95). Subclasses override."""
        image_name = os.path.splitext(os.path.basename(image_path))[0]
        region_dir = os.path.dirname(os.path.dirname(image_path))
        return os.path.join(region_dir, "labels", image_name + ".tif")

    def _binarize(self, label: np.ndarray) -> np.ndarray:
        """Raw label values -> {0 dry, 1 flood, ignore} (CSDAP semantics:
        raw {0 nodata, 1 dry, 2 flood}). Subclasses override."""
        return binarize_label(label, self.ignore_index)

    def _sibling_sensor_path(self, image_path: str, sensor: str) -> str:
        """Path of the same scene under another sensor's directory."""
        region_dir = os.path.dirname(os.path.dirname(image_path))
        return os.path.join(region_dir, sensor, os.path.basename(image_path))

    def _load_crop_norm_single(
        self, image_path: str, crop_params: CropParams, sensor: str
    ) -> np.ndarray:
        """Range-normalized CHW crop of one sensor's scene at label resolution."""
        nfo = self._tiff_info(image_path)
        scene_h, scene_w = nfo.height, nfo.width
        want_h, want_w = crop_params.og_height, crop_params.og_width
        if (scene_h, scene_w) == (want_h, want_w):
            # Fast path: windowed read of exactly the crop.
            window = tiff.read_window(
                image_path,
                crop_params.h0,
                crop_params.w0,
                crop_params.height,
                crop_params.width,
            )
            if window.ndim == 2:
                window = window[None]
            window = sensor_lib.select_channels(window, sensor, self.channels)
            return sensor_lib.normalize_sensor_range(window, sensor)
        scene = self._load_scene_resized(image_path, (want_h, want_w), sensor)
        return scene[:, crop_params.h0 : crop_params.hE, crop_params.w0 : crop_params.wE]

    def _load_crop_norm_image(
        self, image_path: str, crop_params: CropParams
    ) -> np.ndarray:
        """CHW crop; multi-sensor configs stack every sensor's bands
        (each with its own radiometric normalization)."""
        parts = [
            self._load_crop_norm_single(
                image_path if s == self.sensors[0]
                else self._sibling_sensor_path(image_path, s),
                crop_params,
                s,
            )
            for s in self.sensors
        ]
        if len(parts) == 1:
            return parts[0]
        return np.concatenate(parts, axis=0)

    def _load_label_image(
        self, label_path: str, crop_params: CropParams
    ) -> np.ndarray:
        """Binarized label crop; labels are already at scene resolution.

        The full binarized label plane is LRU-cached (a few MB per scene):
        under shuffled training every crop otherwise pays a windowed
        strip decode, which dominated the loader once images were cached.
        """
        nfo = self._tiff_info(label_path)
        if (nfo.height, nfo.width) == (crop_params.og_height, crop_params.og_width):
            key = f"label@{label_path}"
            cached = self._cache_get(key)
            if cached is None:
                cached = self._binarize(tiff.imread(label_path))
                self._cache_put(key, cached)
            return cached[
                crop_params.h0 : crop_params.hE, crop_params.w0 : crop_params.wE
            ]
        else:
            import cv2

            label = tiff.imread(label_path)
            label = cv2.resize(
                label,
                dsize=(crop_params.og_width, crop_params.og_height),
                interpolation=cv2.INTER_NEAREST,
            )
            label = label[
                crop_params.h0 : crop_params.hE, crop_params.w0 : crop_params.wE
            ]
        return self._binarize(label)

    def load_example(self, index: int, output_metadata: bool | None = None) -> dict:
        """Load one fixed-shape example (reference __getitem__, floodplanet.py:600).

        Returns:
            image: float32 [H, W, C] (NHWC for the TPU path)
            target: int32 [H, W]
            mean, std: float32 [1, 1, C]
            metadata (optional): image_path / crop_params / region_name
        """
        if output_metadata is None:
            output_metadata = self.output_metadata
        example = self.dataset[index]
        crop_params = example.crop_params

        image = self._load_crop_norm_image(example.image_path, crop_params)
        target = self._load_label_image(example.label_path, crop_params)

        image, mean, std = normalize_stats(
            image,
            self.norm_mode,
            global_params=self.global_norm_params,
            input_type=self.sensor_key,
        )

        image = pad_to_shape(
            image, crop_params.max_crop_height, crop_params.max_crop_width
        )
        target = pad_to_shape(
            target,
            crop_params.max_crop_height,
            crop_params.max_crop_width,
            constant_value=self.ignore_index,
        )

        output = {
            "image": np.ascontiguousarray(
                np.transpose(image, (1, 2, 0)), dtype=np.float32
            ),
            "target": target.astype(np.int32),
            "mean": np.transpose(mean, (1, 2, 0)).astype(np.float32),
            "std": np.transpose(std, (1, 2, 0)).astype(np.float32),
        }
        if output_metadata:
            output["metadata"] = {
                "image_path": example.image_path,
                "crop_params": crop_params,
                "region_name": example.region_name,
            }
        return output

    def load_batch(
        self, indices: Sequence[int], output_metadata: bool | None = None
    ) -> list[dict]:
        """Load many examples, batching windowed reads through one native
        call (geo.tiff.read_windows_batch — C++ thread pool, single GIL
        release). Scenes needing the resize path fall back to per-example
        loading through the scene cache.
        """
        if output_metadata is None:
            output_metadata = self.output_metadata
        fast: list[int] = []
        results: dict[int, dict] = {}
        multi_sensor = len(self.sensors) > 1
        for pos, index in enumerate(indices):
            example = self.dataset[index]
            nfo = tiff.info(example.image_path)
            cp = example.crop_params
            if not multi_sensor and (nfo.height, nfo.width) == (
                cp.og_height,
                cp.og_width,
            ):
                fast.append(pos)
            else:
                results[pos] = self.load_example(index, output_metadata)

        if fast:
            paths, windows = [], []
            for pos in fast:
                example = self.dataset[indices[pos]]
                cp = example.crop_params
                # interleave image and label reads in one native batch
                paths.append(example.image_path)
                windows.append((cp.h0, cp.w0, cp.height, cp.width))
                paths.append(example.label_path)
                windows.append((cp.h0, cp.w0, cp.height, cp.width))
            raw = tiff.read_windows_batch(paths, windows)
            for slot, pos in enumerate(fast):
                example = self.dataset[indices[pos]]
                cp = example.crop_params
                window = raw[2 * slot]
                if window.ndim == 2:
                    window = window[None]
                window = sensor_lib.select_channels(
                    window, self.sensor, self.channels
                )
                image = sensor_lib.normalize_sensor_range(window, self.sensor)
                target = self._binarize(raw[2 * slot + 1])
                image, mean, std = normalize_stats(
                    image,
                    self.norm_mode,
                    global_params=self.global_norm_params,
                    input_type=self.sensor_key,
                )
                image = pad_to_shape(
                    image, cp.max_crop_height, cp.max_crop_width
                )
                target = pad_to_shape(
                    target,
                    cp.max_crop_height,
                    cp.max_crop_width,
                    constant_value=self.ignore_index,
                )
                out = {
                    "image": np.ascontiguousarray(
                        np.transpose(image, (1, 2, 0)), dtype=np.float32
                    ),
                    "target": target.astype(np.int32),
                    "mean": np.transpose(mean, (1, 2, 0)).astype(np.float32),
                    "std": np.transpose(std, (1, 2, 0)).astype(np.float32),
                }
                if output_metadata:
                    out["metadata"] = {
                        "image_path": example.image_path,
                        "crop_params": cp,
                        "region_name": example.region_name,
                    }
                results[pos] = out
        return [results[pos] for pos in range(len(indices))]

    # Indexing alias for API familiarity with the reference dataset.
    def __getitem__(self, index: int, output_metadata: bool | None = None) -> dict:
        return self.load_example(index, output_metadata)

    def to_RGB(self, image: np.ndarray, gamma: float | None = None) -> np.ndarray:
        """CHW multi-band -> HW3 RGB (reference base_dataset.py:467-492).

        Multi-sensor stacks visualize through the primary sensor's band
        mapping (its channels come first in the stack)."""
        return sensor_lib.to_rgb(image, self.sensor, self.channels, gamma=gamma)


def _sen1floods11():
    from floodplanet_code_tpu_torch.data.sen1floods11 import Sen1Floods11Dataset

    return Sen1Floods11Dataset


DATASETS = {
    "floodplanet": FloodPlanetDataset,
    "sen1floods11": _sen1floods11,
}


def build_dataset(dset_name: str, split: str, slice_params: ImageSlice, **kwargs):
    """Dataset factory (reference datasets/__init__.py:33-50).

    Unlike the reference's build_model twin (quirk SURVEY.md §7.2), unknown
    names raise cleanly.
    """
    try:
        dataset_cls = DATASETS[dset_name]
    except KeyError:
        raise KeyError(
            f'Dataset "{dset_name}" not found. Available: {sorted(DATASETS)}'
        )
    if not isinstance(dataset_cls, type):  # lazy-import entries
        dataset_cls = dataset_cls()
    root_dir = kwargs.pop("root_dir", None)
    if root_dir is None:
        from floodplanet_code_tpu_torch.config import get_dataset_root

        root_dir = get_dataset_root(dset_name)
    return dataset_cls(root_dir, split, slice_params, dset_name=dset_name, **kwargs)
