"""Sen1Floods11 dataset (hand-labeled chips layout): the port's copy of
``floodplanet_code_tpu/data/sen1floods11.py``.

The public Sen1Floods11 v1.1 hand-labeled layout:

    <root>/[v1.1/data/flood_events/HandLabeled/]
        S1Hand/<Region>_<id>_S1Hand.tif      (VV, VH in dB; float32)
        S2Hand/<Region>_<id>_S2Hand.tif      (13 L1C bands; uint16)
        LabelHand/<Region>_<id>_LabelHand.tif ({-1 nodata, 0 dry, 1 water})

Region (flood event) = filename prefix before the first underscore; the
same leave-region-out / random-split semantics as FloodPlanetDataset apply,
so the 11-fold cross-validation recipe runs with ``dataset.name=sen1floods11``.

Differences from the CSDAP loader, both handled by the base-class hooks
(which the host loader and the HBM scene cache, data/device_cache.py, read
through):
- label convention {-1, 0, 1} (CSDAP: {0, 1, 2}) -> ``_binarize``;
- flat chip directories keyed by sensor suffix -> ``_split_data`` /
  ``_label_path`` / ``_sibling_sensor_path``.
"""

from __future__ import annotations

import os
from glob import glob
from typing import List

import numpy as np

from floodplanet_code_tpu_torch.data.dataset import FloodPlanetDataset

_SENSOR_DIRS = {"S1": "S1Hand", "S2": "S2Hand"}


class Sen1Floods11Dataset(FloodPlanetDataset):
    """Tiled Sen1Floods11 hand-labeled chips."""

    # S2Hand chips carry all 13 L1C bands (CSDAP S2 scenes have 10).
    _S2_ALL_BANDS = 13

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.channels == "ALL":
            n = 0
            for s in self.sensors:
                n += self._S2_ALL_BANDS if s == "S2" else (2 if s == "S1" else 0)
            self.n_channels["ms_image"] = n

    def _hand_labeled_root(self) -> str:
        nested = os.path.join(self.root_dir, "v1.1", "data", "flood_events", "HandLabeled")
        if os.path.isdir(nested):
            return nested
        return self.root_dir

    def _sensor_dir(self, sensor: str | None = None) -> str:
        sensor = sensor or self.sensor
        try:
            return _SENSOR_DIRS[sensor]
        except KeyError:
            raise ValueError(
                f'Sen1Floods11 has no "{sensor}" modality; '
                f"available: {sorted(_SENSOR_DIRS)}"
            )

    def _split_data(self, region_dirs: dict) -> List[tuple]:
        # region_dirs is unused: chips live in one flat directory with the
        # flood event encoded in the filename.
        del region_dirs
        base = self._hand_labeled_root()
        paths = sorted(glob(os.path.join(base, self._sensor_dir(), "*.tif")))
        if not paths:
            raise ValueError(f"No Sen1Floods11 {self._sensor_dir()} chips under {base}")
        by_region: dict[str, list[str]] = {}
        for path in paths:
            region = os.path.basename(path).split("_")[0]
            by_region.setdefault(region, []).append(path)

        eval_region = self.eval_region
        if eval_region is not None:
            if isinstance(eval_region, str):
                eval_region = [eval_region]
            eval_region = list(eval_region)
            self.eval_region = eval_region
            if self.split == "train":
                for region in eval_region:
                    if region not in by_region:
                        raise ValueError(
                            f"Eval region {region} not found in available "
                            f"regions {sorted(by_region)}"
                        )
                keep = {r: p for r, p in by_region.items() if r not in eval_region}
            elif self.split in ("valid", "test"):
                keep = {r: by_region[r] for r in eval_region if r in by_region}
            elif self.split == "all":
                keep = by_region
            else:
                raise ValueError(
                    f'Cannot handle split "{self.split}" for splitting data by region.'
                )
            image_paths = [(p, r) for r in sorted(keep) for p in keep[r]]
        else:
            image_paths = [(p, r) for r in sorted(by_region) for p in by_region[r]]
            shuffle_rng = np.random.default_rng(
                self.seed_num if self.seed_num is not None else None
            )
            order = shuffle_rng.permutation(len(image_paths))
            image_paths = [image_paths[i] for i in order]
            n_train = int(len(image_paths) * self.train_split_pct)
            if self.split == "train":
                image_paths = image_paths[:n_train]
            elif self.split != "all":
                image_paths = image_paths[n_train:]

        if not image_paths:
            raise ValueError(
                f'No images found for eval regions "{self.eval_region}" and '
                f'sensor "{self.sensor}"'
            )
        return image_paths

    def _label_path(self, image_path: str) -> str:
        name = os.path.basename(image_path).replace(
            f"_{self._sensor_dir()}.tif", "_LabelHand.tif"
        )
        base = os.path.dirname(os.path.dirname(image_path))
        return os.path.join(base, "LabelHand", name)

    def _sibling_sensor_path(self, image_path: str, sensor: str) -> str:
        other = self._sensor_dir(sensor)
        name = os.path.basename(image_path).replace(
            f"_{self._sensor_dir()}.tif", f"_{other}.tif"
        )
        base = os.path.dirname(os.path.dirname(image_path))
        return os.path.join(base, other, name)

    def _binarize(self, label: np.ndarray) -> np.ndarray:
        """Sen1Floods11 raw {-1 nodata, 0 dry, 1 water} -> {0, 1, ignore}."""
        label = label.astype(np.int16)
        return np.where(label == -1, np.int16(self.ignore_index), label)
