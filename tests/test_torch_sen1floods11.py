"""The port's Sen1Floods11 dataset (data/sen1floods11.py) against the JAX
package's, on synthetic hand-labeled chips (tests/conftest.py).

Splits and tile lists must be equal; examples (image, target, mean, std)
equal within 1e-6 for S1 (dB), S2 (13 L1C bands) and their stack; the HBM
scene cache (data/device_cache.py) must read chips and labels through the
subclass's hooks: its batches equal the host loader's, the {-1, 0, 1}
label convention mapped to ``ignore_index``.
"""

import numpy as np
import pytest

from floodplanet_code_tpu.data import build_dataset as jax_build_dataset
from floodplanet_code_tpu.data import generate_image_slice_object as jax_slices
from floodplanet_code_tpu_torch.data import DATASETS, build_dataset, generate_image_slice_object
from floodplanet_code_tpu_torch.data.device_cache import build_device_cache, cache_batches
from floodplanet_code_tpu_torch.data.sen1floods11 import Sen1Floods11Dataset

CROP = 64


def _both(split, root, stride=CROP, **kw):
    kw.setdefault("sensor", "S1")
    kw.setdefault("ignore_index", -1)
    jds = jax_build_dataset("sen1floods11", split, jax_slices(CROP, stride=stride),
                            root_dir=root, **kw)
    tds = build_dataset("sen1floods11", split, generate_image_slice_object(CROP, stride=stride),
                        root_dir=root, **kw)
    return jds, tds


def _tiles(ds):
    return [(e.image_path, e.label_path, e.region_name, tuple(vars(e.crop_params).values()))
            for e in ds.dataset]


@pytest.mark.parametrize("split,kw", [
    ("train", {"eval_region": "Bolivia"}),
    ("test", {"eval_region": ["Bolivia", "Mekong"]}),
    ("all", {"eval_region": "Ghana"}),
    ("train", {"train_split_pct": 0.5, "seed_num": 3}),
    ("valid", {"train_split_pct": 0.5, "seed_num": 3}),
    ("all", {"sensor": "S2"}),
], ids=["lro-train", "lro-test", "lro-all", "random-train", "random-valid", "s2-all"])
def test_splits_match_jax(synthetic_s1f11_root, split, kw):
    jds, tds = _both(split, synthetic_s1f11_root, stride=32, **kw)
    assert isinstance(tds, Sen1Floods11Dataset)
    assert _tiles(tds) == _tiles(jds) and len(tds) > 0
    assert tds.n_channels == jds.n_channels
    assert tds.image_paths == jds.image_paths


@pytest.mark.parametrize("sensor,norm_mode", [("S1", None), ("S2", None), ("S1+S2", None),
                                              ("S1", "local")])
def test_examples_match_jax(synthetic_s1f11_root, sensor, norm_mode):
    jds, tds = _both("all", synthetic_s1f11_root, stride=48, sensor=sensor,
                     norm_mode=norm_mode)
    assert tds.n_channels == jds.n_channels == {
        "S1": {"ms_image": 2}, "S2": {"ms_image": 13}, "S1+S2": {"ms_image": 15}}[sensor]
    indices = list(range(len(tds)))
    got_batch = tds.load_batch(indices)
    for i in indices:
        want = jds.load_example(i, output_metadata=False)
        for got in (tds.load_example(i, output_metadata=False), got_batch[i]):
            for key in ("image", "mean", "std"):
                assert got[key].shape == want[key].shape, key
                np.testing.assert_allclose(got[key], want[key], atol=1e-6, rtol=0, err_msg=key)
            np.testing.assert_array_equal(got["target"], want["target"])
    targets = np.stack([b["target"] for b in got_batch])
    assert set(np.unique(targets)) <= {-1, 0, 1} and (targets == -1).any()


@pytest.mark.parametrize("ignore_index", [-1, 2])
def test_cache_reads_through_the_hooks(synthetic_s1f11_root, ignore_index):
    """Scene-cache batches equal the host loader's, bit for bit, with the
    nodata label mapped to ``ignore_index`` on both paths."""
    ds = build_dataset("sen1floods11", "test", generate_image_slice_object(CROP, stride=48),
                       root_dir=synthetic_s1f11_root, sensor="S1", eval_region="Mekong",
                       ignore_index=ignore_index)
    cache = build_device_cache(ds, 1 << 30, "cpu")
    assert cache is not None and cache.images.shape[-1] == 2
    order = np.arange(len(ds))
    seen = 0
    for batch, idx, n_real in cache_batches(cache, ds, 4, order):
        want = ds.load_batch(list(idx))
        for key in ("image", "target", "mean", "std"):
            np.testing.assert_array_equal(batch[key].numpy(), np.stack([w[key] for w in want]),
                                          err_msg=key)
        assert (batch["target"][:n_real] == ignore_index).any()
        assert set(batch["target"].unique().tolist()) <= {0, 1, ignore_index}
        seen += n_real
    assert seen == len(ds)


def test_registered():
    assert sorted(DATASETS) == ["floodplanet", "sen1floods11"]
    with pytest.raises(ValueError, match="no \"L8\" modality"):
        build_dataset("sen1floods11", "all", generate_image_slice_object(CROP),
                      root_dir="/nonexistent", sensor="L8")
