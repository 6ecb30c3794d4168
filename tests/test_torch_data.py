"""The port's copy of the host data layer against the JAX package's.

Both read the same synthetic CSDAP tree (tests/conftest.py); arrays must be
bit-identical, since the copies run the same numpy code.
"""

import glob
import os

import numpy as np
import pytest

from floodplanet_code_tpu.data import build_dataset as jax_build_dataset
from floodplanet_code_tpu.data import generate_image_slice_object as jax_slices
from floodplanet_code_tpu.geo import tiff as jax_tiff
from floodplanet_code_tpu_torch.data import build_dataset, generate_image_slice_object
from floodplanet_code_tpu_torch.geo import tiff


def test_port_builds_its_own_tiff_library():
    lib = tiff.load_library()
    assert os.path.dirname(lib._name) == os.path.join(
        os.path.dirname(tiff.__file__), "native"
    )


def test_imread_identical(synthetic_csdap_root):
    paths = sorted(
        glob.glob(os.path.join(synthetic_csdap_root, "CSDAP_complete", "*", "*", "*.tif"))
    )
    assert paths
    for path in paths:
        got, want = tiff.imread(path), jax_tiff.imread(path)
        assert got.dtype == want.dtype and np.array_equal(got, want), path
        assert tiff.read_window(path, 3, 5, 17, 9).tolist() == (
            jax_tiff.read_window(path, 3, 5, 17, 9).tolist()
        )


def test_imwrite_keeps_geo_tags(synthetic_csdap_root, tmp_path):
    src = sorted(glob.glob(os.path.join(synthetic_csdap_root, "CSDAP_complete", "*", "PS", "*.tif")))[0]
    jax_out, out = str(tmp_path / "jax.tif"), str(tmp_path / "port.tif")
    mask = (np.arange(96 * 128).reshape(96, 128) % 2 * 255).astype(np.uint8)
    jax_tiff.imwrite(jax_out, mask, geo_from=src)
    tiff.imwrite(out, mask, geo_from=src)
    with open(jax_out, "rb") as a, open(out, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("crop,stride", [(32, 16), (40, 40)])
def test_dataset_matches(synthetic_csdap_root, crop, stride):
    kw = dict(
        sensor="PS", eval_region="RegionA", ignore_index=0, output_metadata=True,
        root_dir=synthetic_csdap_root,
    )
    want = jax_build_dataset("floodplanet", "test", jax_slices(crop, stride=stride), **kw)
    got = build_dataset(
        "floodplanet", "test", generate_image_slice_object(crop, stride=stride), **kw
    )
    assert len(got) == len(want) and got.n_channels == want.n_channels
    assert [vars(e.crop_params) for e in got.dataset] == [
        vars(e.crop_params) for e in want.dataset
    ]
    for i in (0, len(got) // 2, len(got) - 1):
        a, b = got.load_example(i), want.load_example(i)
        for key in ("image", "target", "mean", "std"):
            assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key
    idx = list(range(min(5, len(got))))
    for a, b in zip(got.load_batch(idx), want.load_batch(idx)):
        for key in ("image", "target"):
            assert np.array_equal(a[key], b[key]), key
