"""The port's HBM scene cache (data/device_cache.py) against the JAX
package's and against the port's own host loader, on the CPU.

Tolerances (relative to the batch's largest value, at least 1): against
the host loader, bit-identical with norm_mode null or global, within 1e-6
with local (numpy's f32 pairwise sums on the host, f64 sums rounded once
here). Against JAX's builder, targets equal and images, means and standard
deviations within 1e-6 with null and global; with local, JAX's own
statistics are f32 sums in XLA that sit ~1e-5 from the host's on a
near-constant band (its tests hold it to the host at 1e-4), so the port
is held to JAX within JAX's distance from the host plus 1e-6.
"""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodplanet_code_tpu.data import build_dataset as jax_build_dataset
from floodplanet_code_tpu.data import generate_image_slice_object as jax_slices
from floodplanet_code_tpu.data.device_cache import build_device_cache as jax_build_cache
from floodplanet_code_tpu.data.device_cache import make_batch_builder as jax_builder
from floodplanet_code_tpu_torch.data import BatchLoader, build_dataset, generate_image_slice_object
from floodplanet_code_tpu_torch.data.device_cache import build_device_cache, make_batch_builder

CROP = 64  # 96x128 scenes: ragged remainder tiles at the bottom and right
NORM_MODES = [None, "local", "global"]


@pytest.fixture(scope="module")
def norm_params(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("norm") / "dataset_norm_params.json")
    with open(path, "w") as handle:
        json.dump({"floodplanet": {"S1": {"mean": [0.3, -0.2], "std": [0.7, 1.9]}}}, handle)
    return path


def _kwargs(root, norm_mode, norm_params):
    return dict(root_dir=root, sensor="S1", eval_region="RegionB", ignore_index=2,
                norm_mode=norm_mode, norm_param_path=norm_params)


def _datasets(root, norm_mode, norm_params):
    kw = _kwargs(root, norm_mode, norm_params)
    return (jax_build_dataset("floodplanet", "train", jax_slices(CROP, CROP, CROP), **kw),
            build_dataset("floodplanet", "train", generate_image_slice_object(CROP, CROP, CROP),
                          **kw))


def _dist(got, want) -> float:
    """max |got - want| over max(max|want|, 1)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1.0))


def _close(got, want, tol=1e-6):
    assert _dist(got, want) <= tol


@pytest.mark.parametrize("norm_mode", NORM_MODES, ids=["null", "local", "global"])
def test_builder_matches_jax(synthetic_csdap_root, norm_params, norm_mode):
    jds, ds = _datasets(synthetic_csdap_root, norm_mode, norm_params)
    jcache, cache = jax_build_cache(jds), build_device_cache(ds, device="cpu")
    indices = np.arange(len(ds))
    rows = cache.index_rows(ds, indices)
    np.testing.assert_array_equal(rows, jcache.index_rows(jds, indices))
    assert cache.nbytes == jcache.nbytes
    want = jax_builder(jcache)(jnp.asarray(rows))
    got = make_batch_builder(cache)(rows)
    host = [jds.load_example(int(i)) for i in indices]
    for key in ("image", "mean", "std"):
        assert got[key].dtype == torch.float32
        slack = 0.0
        if norm_mode == "local":
            slack = _dist(want[key], np.stack([h[key] for h in host]))
        _close(got[key].numpy(), want[key], slack + 1e-6)
    assert got["target"].dtype == torch.int32
    np.testing.assert_array_equal(got["target"].numpy(), np.asarray(want["target"]))


@pytest.mark.parametrize("norm_mode", NORM_MODES, ids=["null", "local", "global"])
def test_builder_matches_the_host_loader(synthetic_csdap_root, norm_params, norm_mode):
    _, ds = _datasets(synthetic_csdap_root, norm_mode, norm_params)
    cache = build_device_cache(ds, device="cpu")
    build = make_batch_builder(cache)
    loader = BatchLoader(ds, batch_size=4, shuffle=True, drop_last=True, n_workers=2, seed=3)
    order = np.random.default_rng((3, 0)).permutation(len(ds))
    edges = 0
    for k, want in enumerate(loader):
        idx = order[4 * k : 4 * k + 4]
        edges += sum(ds.dataset[i].crop_params.height < CROP
                     or ds.dataset[i].crop_params.width < CROP for i in idx)
        got = build(cache.index_rows(ds, idx))
        for key in ("image", "target", "mean", "std"):
            g = got[key].numpy()
            assert g.dtype == want[key].dtype and g.shape == want[key].shape, key
            if norm_mode == "local" and key != "target":
                _close(g, want[key], 1e-6)
            else:
                np.testing.assert_array_equal(g, want[key], err_msg=key)
    assert edges > 0  # the ragged remainder tiles were among them


def test_over_budget_returns_none(synthetic_csdap_root, capsys):
    _, ds = _datasets(synthetic_csdap_root, None, None)
    assert build_device_cache(ds, max_bytes=1000, device="cpu") is None
    assert "exceed tpu.device_data_bytes" in capsys.readouterr().out


def test_missing_label_raster_returns_none(synthetic_csdap_root, tmp_path, capsys):
    root = str(tmp_path / "copy")
    shutil.copytree(synthetic_csdap_root, root)
    _, ds = _datasets(root, None, None)
    label = ds._label_path(ds.dataset[0].image_path)
    os.remove(label)
    assert build_device_cache(ds, device="cpu") is None
    assert "has no label raster" in capsys.readouterr().out


def test_needs_a_card_unless_cpu(synthetic_csdap_root, monkeypatch):
    _, ds = _datasets(synthetic_csdap_root, None, None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_device_cache(ds)
