"""The slice as a whole: the port's sliding-window inference and ``infer``
against the JAX package's, with the same weights on the same scenes.

Base-8 EF-UNet, 32 px crops, f32. Stitched probabilities per scene must
agree within 1e-4 (the two frameworks sum convolutions in different
orders); masks written by the port's ``infer`` must equal the JAX
probabilities' ``minimum(argmax, 1) * 255`` on >= 99.9% of pixels (a pixel
whose two top classes tie within that noise may flip) and carry the
source scene's geo tags.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from PIL.TiffImagePlugin import ImageFileDirectory_v2

from conftest import make_synthetic_csdap
from floodplanet_code_tpu.data import build_dataset as jax_build_dataset
from floodplanet_code_tpu.data import generate_image_slice_object as jax_slices
from floodplanet_code_tpu.inference import sliding as jax_sliding
from floodplanet_code_tpu.models import build_model as jax_build_model
from floodplanet_code_tpu_torch.config import Config
from floodplanet_code_tpu_torch.data import build_dataset, generate_image_slice_object
from floodplanet_code_tpu_torch.geo import tiff
from floodplanet_code_tpu_torch.inference.infer import build_infer_dataset, infer
from floodplanet_code_tpu_torch.inference.sliding import sliding_window_predict
from floodplanet_code_tpu_torch.models import build_model
from floodplanet_code_tpu_torch.tools.import_jax_params import (
    save_weights,
    seeded_flax_variables,
    state_dict_from_flax,
)

CROP = 32
BASE = 8


def _geo_source(path):
    """A tiny GeoTIFF carrying pixel scale, tie point and geo keys."""
    ifd = ImageFileDirectory_v2()
    for tag, typ, value in (
        (33550, 12, (3.0, 3.0, 0.0)),
        (33922, 12, (0.0, 0.0, 0.0, 500000.0, 4100000.0, 0.0)),
        (34735, 3, (1, 1, 0, 1, 1024, 0, 1, 1)),
    ):
        ifd[tag] = value
        ifd.tagtype[tag] = typ
    Image.fromarray(np.zeros((4, 4), np.uint8)).save(path, tiffinfo=ifd)
    return path


@pytest.fixture(scope="module")
def geo_root(tmp_path_factory):
    """RegionA of the synthetic CSDAP tree, PS scenes re-written with geo
    tags so masks can show they carry them over."""
    root = str(tmp_path_factory.mktemp("geo_csdap"))
    make_synthetic_csdap(root, regions=("RegionA",), sensors=("PS",))
    src = _geo_source(os.path.join(root, "geo.tif"))
    for path in glob.glob(os.path.join(root, "CSDAP_complete", "*", "PS", "*.tif")):
        tiff.imwrite(path, tiff.imread(path), geo_from=src)
    return root


@pytest.fixture(scope="module")
def weights():
    variables = seeded_flax_variables(4, 3, base_feat_channels=BASE, seed=7)
    jmodel = jax_build_model("ef_model", {"ms_image": 4}, 3, base_feat_channels=BASE)
    tmodel = build_model("ef_model", {"ms_image": 4}, 3, base_feat_channels=BASE,
                         device="cpu")
    tmodel.load_state_dict(state_dict_from_flax(variables), strict=True)
    return jmodel, variables, tmodel


_JAX_STEPS = {}


def _jax_scenes(jmodel, variables, root, stride, tta):
    # One jitted step per tta setting, shared across strides (same shapes).
    if tta not in _JAX_STEPS:
        _JAX_STEPS[tta] = jax_sliding.make_predict_step(jmodel, tta=tta)
    ds = jax_build_dataset(
        "floodplanet", "test", jax_slices(CROP, stride=stride), sensor="PS",
        eval_region="RegionA", ignore_index=0, output_metadata=True, root_dir=root,
    )
    return {
        s["image_name"]: s["probabilities"]
        for s in jax_sliding.sliding_window_predict(
            jmodel, jax.tree.map(jnp.asarray, variables), ds, batch_size=8,
            n_workers=2, device_data_bytes=0, tta=tta,
            predict_step=_JAX_STEPS[tta],
        )
    }


@pytest.mark.parametrize("tta", [False, True])
@pytest.mark.parametrize("stride", [16, 32])
def test_stitched_probabilities_match_jax(geo_root, weights, stride, tta):
    jmodel, variables, tmodel = weights
    want = _jax_scenes(jmodel, variables, geo_root, stride, tta)
    ds = build_dataset(
        "floodplanet", "test", generate_image_slice_object(CROP, stride=stride),
        sensor="PS", eval_region="RegionA", ignore_index=0, output_metadata=True,
        root_dir=geo_root,
    )
    got = {
        s["image_name"]: s
        for s in sliding_window_predict(
            tmodel, ds, batch_size=8, n_workers=2, device="cpu", tta=tta
        )
    }
    assert sorted(got) == sorted(want) and len(got) == 2
    for name, scene in got.items():
        assert scene["region"] == "RegionA"
        assert scene["probabilities"].shape == (96, 128, 3)
        np.testing.assert_allclose(
            scene["probabilities"], want[name], atol=1e-4, rtol=0, err_msg=name
        )


def test_infer_writes_jax_masks_with_geo_tags(geo_root, weights, tmp_path):
    jmodel, variables, _ = weights
    want = _jax_scenes(jmodel, variables, geo_root, CROP, False)
    weights_path = str(tmp_path / "exp" / "weights" / "model.pt")
    os.makedirs(os.path.dirname(weights_path))
    save_weights(state_dict_from_flax(variables), weights_path)
    cfg = Config({
        "crop_height": CROP, "crop_width": CROP, "batch_size": 8, "n_workers": 2,
        "norm_mode": None, "eval_region": "RegionA", "ignore_index": 0,
        "seed_num": 0, "train_split_pct": 0.8,
        "dataset": {"name": "floodplanet", "sensor": "PS", "channels": "ALL",
                    "dataset_kwargs": {}},
        "model": {"name": "ef_model",
                  "model_kwargs": {"optimizer_name": "adam", "base_feat_channels": BASE}},
        "tpu": {"compute_dtype": "float32", "conv_impl": "pallas_fused",
                "inference_batch_size": 8},
    })
    ds = build_infer_dataset(cfg, "floodplanet", "test", root_dir=geo_root)
    written = infer(cfg, weights_path, "floodplanet", "test", str(tmp_path / "masks"),
                    dataset=ds, device="cpu")
    assert len(written) == 2
    for path in written:
        name = os.path.splitext(os.path.basename(path))[0]
        assert os.path.basename(os.path.dirname(path)) == "RegionA_pred"
        mask = tiff.imread(path)
        expected = np.minimum(want[name].argmax(-1), 1).astype(np.uint8) * 255
        assert mask.dtype == np.uint8 and mask.shape == expected.shape
        assert np.mean(mask == expected) >= 0.999
        source = os.path.join(geo_root, "CSDAP_complete", "RegionA", "PS", name + ".tif")
        with tiff.TiffFile(path) as got_tags, tiff.TiffFile(source) as src_tags:
            assert got_tags.geo_tags() and got_tags.geo_tags() == src_tags.geo_tags()


def test_entry_points_need_a_card_unless_cpu(monkeypatch, weights):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        next(sliding_window_predict(weights[2], None, batch_size=8))


def test_infer_cli_reads_a_jax_written_experiment(geo_root, weights, tmp_path, monkeypatch):
    """The CLI finds the config a JAX-package experiment wrote next to the
    weights file, and the key surface loads unchanged."""
    import json

    from floodplanet_code_tpu.config import compose, save_config
    from floodplanet_code_tpu_torch.inference.infer import main

    _, variables, _ = weights
    exp = tmp_path / "exp"
    save_config(compose(overrides=[
        "crop_height=32", "crop_width=32", "dataset.sensor=PS", "eval_region=RegionA",
        "n_workers=2", "model.model_kwargs.base_feat_channels=8",
        "tpu.conv_impl=pallas_fused", "tpu.compute_dtype=float32",
    ]), str(exp))
    os.makedirs(exp / "weights")
    save_weights(state_dict_from_flax(variables), str(exp / "weights" / "model.pt"))
    monkeypatch.chdir(tmp_path)  # dataset_dirs.json in the cwd wins
    (tmp_path / "dataset_dirs.json").write_text(json.dumps({"floodplanet": geo_root}))
    written = main([str(exp / "weights" / "model.pt"), "floodplanet", "test",
                    "--device", "cpu"])
    assert len(written) == 2
    assert all(p.startswith(str(exp / "inference" / "floodplanet" / "test")) for p in written)


@pytest.mark.parametrize("overrides", [["batch_size=8"], ["tpu.inference_batch_size=null"],
                                       ["tpu.inference_batch_size=5"]])
def test_inference_batch_size_matches_jax(overrides):
    from floodplanet_code_tpu.config import compose
    from floodplanet_code_tpu_torch.config import compose as port_compose
    from floodplanet_code_tpu_torch.inference.sliding import resolve_inference_batch_size

    want = jax_sliding.resolve_inference_batch_size(compose(overrides=overrides), 1)
    assert resolve_inference_batch_size(port_compose(overrides=overrides)) == want


def test_cache_path_matches_host_path_and_jax(geo_root, weights):
    """Serving through the HBM scene cache: the same probabilities as the
    port's host loader (bit for bit on the CPU: the same batches reach the
    same forward) and as the JAX package's cache path."""
    jmodel, variables, tmodel = weights
    jds = jax_build_dataset(
        "floodplanet", "test", jax_slices(CROP, stride=16), sensor="PS",
        eval_region="RegionA", ignore_index=0, output_metadata=True, root_dir=geo_root,
    )
    want = {s["image_name"]: s["probabilities"] for s in jax_sliding.sliding_window_predict(
        jmodel, jax.tree.map(jnp.asarray, variables), jds, batch_size=8, n_workers=2)}
    ds = build_dataset(
        "floodplanet", "test", generate_image_slice_object(CROP, stride=16), sensor="PS",
        eval_region="RegionA", ignore_index=0, output_metadata=True, root_dir=geo_root,
    )
    got = {}
    for budget in (6 << 30, 0):
        got[budget] = {s["image_name"]: s["probabilities"] for s in sliding_window_predict(
            tmodel, ds, batch_size=8, n_workers=2, device="cpu", device_data_bytes=budget)}
    assert sorted(got[0]) == sorted(got[6 << 30]) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[6 << 30][name], got[0][name])
        np.testing.assert_allclose(got[6 << 30][name], want[name], atol=1e-6, rtol=0)


@pytest.mark.parametrize("ema", [False, True], ids=["params", "ema"])
def test_infer_from_a_checkpoint_directory(geo_root, weights, tmp_path, monkeypatch, ema):
    """``infer`` on a directory written by the port's CheckpointManager
    writes the masks the equivalent weights file gives (with an EMA, the
    EMA weights); the CLI finds the experiment's config two levels above."""
    import json

    from floodplanet_code_tpu_torch.config import compose as port_compose
    from floodplanet_code_tpu_torch.config import save_config
    from floodplanet_code_tpu_torch.inference.infer import main
    from floodplanet_code_tpu_torch.train import create_train_state
    from floodplanet_code_tpu_torch.train.checkpoint import MONITOR_KEY, CheckpointManager

    _, variables, _ = weights
    model = build_model("ef_model", {"ms_image": 4}, 3, base_feat_channels=BASE, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    state = create_train_state(model, None, 1e-3, ema=ema)
    served = dict(model.state_dict())
    if ema:
        for name, value in state.ema_params.items():
            value.mul_(0.5)  # the EMA differs from the parameters
            served[name] = value
    exp = tmp_path / "exp"
    save_config(port_compose(overrides=[
        "crop_height=32", "crop_width=32", "dataset.sensor=PS", "eval_region=RegionA",
        "n_workers=2", f"model.model_kwargs.base_feat_channels={BASE}",
        "tpu.conv_impl=pallas_fused", "tpu.compute_dtype=float32",
    ]), str(exp))
    manager = CheckpointManager(str(exp), save_top_k=1)
    entry = manager.save(state, 0, {MONITOR_KEY: 0.5})
    manager.wait_until_finished()
    os.makedirs(exp / "weights")
    save_weights(served, str(exp / "weights" / "model.pt"))
    monkeypatch.chdir(tmp_path)  # dataset_dirs.json in the cwd wins
    (tmp_path / "dataset_dirs.json").write_text(json.dumps({"floodplanet": geo_root}))
    masks = {}
    for name, path in (("entry", entry), ("weights", str(exp / "weights" / "model.pt"))):
        written = main([path, "floodplanet", "test", "--device", "cpu",
                        "--save_dir", str(tmp_path / name)])
        assert len(written) == 2
        masks[name] = {os.path.basename(p): tiff.imread(p) for p in written}
    assert masks["entry"].keys() == masks["weights"].keys()
    for key, mask in masks["entry"].items():
        np.testing.assert_array_equal(mask, masks["weights"][key])
