"""The port's evaluation CLI (inference/predict.py) and the sliding-window
extras it reads, against the JAX package's, on the CPU.

Same weights (base 8, f32, through the weights bridge), same geo-tagged
synthetic scenes. The JAX ``predict`` runs with its ``load_model_for_eval``
replaced by one returning those flax variables, on one device. Held:
- ``metrics.json``: the same keys, values within 1e-4;
- the ranked reports: the same names in the same order, values within 1e-4;
- per scene: ``pred_class.tif`` pixels and geo tags equal, ``rgb.png``,
  ``gt.png`` and ``cm.png`` pixels equal, ``pred_softmax.png`` within one
  grey level, ``rgb_cm.gif`` of two frames;
- ``sliding_window_predict``'s ``rgb`` and ``gt`` canvases within 1e-5 and
  its per-crop confusion matrices equal, on the scene-cache path and on
  the host-loader path.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from conftest import make_synthetic_csdap, make_synthetic_sen1floods11
from floodplanet_code_tpu.config import compose as jax_compose
from floodplanet_code_tpu.data import build_dataset as jax_build_dataset
from floodplanet_code_tpu.data import generate_image_slice_object as jax_slices
from floodplanet_code_tpu.inference import predict as jax_predict
from floodplanet_code_tpu.inference import sliding as jax_sliding
from floodplanet_code_tpu.models import build_model as jax_build_model
from floodplanet_code_tpu_torch.config import compose, save_config
from floodplanet_code_tpu_torch.data import build_dataset, generate_image_slice_object
from floodplanet_code_tpu_torch.geo import tiff
from floodplanet_code_tpu_torch.inference import predict as port_predict
from floodplanet_code_tpu_torch.inference.sliding import sliding_window_predict
from floodplanet_code_tpu_torch.models import build_model
from floodplanet_code_tpu_torch.tools.import_jax_params import (
    save_weights,
    seeded_flax_variables,
    state_dict_from_flax,
)
from test_torch_sliding import _geo_source

BASE = 8
CROP = 32
REGIONS = ("RegionA", "RegionB")


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """A geo-tagged PS tree of two regions, and Sen1Floods11 chips."""
    root = str(tmp_path_factory.mktemp("predict_csdap"))
    make_synthetic_csdap(root, regions=REGIONS, sensors=("PS",), scene_hw=(80, 112))
    src = _geo_source(os.path.join(root, "geo.tif"))
    for path in glob.glob(os.path.join(root, "CSDAP_complete", "*", "PS", "*.tif")):
        tiff.imwrite(path, tiff.imread(path), geo_from=src)
    s1f11 = str(tmp_path_factory.mktemp("predict_s1f11"))
    make_synthetic_sen1floods11(s1f11, chip_hw=(64, 80))
    return {"floodplanet": root, "sen1floods11": s1f11}


CASES = {
    # (model, dataset, overrides, in_channels)
    "ef": ("ef_model", "floodplanet", ["dataset.sensor=PS", "eval_region=[RegionA,RegionB]"],
           {"ms_image": 4}),
    "lf": ("lf_model", "sen1floods11", ["dataset=sen1floods11", "dataset.sensor=S1",
                                        "eval_region=Bolivia", "ignore_index=-1"],
           {"ms_image": 2}),
}


def _overrides(case):
    model, _, extra, _ = CASES[case]
    return [f"model={model}", f"crop_height={CROP}", f"crop_width={CROP}", "crop_stride=16",
            "n_workers=2", f"model.model_kwargs.base_feat_channels={BASE}",
            "tpu.conv_impl=pallas_fused", "tpu.compute_dtype=float32", "tpu.n_devices=1",
            "tpu.inference_batch_size=8", *extra]


def _variables(case):
    model, _, _, in_channels = CASES[case]
    return seeded_flax_variables(in_channels if model == "lf_model" else 4, 3, BASE, seed=11)


def _jax_predict(case, root, exp, per_crop, monkeypatch):
    model, dataset, _, in_channels = CASES[case]
    cfg = jax_compose(overrides=_overrides(case))
    cfg.dataset["dataset_kwargs"] = {"root_dir": root}
    jmodel = jax_build_model(model, in_channels, 3, base_feat_channels=BASE)
    variables = jax.tree.map(jnp.asarray, _variables(case))
    monkeypatch.setattr(jax_predict, "load_model_for_eval", lambda *a: (jmodel, variables))
    metrics = jax_predict.predict(cfg, exp, os.path.join(exp, "weights", "model.pt"), dataset,
                                  per_crop_stats=per_crop)
    return metrics, cfg


def _reports(pred_dir):
    out = {}
    for path in sorted(glob.glob(os.path.join(pred_dir, "ranked_*.txt"))):
        with open(path) as handle:
            lines = handle.read().splitlines()[2:]
        out[os.path.basename(path)] = [
            (line.rsplit(": ", 1)[0], float(line.rsplit(": ", 1)[1].rstrip("% "))) for line in lines
        ]
    return out


@pytest.mark.parametrize("case,per_crop", [("ef", False), ("ef", True), ("lf", False)],
                         ids=["ef-scene", "ef-per-crop", "lf-s1f11"])
def test_predict_matches_jax(roots, tmp_path, monkeypatch, case, per_crop):
    _, dataset, _, _ = CASES[case]
    root = roots[dataset]
    jexp, texp = str(tmp_path / "jax_exp"), str(tmp_path / "port_exp")
    want, jcfg = _jax_predict(case, root, jexp, per_crop, monkeypatch)

    # The port runs through its CLI, from a weights file in an experiment
    # whose config it reads two levels above it.
    cfg = compose(overrides=_overrides(case))
    cfg.dataset["dataset_kwargs"] = {"root_dir": root}
    save_config(cfg, texp)
    os.makedirs(os.path.join(texp, "weights"))
    weights = os.path.join(texp, "weights", "model.pt")
    save_weights(state_dict_from_flax(_variables(case)), weights)
    argv = [weights, "--device", "cpu"] + (["--per_crop_stats"] if per_crop else [])
    got = port_predict.main(argv)

    assert got.keys() == want.keys() and got["eval_dataset"] == want["eval_dataset"] == dataset
    for key, value in want.items():
        if key != "eval_dataset":
            assert abs(got[key] - value) <= 1e-4, key
    region_key = "-".join(jcfg.eval_region if isinstance(jcfg.eval_region, list)
                          else [jcfg.eval_region])
    jdir = os.path.join(jexp, "predictions", dataset, region_key, "model.pt")
    tdir = os.path.join(texp, "predictions", dataset, region_key, "model.pt")
    with open(os.path.join(tdir, "metrics.json")) as handle:
        assert json.load(handle) == got
    jrep, trep = _reports(jdir), _reports(tdir)
    assert sorted(trep) == sorted(jrep) == sorted(
        ["ranked_images_F1-score.txt", "ranked_images_mIoU.txt",
         "ranked_regions_F1-Score.txt", "ranked_regions_iou.txt"])
    for name, rows in jrep.items():
        assert [r[0] for r in trep[name]] == [r[0] for r in rows], name
        np.testing.assert_allclose([r[1] / 100 for r in trep[name]],
                                   [r[1] / 100 for r in rows], atol=1e-4, rtol=0, err_msg=name)

    scenes = sorted(os.path.relpath(p, jdir) for p in glob.glob(
        os.path.join(jdir, "image_predictions", "*", "*")))
    assert scenes and scenes == sorted(os.path.relpath(p, tdir) for p in glob.glob(
        os.path.join(tdir, "image_predictions", "*", "*")))
    for scene in scenes:
        j, t = os.path.join(jdir, scene), os.path.join(tdir, scene)
        np.testing.assert_array_equal(tiff.imread(os.path.join(t, "pred_class.tif")),
                                      tiff.imread(os.path.join(j, "pred_class.tif")))
        with tiff.TiffFile(os.path.join(t, "pred_class.tif")) as tt, \
                tiff.TiffFile(os.path.join(j, "pred_class.tif")) as jt:
            assert tt.geo_tags() == jt.geo_tags()
            assert bool(tt.geo_tags()) == (dataset == "floodplanet")
        for png in ("rgb.png", "gt.png", "cm.png"):
            np.testing.assert_array_equal(np.asarray(Image.open(os.path.join(t, png))),
                                          np.asarray(Image.open(os.path.join(j, png))),
                                          err_msg=f"{scene}/{png}")
        soft = [np.asarray(Image.open(os.path.join(d, "pred_softmax.png")), np.int16)
                for d in (t, j)]
        assert np.abs(soft[0] - soft[1]).max() <= 1
        with Image.open(os.path.join(t, "rgb_cm.gif")) as gif:
            assert gif.n_frames == 2


_JAX_STEP = {}


@pytest.mark.parametrize("path,norm_mode", [("cache", None), ("host", "local")])
def test_sliding_extras_match_jax(roots, path, norm_mode):
    root = roots["floodplanet"]
    variables = _variables("ef")
    kw = dict(sensor="PS", eval_region=list(REGIONS), ignore_index=0, output_metadata=True,
              norm_mode=norm_mode, root_dir=root)
    budget = 6 << 30 if path == "cache" else 0
    jmodel = jax_build_model("ef_model", {"ms_image": 4}, 3, base_feat_channels=BASE)
    if not _JAX_STEP:
        _JAX_STEP["step"] = jax_sliding.make_predict_step(jmodel)
    jds = jax_build_dataset("floodplanet", "test", jax_slices(CROP, stride=16), **kw)
    want = {s["image_name"]: s for s in jax_sliding.sliding_window_predict(
        jmodel, jax.tree.map(jnp.asarray, variables), jds, batch_size=8, n_workers=2,
        collect_extras=True, device_data_bytes=budget, per_crop_ignore_index=0,
        predict_step=_JAX_STEP["step"])}
    model = build_model("ef_model", {"ms_image": 4}, 3, base_feat_channels=BASE, device="cpu",
                        conv_impl="pallas_fused")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    ds = build_dataset("floodplanet", "test", generate_image_slice_object(CROP, stride=16), **kw)
    got = {s["image_name"]: s for s in sliding_window_predict(
        model, ds, 8, n_workers=2, device="cpu", device_data_bytes=budget,
        collect_extras=True, per_crop_ignore_index=0)}
    assert sorted(got) == sorted(want) and len(got) == 4
    for name, scene in got.items():
        w = want[name]
        assert scene["rgb"].shape == w["rgb"].shape == (80, 112, 4)
        assert scene["gt"].shape == w["gt"].shape == (80, 112)
        np.testing.assert_allclose(scene["rgb"], w["rgb"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(scene["gt"], w["gt"], atol=1e-5, rtol=0)
        assert scene["crop_confusions"].shape == w["crop_confusions"].shape == (35, 3, 3)
        np.testing.assert_array_equal(scene["crop_confusions"], w["crop_confusions"])
        np.testing.assert_allclose(scene["probabilities"], w["probabilities"], atol=1e-4,
                                   rtol=0)


def test_per_sample_confusion_is_one_index_add(rng):
    """``per_sample=True`` equals one matrix per sample, each the plain
    function's on that sample alone."""
    from floodplanet_code_tpu_torch.ops.metrics import confusion_from_preds

    preds = torch.from_numpy(rng.integers(0, 3, (5, 7, 9)))
    target = torch.from_numpy(rng.integers(-1, 4, (5, 7, 9)))
    mask = torch.from_numpy((rng.random((5, 7, 9)) > 0.2).astype(np.float32))
    got = confusion_from_preds(preds, target, 3, 0, mask, per_sample=True)
    assert got.shape == (5, 3, 3)
    for i in range(5):
        torch.testing.assert_close(got[i], confusion_from_preds(preds[i], target[i], 3, 0,
                                                                mask[i]))


def test_predict_needs_a_card_unless_cpu(roots, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = compose(overrides=_overrides("ef"))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port_predict.predict(cfg, str(tmp_path), str(tmp_path / "w.pt"), "floodplanet")
