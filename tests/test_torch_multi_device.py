"""More than one device outside the train step, on the CPU: the pod-sharded
scene cache on 2 ranks as 2 pods (``parallel/launch.py``, gloo) against
the replicated cache, and inference over two CPU replicas against one
device. The JAX package's batch rounding for inference over n devices is
the oracle of ``resolve_inference_batch_size``.

- Pod cache: every batch of one shuffled epoch (norm_mode null and local)
  equal (``torch.equal``) to the replicated cache's, for each rank's rows.
- Replicas: the same weights on one device and split over two give
  probabilities within 1e-6 (the convolutions see half the batch, and may
  sum in another order) and equal masks.
"""

import os

import numpy as np
import pytest
import torch

import _torch_rank_fns as fns
from floodplanet_code_tpu.config import compose as jax_compose
from floodplanet_code_tpu.inference import sliding as jax_sliding
from floodplanet_code_tpu_torch.config import Config, compose
from floodplanet_code_tpu_torch.data import build_dataset, generate_image_slice_object
from floodplanet_code_tpu_torch.geo import tiff
from floodplanet_code_tpu_torch.inference.infer import build_infer_dataset, infer
from floodplanet_code_tpu_torch.inference.sliding import (
    inference_devices,
    make_replicated_predict_step,
    resolve_inference_batch_size,
    sliding_window_predict,
)
from floodplanet_code_tpu_torch.models import build_model
from floodplanet_code_tpu_torch.parallel import launch
from floodplanet_code_tpu_torch.tools.import_jax_params import (
    save_weights,
    seeded_flax_variables,
    state_dict_from_flax,
)

BASE = 8


def test_pod_sharded_batches_equal_the_replicated(synthetic_csdap_root):
    ranks = launch.spawn(fns.pod_cache_case, (synthetic_csdap_root, 8), devices=["cpu", "cpu"],
                         pods=2, timeout_s=120, join_timeout_s=240)
    for rank, got in enumerate(ranks):
        assert got["mesh"] == {"pod": 2, "data": 1}
        assert got["rows"] == (4 * rank, 4 * rank + 4)
        assert got["held"] == (got["scenes"], got["scenes"] // 2) == (4, 2)
        assert got["batches"] == 2 * 6  # 48 crops in batches of 8, two norm modes


@pytest.fixture(scope="module")
def model():
    tmodel = build_model("ef_model", {"ms_image": 4}, 3, base_feat_channels=BASE,
                         device="cpu", conv_impl="pallas_fused")
    tmodel.load_state_dict(state_dict_from_flax(
        seeded_flax_variables(4, 3, base_feat_channels=BASE, seed=7)), strict=True)
    return tmodel


def test_replicas_compute_the_one_device_probabilities(synthetic_csdap_root, model):
    ds = build_dataset("floodplanet", "test", generate_image_slice_object(32, stride=32),
                       sensor="PS", eval_region="RegionA", ignore_index=0,
                       output_metadata=True, root_dir=synthetic_csdap_root)
    one = {s["image_name"]: s["probabilities"] for s in sliding_window_predict(
        model, ds, batch_size=8, n_workers=2, device="cpu")}
    step = make_replicated_predict_step(model, ["cpu", "cpu"])
    two = {s["image_name"]: s["probabilities"] for s in sliding_window_predict(
        model, ds, batch_size=8, n_workers=2, device="cpu", predict_step=step)}
    assert sorted(one) == sorted(two) and len(one) == 2
    for name in one:
        np.testing.assert_allclose(two[name], one[name], atol=1e-6, rtol=0, err_msg=name)
    with pytest.raises(ValueError, match="does not split over 2 devices"):
        step({"image": torch.zeros(3, 4, 32, 32)})


def test_infer_over_two_replicas_writes_the_one_device_masks(synthetic_csdap_root, model,
                                                             tmp_path):
    weights_path = str(tmp_path / "exp" / "weights" / "model.pt")
    os.makedirs(os.path.dirname(weights_path))
    save_weights(model.state_dict(), weights_path)
    cfg = Config({
        "crop_height": 32, "crop_width": 32, "batch_size": 8, "n_workers": 2,
        "norm_mode": None, "eval_region": "RegionA", "ignore_index": 0,
        "seed_num": 0, "train_split_pct": 0.8,
        "dataset": {"name": "floodplanet", "sensor": "PS", "channels": "ALL",
                    "dataset_kwargs": {}},
        "model": {"name": "ef_model",
                  "model_kwargs": {"optimizer_name": "adam", "base_feat_channels": BASE}},
        "tpu": {"compute_dtype": "float32", "conv_impl": "pallas_fused",
                "inference_batch_size": 7},
    })
    ds = build_infer_dataset(cfg, "floodplanet", "test", root_dir=synthetic_csdap_root)
    masks = {}
    for name, kw in (("one", {}), ("two", {"devices": ["cpu", "cpu"]})):
        written = infer(cfg, weights_path, "floodplanet", "test", str(tmp_path / name),
                        dataset=ds, device="cpu", **kw)
        masks[name] = {os.path.basename(p): tiff.imread(p) for p in written}
    assert sorted(masks["one"]) == sorted(masks["two"]) and len(masks["one"]) == 2
    for key, mask in masks["one"].items():
        np.testing.assert_array_equal(masks["two"][key], mask)
    # tpu.n_devices asks for the replicas too, and the devices present bound it.
    cfg.tpu["n_devices"] = 2
    assert inference_devices(cfg, "cpu") == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="an exported program runs on one device"):
        infer(cfg, None, "floodplanet", "test", str(tmp_path / "x"), dataset=ds,
              device="cpu", predict_step=lambda batch: None)


@pytest.mark.parametrize("n_devices", [1, 2, 3, 16])
@pytest.mark.parametrize("overrides", [["batch_size=8"], ["tpu.inference_batch_size=null"],
                                       ["tpu.inference_batch_size=5"]])
def test_inference_batch_size_over_devices_matches_jax(overrides, n_devices):
    want = jax_sliding.resolve_inference_batch_size(jax_compose(overrides=overrides),
                                                    n_devices)
    assert resolve_inference_batch_size(compose(overrides=overrides), n_devices) == want
