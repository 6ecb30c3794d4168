"""The port's export of the predict step (tools/export_model.py) and the
fused op's registration as a custom op (ops/conv_fused.py), on the CPU.

A checkpoint of the early-fusion UNet (base 8, f32, conv_impl
pallas_fused, seeded flax-layout weights through the weights bridge) is
exported at batch 2 on 32^2 tiles, with and without TTA. The loaded
program must equal the live ``make_predict_step`` exactly, as
tests/test_inference.py holds the JAX artifact to its live step, and match
the JAX package's ``make_predict_step`` on the same weights within 1e-4.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_synthetic_csdap
from floodplanet_code_tpu.inference.sliding import make_predict_step as jax_predict_step
from floodplanet_code_tpu.models import build_model as jax_build_model
from floodplanet_code_tpu_torch.config import compose, load_experiment_config, save_config
from floodplanet_code_tpu_torch.inference.infer import build_infer_dataset, load_model_for_eval
from floodplanet_code_tpu_torch.inference.sliding import make_predict_step
from floodplanet_code_tpu_torch.models import build_model
from floodplanet_code_tpu_torch.models.unet import DoubleConv
from floodplanet_code_tpu_torch.tools import export_model
from floodplanet_code_tpu_torch.tools.import_jax_params import (
    seeded_flax_variables,
    state_dict_from_flax,
)
from floodplanet_code_tpu_torch.train import create_train_state
from floodplanet_code_tpu_torch.train.checkpoint import MONITOR_KEY, CheckpointManager

BASE = 8
JAX_MANIFEST_KEYS = {"artifact", "bytes", "inputs", "output", "n_classes", "platforms", "tta",
                     "model", "checkpoint"}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    base = tmp_path_factory.mktemp("export")
    root = str(base / "data")
    make_synthetic_csdap(root, regions=("RegionA",), sensors=("PS",), scene_hw=(70, 90),
                         scenes_per_region=1)
    exp = str(base / "exp")
    cfg = compose(overrides=["dataset.sensor=PS", "crop_height=32", "crop_width=32",
                             "n_workers=2", f"model.model_kwargs.base_feat_channels={BASE}",
                             "tpu.conv_impl=pallas_fused", "tpu.compute_dtype=float32",
                             f"dataset.dataset_kwargs.root_dir={root}"])
    save_config(cfg, exp)
    variables = seeded_flax_variables(4, 3, BASE, seed=2)
    model = build_model("ef_model", {"ms_image": 4}, 3, base_feat_channels=BASE, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables))
    manager = CheckpointManager(exp, save_top_k=1, async_save=False)
    entry = manager.save(create_train_state(model, None, 1e-3), 0, {MONITOR_KEY: 0.5})
    manifests = {tta: export_model.export_checkpoint(entry, str(base / "out" / f"tta{int(tta)}"),
                                                     batch_size=2, tta=tta, device="cpu")
                 for tta in (False, True)}
    x = np.random.default_rng(5).standard_normal((2, 32, 32, 4)).astype(np.float32)
    return {"exp": exp, "entry": entry, "variables": variables, "manifests": manifests, "x": x}


def _live(setup, tta):
    cfg = load_experiment_config(setup["exp"])
    model = load_model_for_eval(cfg, setup["entry"], build_infer_dataset(cfg, "floodplanet",
                                                                          "all"), "cpu")
    x = torch.from_numpy(setup["x"])
    return make_predict_step(model, tta)({"image": x.permute(0, 3, 1, 2)})


@pytest.mark.parametrize("tta", [False, True], ids=["plain", "tta"])
def test_program_equals_the_live_step(setup, tta):
    call = export_model.load_exported(setup["manifests"][tta]["artifact"])
    got = call({"image": torch.from_numpy(setup["x"])})
    assert got.shape == (2, 32, 32, 3) and got.dtype == torch.float32
    assert torch.equal(got, _live(setup, tta))


@pytest.mark.parametrize("tta", [False, True], ids=["plain", "tta"])
def test_program_matches_jax_predict_step(setup, tta):
    jmodel = jax_build_model("ef_model", {"ms_image": 4}, 3, dtype=jnp.float32,
                             base_feat_channels=BASE)
    want = np.asarray(jax_predict_step(jmodel, tta)(setup["variables"],
                                                    {"image": jnp.asarray(setup["x"])}))
    got = export_model.load_exported(setup["manifests"][tta]["artifact"])(
        {"image": torch.from_numpy(setup["x"])}).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("tta", [False, True], ids=["plain", "tta"])
def test_manifest(setup, tta):
    manifest = setup["manifests"][tta]
    assert set(manifest) == JAX_MANIFEST_KEYS | {"conv_impl"}
    assert manifest["inputs"] == {"image": {"shape": [2, 32, 32, 4], "dtype": "float32"}}
    assert manifest["n_classes"] == 3 and manifest["tta"] is tta
    assert manifest["platforms"] == ["cpu"] and manifest["conv_impl"] == "pallas_fused"
    assert manifest["model"] == "ef_model" and manifest["checkpoint"] == setup["entry"]
    assert manifest["artifact"].endswith(f"tta{int(tta)}.pt2")
    assert manifest["bytes"] == os.path.getsize(manifest["artifact"])
    with open(manifest["artifact"][: -len(".pt2")] + ".json") as handle:
        assert json.load(handle) == manifest


def test_export_needs_a_card_unless_cpu(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        export_model.export_checkpoint(setup["entry"])


def _double_conv(frozen):
    torch.manual_seed(0)
    dc = DoubleConv(3, 5, conv_impl="pallas_fused").to(memory_format=torch.channels_last).eval()
    for bn in (dc.bn0, dc.bn1):
        with torch.no_grad():
            bn.mean.uniform_(-0.5, 0.5)
            bn.var.uniform_(0.5, 1.5)
    if frozen:
        dc.freeze_fused_operands(torch.float32)
    return dc


def test_double_conv_export_shows_the_custom_op():
    y = torch.randn(2, 3, 12, 10).contiguous(memory_format=torch.channels_last)
    program = torch.export.export(_double_conv(frozen=True), (y,))
    ops = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert ops.count(torch.ops.floodplanet.relu_affine_conv3x3.default) == 1
    # The frozen operands are constants of the program, not inputs.
    assert {"frozen_a", "frozen_wp"} <= {k.rsplit(".", 1)[-1] for k in program.constants}
    assert torch.equal(program.module()(y), _double_conv(frozen=False)(y))


def test_frozen_operands_are_eval_only():
    dc = _double_conv(frozen=True)
    y = torch.randn(1, 3, 8, 8).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        assert torch.equal(dc(y), _double_conv(frozen=False)(y))
    with pytest.raises(RuntimeError, match="frozen"):
        dc(y.double())
    dc.train()
    with pytest.raises(RuntimeError, match="frozen"):
        dc(y)
    assert "frozen_a" not in dc.state_dict()  # checkpoints never carry them
