"""The port's training entry point (train/fit.py::fit_model, the fit CLI,
train/logging.py, train/state.py::init_weights) against the JAX package's
and on its own, on the CPU.

``test_fit_matches_jax`` runs both packages' ``fit_model`` on the same
config (f32, base 8, 32^2 crops, batch 8, 2 epochs of 3 steps and 2
validation batches, transforms off because jax.random and torch.Generator
draw differently, the device cache on in both, ignore_index -1 so the
metrics count both classes), the port starting from the JAX package's own
initial parameters. Per epoch, metrics.json's losses agree to 1e-4
relative and the validation Jaccard/F1 to 1e-3 absolute.

The final parameters: Adam divides each gradient element by its own RMS,
so an element whose gradient is rounding noise can move by up to lr per
step in either package (tests/test_torch_train_step.py), and each such
move changes the next steps' gradients. tests/test_torch_train_step.py
holds 99.9% of the elements to 1e-5 + 1e-3*|p| after three steps at
lr 1e-3 on 2 tiles; after six steps here 86% of them are, so this test
holds what the argument bounds: every element within 2*lr*steps (measured
at most 0.42 of it), and each tensor's distance from JAX's within a
quarter of the distance JAX moved it from the common start (measured at
most 0.17): the port takes the steps JAX takes, up to that noise. The
running statistics are batch averages of activations of those parameters:
each within 1e-2 of its tensor's largest value (measured at most 4e-3).
"""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from floodplanet_code_tpu.config import compose as jax_compose
from floodplanet_code_tpu.data import build_dataset as jax_build_dataset
from floodplanet_code_tpu.data import generate_image_slice_object as jax_slices
from floodplanet_code_tpu.inference.predict import load_model_for_eval as jax_load_for_eval
from floodplanet_code_tpu.models import build_model as jax_build_model
from floodplanet_code_tpu.train.fit import fit_model as jax_fit_model
from floodplanet_code_tpu.train.state import create_train_state as jax_create_state
from floodplanet_code_tpu_torch.config import compose
from floodplanet_code_tpu_torch.models import build_model
from floodplanet_code_tpu_torch.tools.import_jax_params import state_dict_from_flax
from floodplanet_code_tpu_torch.train import checkpoint as ckpt
from floodplanet_code_tpu_torch.train import fit_model, init_weights

LR = 1e-4
STEPS = 6  # 2 epochs x 3 steps


def _overrides(root, *extra):
    return [
        "dataset.sensor=PS", "eval_region=RegionA", "crop_height=32", "crop_width=32",
        "crop_stride=32", "batch_size=8", "n_workers=2", "n_epochs=2",
        "limit_train_batches=3", "limit_val_batches=2", "tpu.compute_dtype=float32",
        "model.model_kwargs.base_feat_channels=8", f"dataset.dataset_kwargs.root_dir={root}",
        *extra,
    ]


def _epochs(exp):
    """metrics.json of every kept checkpoint, by epoch."""
    out = {}
    for path in glob.glob(os.path.join(exp, "checkpoints", "model-*")):
        with open(os.path.join(path, "metrics.json")) as handle:
            metrics = json.load(handle)
        out[metrics["epoch"]] = metrics
    return out


def test_fit_matches_jax(synthetic_csdap_root, tmp_path):
    overrides = _overrides(synthetic_csdap_root, "ignore_index=-1", "tpu.n_devices=1",
                           "save_topk_models=2", "tpu.resume_every=1",
                           "transforms.hflip.active=false", "transforms.vflip.active=false",
                           "transforms.rotate.active=false")
    jcfg = jax_compose(overrides=overrides)
    jax_fit_model(jcfg, overwrite_exp_dir=str(tmp_path / "jax"))

    # The JAX fit's initial parameters: its model, init batch and seed.
    valid = jax_build_dataset("floodplanet", "valid", jax_slices(32, 32, 32), sensor="PS",
                              eval_region="RegionA", ignore_index=-1, seed_num=0,
                              root_dir=synthetic_csdap_root)
    jmodel = jax_build_model("ef_model", valid.n_channels, 3, dtype=jax.numpy.float32,
                             base_feat_channels=8)
    jstate = jax_create_state(jmodel, {"image": valid.load_example(0)["image"][None]},
                              lr=LR, seed=0)
    start = state_dict_from_flax(jax.tree.map(
        lambda v: np.array(v, np.float32),
        {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    best = fit_model(compose(overrides=overrides), overwrite_exp_dir=str(tmp_path / "port"),
                     device="cpu", init_state_dict=start)

    want, got = _epochs(str(tmp_path / "jax")), _epochs(str(tmp_path / "port"))
    assert sorted(got) == sorted(want) == [0, 1]
    for epoch in (0, 1):
        for key in ("train_loss", "valid_loss"):
            np.testing.assert_allclose(got[epoch][key], want[epoch][key], rtol=1e-4)
        for key in ("val_MulticlassJaccardIndex", "val_MulticlassF1Score", "val_water_IoU"):
            assert abs(got[epoch][key] - want[epoch][key]) <= 1e-3, (epoch, key)
    assert os.path.basename(best) == os.path.basename(
        max(glob.glob(str(tmp_path / "jax" / "checkpoints" / "model-*")),
            key=lambda p: float(p.rsplit("=", 1)[1])))

    last = glob.glob(str(tmp_path / "jax" / "checkpoints" / "model-epoch=01*"))[0]
    _, variables = jax_load_for_eval(jcfg, last, valid)
    final = state_dict_from_flax(jax.tree.map(lambda v: np.array(v, np.float32), variables))
    saved = ckpt.read_checkpoint(glob.glob(str(tmp_path / "port" / "checkpoints" /
                                               "model-epoch=01*"))[0])
    assert saved["step"] == STEPS
    for name, value in saved["model"].items():
        got, w = value.numpy(), final[name].numpy()
        if name.endswith((".mean", ".var")):
            assert np.abs(got - w).max() <= 1e-2 * np.abs(w).max(), name
            continue
        assert np.abs(got - w).max() <= 2 * LR * STEPS, name
        moved = np.linalg.norm(w - start[name].numpy())
        assert np.linalg.norm(got - w) <= 0.25 * moved, name


def _payload(exp, epoch):
    path = glob.glob(os.path.join(exp, "checkpoints", f"model-epoch={epoch:02d}*"))[0]
    return ckpt.read_checkpoint(path), _epochs(exp)[epoch]


@pytest.mark.parametrize("cache", ["6442450944", "0"], ids=["cache", "host-loader"])
def test_resume_is_deterministic(synthetic_csdap_root, tmp_path, cache):
    """2 straight epochs equal 1 + 1 resumed, bit for bit, with flips and
    rotation on: the batch order and the augmentation generator are pure
    functions of (seed, epoch)."""
    overrides = _overrides(synthetic_csdap_root, f"tpu.device_data_bytes={cache}")
    fit_model(compose(overrides=overrides), overwrite_exp_dir=str(tmp_path / "a"),
              device="cpu")
    fit_model(compose(overrides=overrides + ["n_epochs=1"]),
              overwrite_exp_dir=str(tmp_path / "b"), device="cpu")
    fit_model(compose(overrides=overrides), overwrite_exp_dir=str(tmp_path / "b"),
              device="cpu")
    (a, metrics_a), (b, metrics_b) = _payload(str(tmp_path / "a"), 1), _payload(str(tmp_path / "b"), 1)
    assert a["step"] == b["step"] == 6
    for key, value in a["model"].items():
        assert torch.equal(value, b["model"][key]), key
    for i, moments in a["optimizer"]["state"].items():
        for key, value in moments.items():
            assert torch.equal(value, b["optimizer"]["state"][i][key]), (i, key)
    assert metrics_a == metrics_b


def test_finished_experiment_returns_at_once(synthetic_csdap_root, tmp_path, capsys,
                                             monkeypatch):
    overrides = _overrides(synthetic_csdap_root, "n_epochs=1", "limit_train_batches=1")
    exp = str(tmp_path / "exp")
    best = fit_model(compose(overrides=overrides), overwrite_exp_dir=exp, device="cpu")
    with open(os.path.join(exp, "timing.json")) as handle:
        timing = handle.read()
    from floodplanet_code_tpu_torch.train import fit as fit_module

    def no_cache(*args, **kwargs):
        raise AssertionError("a finished experiment built the device cache")

    monkeypatch.setattr(fit_module, "build_device_cache", no_cache)
    capsys.readouterr()
    assert fit_model(compose(overrides=overrides), overwrite_exp_dir=exp, device="cpu") == best
    assert "nothing to do: epoch 1 >= n_epochs 1" in capsys.readouterr().out
    with open(os.path.join(exp, "timing.json")) as handle:
        assert handle.read() == timing


# Each multi-device setting in a context where it cannot run, and what it
# raises there, before anything is written: more cards than are present;
# spatial partitioning on one rank; the JAX package's own refusals of
# shard_map with another loss than CE and with spatial partitioning; a
# crop height that leaves a spatial block empty at some UNet level (32 rows
# over 4 blocks: level 4 has 2 rows); a
# tpu.multihost block with one of its three keys; the pod-sharded scene
# cache without a pod axis (one process).
_REFUSED = {
    "tpu.n_devices=2": ([], ValueError, "2 CUDA devices requested, 1 present"),
    "tpu.spatial_shards=2": ([], ValueError, "needs 2 devices"),
    "tpu.spmd_impl=shard_map": (["loss.name=ce_dice"], NotImplementedError, "CE loss only"),
    "tpu.spmd_impl=shard_map tpu.spatial_shards=2": ([], ValueError, "needs gspmd"),
    "tpu.spatial_shards=4": ([], ValueError, "block 1 without a row at UNet level 4"),
    "tpu.multihost.num_processes=2": ([], ValueError, "needs all three"),
    "tpu.device_cache_shard=pod": ([], ValueError, "needs a pod axis"),
}


@pytest.mark.parametrize("override", list(_REFUSED))
def test_multi_device_configs_raise(synthetic_csdap_root, tmp_path, override, monkeypatch):
    extra, error, match = _REFUSED[override]
    cfg = compose(overrides=_overrides(synthetic_csdap_root, *override.split(), *extra))
    device = "cpu"
    if override == "tpu.n_devices=2":  # a machine with one card
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        device = "cuda"
    with pytest.raises(error, match=match):
        fit_model(cfg, overwrite_exp_dir=str(tmp_path / "exp"), device=device)
    assert not os.path.exists(tmp_path / "exp")


def test_fit_needs_a_card_unless_cpu(synthetic_csdap_root, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fit_model(compose(overrides=_overrides(synthetic_csdap_root)),
                  overwrite_exp_dir=str(tmp_path / "exp"))


def test_init_matches_jax_statistics():
    """Full width: every conv kernel's std within 5% of JAX's initial one
    (each has >= 2304 elements, so two draws' stds differ by ~2%; the
    head's 192 elements within 25%), BatchNorm and biases exact."""
    jmodel = jax_build_model("ef_model", {"ms_image": 4}, 3)
    jstate = jax_create_state(jmodel, {"image": np.zeros((1, 32, 32, 4), np.float32)}, lr=LR)
    want = state_dict_from_flax(jax.tree.map(
        lambda v: np.array(v, np.float32),
        {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    model = init_weights(build_model("ef_model", {"ms_image": 4}, 3, device="cpu"), 0)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for name, value in got.items():
        w = want[name]
        if value.dim() == 4:
            ratio = value.std().item() / w.std().item()
            assert abs(ratio - 1) <= (0.05 if value.numel() >= 2304 else 0.25), (name, ratio)
            assert value.abs().max() <= 2 * w.abs().max()  # truncated at 2 stds
        else:
            assert torch.equal(value, w), name
    again = init_weights(build_model("ef_model", {"ms_image": 4}, 3, device="cpu"), 0)
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in got.items())


@pytest.mark.parametrize("overrides", [
    ["lr=1e-3,1e-4", "model=ms_model,lf_model"],
    ["eval_region=[RegionA,RegionB]", "batch_size=4,8"],
    ["run.name=x", "loss.name='ce,dice'"],
    ["n_epochs=1"],
])
def test_expand_multirun_matches_jax(overrides):
    from floodplanet_code_tpu.fit import _expand_multirun as jax_expand
    from floodplanet_code_tpu_torch.fit import _expand_multirun

    assert _expand_multirun(overrides) == jax_expand(overrides)


def test_cli_writes_an_experiment(synthetic_csdap_root, tmp_path, monkeypatch):
    from floodplanet_code_tpu_torch.fit import main

    monkeypatch.chdir(tmp_path)
    exp = tmp_path / "run"
    best = main(["--device", "cpu", *_overrides(synthetic_csdap_root, "n_epochs=1",
                                                  "log_image_iter=2", "profiler=advanced",
                                                  f"run.dir={exp}")])
    assert os.path.isfile(exp / "hydra" / "config.yaml")
    assert os.listdir(exp / "tensorboard_logs")
    assert os.listdir(exp / "profile")
    with open(exp / "timing.json") as handle:
        timing = json.load(handle)
    assert timing["n_epochs_run"] == 1 and timing["train_tiles"] == 24
    assert best.startswith(str(exp / "checkpoints" / "model-epoch=00"))
    assert os.path.isfile(os.path.join(best, ckpt.CHECKPOINT_FILE))


def test_writer_falls_back_to_json_lines(tmp_path, monkeypatch):
    import sys

    from floodplanet_code_tpu_torch.train.logging import JsonlWriter, open_writer

    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    writer, name = open_writer(str(tmp_path))
    assert name == "jsonl" and isinstance(writer, JsonlWriter)
    writer.add_scalar("train_loss", torch.tensor(0.5), 10)
    writer.add_image("panel", np.zeros((3, 4, 2), np.float32), 10)
    writer.close()
    with open(tmp_path / "scalars.jsonl") as handle:
        assert json.loads(handle.read()) == {"tag": "train_loss", "value": 0.5, "step": 10}
    assert np.load(tmp_path / "images" / "panel_10.npy").shape == (3, 4, 2)


def test_log_image_panel_matches_jax():
    from floodplanet_code_tpu.data import sensors as jax_sensors
    from floodplanet_code_tpu.train.logging import log_image_panel as jax_panel
    from floodplanet_code_tpu_torch.data import sensors
    from floodplanet_code_tpu_torch.train.logging import log_image_panel

    class Recorder:
        def __init__(self):
            self.images = []

        def add_image(self, tag, image, step):
            self.images.append((tag, np.asarray(image), step))

    rng = np.random.default_rng(0)
    image = rng.standard_normal((16, 20, 4)).astype(np.float32)
    mean = rng.uniform(0, 0.5, (1, 1, 4)).astype(np.float32)
    std = rng.uniform(0.5, 1, (1, 1, 4)).astype(np.float32)
    logits = rng.standard_normal((16, 20, 3)).astype(np.float32)
    target = rng.integers(0, 3, (16, 20))
    got, want = Recorder(), Recorder()
    log_image_panel(got, "train_s10", image, mean, std, logits, target,
                    lambda x: sensors.to_rgb(x, "PS", "ALL"), 10)
    jax_panel(want, "train_s10", image, mean, std, logits, target,
              lambda x: jax_sensors.to_rgb(x, "PS", "ALL"), 10)
    assert got.images[0][0] == want.images[0][0] and got.images[0][2] == 10
    assert got.images[0][1].shape == (3, 32, 20)
    np.testing.assert_array_equal(got.images[0][1], want.images[0][1])
