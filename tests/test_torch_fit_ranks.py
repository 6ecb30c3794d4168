"""``fit_model`` on 2 ranks (gloo on the CPU, ``parallel/launch.py``)
against the JAX package's ``fit_model`` with ``tpu.n_devices=2`` on the
virtual CPU devices.

The configuration is tests/test_torch_fit.py's (f32, base 8, 32^2 crops,
global batch 8, 3 steps and 2 validation batches per epoch, transforms off
because jax.random and torch.Generator draw differently, ignore_index -1,
the scene cache on), the port starting from the JAX fit's initial
parameters. Per epoch the losses agree to 1e-4 relative and the validation
Jaccard/F1 to 1e-3 absolute, the tolerances of the one-device fit test.
Every side effect is rank 0's alone (the config snapshot, the TensorBoard
writer, the checkpoint writes), and a resumed fit restores on both ranks.
"""

import glob
import json
import os

import jax
import numpy as np

import _torch_rank_fns as fns
from floodplanet_code_tpu.config import compose as jax_compose
from floodplanet_code_tpu.data import build_dataset as jax_build_dataset
from floodplanet_code_tpu.data import generate_image_slice_object as jax_slices
from floodplanet_code_tpu.models import build_model as jax_build_model
from floodplanet_code_tpu.train.fit import fit_model as jax_fit_model
from floodplanet_code_tpu.train.state import create_train_state as jax_create_state
from floodplanet_code_tpu_torch.config import compose
from floodplanet_code_tpu_torch.parallel import launch
from floodplanet_code_tpu_torch.tools.import_jax_params import state_dict_from_flax
from floodplanet_code_tpu_torch.train import checkpoint as ckpt
from floodplanet_code_tpu_torch.train import fit_model

DEADLINE = 300  # seconds for a 2-rank CPU fit, imports included


def _overrides(root, *extra):
    return [
        "dataset.sensor=PS", "eval_region=RegionA", "crop_height=32", "crop_width=32",
        "crop_stride=32", "batch_size=8", "n_workers=2", "n_epochs=1",
        "limit_train_batches=3", "limit_val_batches=2", "tpu.compute_dtype=float32",
        "model.model_kwargs.base_feat_channels=8", f"dataset.dataset_kwargs.root_dir={root}",
        "ignore_index=-1", "save_topk_models=2", "tpu.resume_every=1",
        "transforms.hflip.active=false", "transforms.vflip.active=false",
        "transforms.rotate.active=false", *extra,
    ]


def _epochs(exp):
    out = {}
    for path in glob.glob(os.path.join(exp, "checkpoints", "model-*")):
        with open(os.path.join(path, "metrics.json")) as handle:
            metrics = json.load(handle)
        out[metrics["epoch"]] = metrics
    return out


def test_two_rank_fit_matches_jax(synthetic_csdap_root, tmp_path, capfd):
    jcfg = jax_compose(overrides=_overrides(synthetic_csdap_root, "tpu.n_devices=2"))
    jax_fit_model(jcfg, overwrite_exp_dir=str(tmp_path / "jax"))
    valid = jax_build_dataset("floodplanet", "valid", jax_slices(32, 32, 32), sensor="PS",
                              eval_region="RegionA", ignore_index=-1, seed_num=0,
                              root_dir=synthetic_csdap_root)
    jmodel = jax_build_model("ef_model", valid.n_channels, 3, dtype=jax.numpy.float32,
                             base_feat_channels=8)
    jstate = jax_create_state(jmodel, {"image": valid.load_example(0)["image"][None]},
                              lr=1e-4, seed=0)
    start = state_dict_from_flax(jax.tree.map(
        lambda v: np.array(v, np.float32),
        {"params": jstate.params, "batch_stats": jstate.batch_stats}))

    exp = str(tmp_path / "port")
    cfg = compose(overrides=_overrides(synthetic_csdap_root))
    ranks = launch.spawn(fns.fit_rank, (cfg, exp, start), devices=["cpu", "cpu"],
                         timeout_s=120, join_timeout_s=DEADLINE)
    want, got = _epochs(str(tmp_path / "jax")), _epochs(exp)
    assert sorted(got) == sorted(want) == [0]
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(got[0][key], want[0][key], rtol=1e-4)
    for key in ("val_MulticlassJaccardIndex", "val_MulticlassF1Score", "val_water_IoU"):
        assert abs(got[0][key] - want[0][key]) <= 1e-3, key
    # Rank 0 alone writes; both return the same best path.
    assert ranks[0]["best"] == ranks[1]["best"] != ""
    assert sorted(set(ranks[0]["taken"])) == ["checkpoint", "config", "writer"]
    assert ranks[1]["taken"] == []
    assert os.listdir(exp) and sorted(os.listdir(os.path.join(exp, "checkpoints"))) == [
        "index.json", os.path.basename(ranks[0]["best"])]
    assert os.path.isdir(os.path.join(exp, "tensorboard_logs"))
    assert os.path.isfile(os.path.join(exp, "timing.json"))

    # Resumed to a second epoch through fit_model's own launch: both ranks
    # restore the checkpoint and run epoch 1 alone.
    capfd.readouterr()
    best = fit_model(compose(overrides=_overrides(synthetic_csdap_root, "n_epochs=2")),
                     overwrite_exp_dir=exp, device="cpu", devices=["cpu", "cpu"],
                     init_state_dict=start)
    out = capfd.readouterr().out
    assert out.count("[fit] resumed from") == 2, out
    assert out.count("epoch 1: loss") == 1  # the coordinator prints the epoch line
    assert sorted(_epochs(exp)) == [0, 1]
    payload = ckpt.read_checkpoint(glob.glob(os.path.join(exp, "checkpoints",
                                                          "model-epoch=01*"))[0])
    assert payload["step"] == 6 and best.startswith(exp)
