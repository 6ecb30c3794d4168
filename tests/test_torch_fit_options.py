"""Two of fit_model's single-device options on the CPU: ``tpu.debug_nans``
(train/fit.py::raise_on_nan, the counterpart of ``jax_debug_nans``) and
crops whose height differs from their width (rotated through the
map_coordinates path, from the HBM scene cache and the host loader).

The JAX package's ``fit_model`` is not run with debug_nans: it turns
``jax_debug_nans`` on for the rest of the process (ROADMAP.md Queue 3).
Its ``make_train_step`` runs under ``with jax.debug_nans(True):`` instead,
on the same batches as the port's fit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodplanet_code_tpu.data.augment import TransformParams as JParams
from floodplanet_code_tpu.models import build_model as jax_build_model
from floodplanet_code_tpu.train.fit import make_train_step as jax_train_step
from floodplanet_code_tpu.train.state import create_train_state as jax_state
from floodplanet_code_tpu_torch.config import compose
from floodplanet_code_tpu_torch.train import fit as fit_module
from floodplanet_code_tpu_torch.train import fit_model

POISONED_STEP = 1  # the train step whose batch carries a NaN pixel


def _overrides(root, *extra):
    return [
        "dataset.sensor=PS", "eval_region=RegionA", "crop_height=32", "crop_width=32",
        "crop_stride=32", "batch_size=4", "n_workers=2", "n_epochs=2",
        "limit_train_batches=2", "limit_val_batches=1", "tpu.compute_dtype=float32",
        "model.model_kwargs.base_feat_channels=8", "transforms.rotate.active=false",
        f"dataset.dataset_kwargs.root_dir={root}", *extra,
    ]


def _poison(batch: dict) -> dict:
    batch = dict(batch)
    image = batch["image"].clone()
    image[0, 3, 5, 0] = float("nan")
    batch["image"] = image
    return batch


@pytest.fixture()
def poisoned_fit(monkeypatch):
    """fit_model's train steps, the POISONED_STEP-th of the fit with a NaN
    pixel in its image; records every batch the steps saw."""
    seen = []
    make = fit_module.make_train_step

    def making(*args, **kwargs):
        step = make(*args, **kwargs)

        def poisoned(state, batch, generator=None):
            if len(seen) == POISONED_STEP:
                batch = _poison(batch)
            seen.append({k: v.clone() for k, v in batch.items()})
            return step(state, batch, generator)

        return poisoned

    monkeypatch.setattr(fit_module, "make_train_step", making)
    return seen


def test_poisoned_fit_raises_at_the_step(synthetic_csdap_root, tmp_path, poisoned_fit):
    cfg = compose(overrides=_overrides(synthetic_csdap_root, "tpu.debug_nans=true"))
    with pytest.raises(FloatingPointError,
                       match=f"NaN in the loss after train step {POISONED_STEP} of epoch 0"):
        fit_model(cfg, overwrite_exp_dir=str(tmp_path / "exp"), device="cpu")
    assert len(poisoned_fit) == POISONED_STEP + 1
    assert not torch.is_anomaly_enabled()


def test_without_the_flag_the_poisoned_fit_runs_on(synthetic_csdap_root, tmp_path,
                                                   poisoned_fit):
    cfg = compose(overrides=_overrides(synthetic_csdap_root, "n_epochs=1"))
    fit_model(cfg, overwrite_exp_dir=str(tmp_path / "exp"), device="cpu")
    with open(os.path.join(tmp_path / "exp", "timing.json")) as handle:
        assert json.load(handle)["epochs"][0]["n_train_batches"] == 2


def test_jax_debug_nans_raises_on_the_same_batch(synthetic_csdap_root, tmp_path,
                                                 poisoned_fit):
    """The batches of the port's poisoned fit through the JAX package's
    make_train_step under jax.debug_nans: the clean ones pass, the poisoned
    one raises."""
    cfg = compose(overrides=_overrides(synthetic_csdap_root, "tpu.debug_nans=true"))
    with pytest.raises(FloatingPointError):
        fit_model(cfg, overwrite_exp_dir=str(tmp_path / "exp"), device="cpu")
    batches = [{k: jnp.asarray(v.numpy()) for k, v in b.items() if k in ("image", "target")}
               for b in poisoned_fit]
    jmodel = jax_build_model("ef_model", {"ms_image": 4}, 3, base_feat_channels=8)
    jstate = jax_state(jmodel, {"image": np.zeros((1, 32, 32, 4), np.float32)}, lr=1e-4)
    jstep = jax_train_step(jmodel, 0, JParams(False, 0, False, 0, False, 0))
    raised_at = None
    with jax.debug_nans(True):
        for k, batch in enumerate(batches):
            try:
                jstate, _ = jstep(jstate, batch, jax.random.key(k))
            except FloatingPointError:
                raised_at = k
                break
    assert not jax.config.jax_debug_nans
    assert raised_at == POISONED_STEP


def _epoch_losses(exp):
    out = []
    for path in sorted(os.listdir(os.path.join(exp, "checkpoints"))):
        metrics = os.path.join(exp, "checkpoints", path, "metrics.json")
        if os.path.isfile(metrics):
            with open(metrics) as handle:
                m = json.load(handle)
            out.append((m["train_loss"], m["valid_loss"]))
    return out


def test_clean_fit_losses_are_identical_with_the_flag(synthetic_csdap_root, tmp_path):
    losses = {}
    for flag in ("false", "true"):
        exp = str(tmp_path / flag)
        cfg = compose(overrides=_overrides(synthetic_csdap_root, f"tpu.debug_nans={flag}",
                                           "save_topk_models=2"))
        fit_model(cfg, overwrite_exp_dir=exp, device="cpu")
        losses[flag] = _epoch_losses(exp)
    assert len(losses["true"]) == 2 and losses["true"] == losses["false"]


@pytest.mark.parametrize("budget", ["cache", "host"])
def test_non_square_crops_fit(synthetic_csdap_root, tmp_path, budget):
    """32x48 crops with the default flips and rotation reach their steps
    through the scene cache and the host loader: the rotation takes the
    map_coordinates path (warned once per shape)."""
    overrides = [o for o in _overrides(synthetic_csdap_root, "n_epochs=1")
                 if not o.startswith(("crop_width", "transforms.rotate"))]
    overrides += ["crop_width=48", "transforms.rotate.likelihood=1.0"]
    if budget == "host":
        overrides.append("tpu.device_data_bytes=0")
    exp = str(tmp_path / "exp")
    with pytest.warns(UserWarning, match="non-square crops 32x48"):
        fit_model(compose(overrides=overrides), overwrite_exp_dir=exp, device="cpu")
    with open(os.path.join(exp, "timing.json")) as handle:
        timing = json.load(handle)
    assert timing["epochs"][0]["n_train_batches"] == 2
    assert all(np.isfinite(v) for pair in _epoch_losses(exp) for v in pair)
