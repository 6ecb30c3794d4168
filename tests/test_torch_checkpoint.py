"""The port's checkpoint manager (train/checkpoint.py) against the JAX
package's, and its own round trips, on the CPU.

Both managers are driven with the same epochs and metrics (the sequences of
tests/test_train.py's TestCheckpointManager) on real train states of a
tiny model: each epoch's written/skipped decision, the entries kept with
their kinds (full/slim) and the latest entry must be the same.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodplanet_code_tpu.models import build_model as jax_build_model
from floodplanet_code_tpu.train import checkpoint as jax_ckpt
from floodplanet_code_tpu.train.state import create_train_state as jax_create_state
from floodplanet_code_tpu_torch.data.augment import TransformParams
from floodplanet_code_tpu_torch.models import build_model
from floodplanet_code_tpu_torch.train import (
    create_train_state,
    init_weights,
    make_eval_step,
    make_train_step,
)
from floodplanet_code_tpu_torch.train import checkpoint as ckpt

KEY = ckpt.MONITOR_KEY
NO_AUG = TransformParams(False, 0, False, 0, False, 0)


def _port_state(ema=False, conv_impl="xla"):
    model = build_model("ms_model", {"ms_image": 2}, 3, base_feat_channels=4, device="cpu",
                        conv_impl=conv_impl)
    return create_train_state(init_weights(model, 0), None, 1e-3, ema=ema)


@pytest.fixture(scope="module")
def jax_state():
    model = jax_build_model("ms_model", {"ms_image": 2}, 3, base_feat_channels=4)
    return jax_create_state(model, {"image": np.zeros((1, 16, 16, 2), np.float32)}, lr=1e-3)


def _batch(seed=0, b=2, hw=16):
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(rng.standard_normal((b, hw, hw, 2)).astype(np.float32)),
            "target": torch.from_numpy(rng.integers(0, 3, (b, hw, hw)).astype(np.int32)),
            "valid": torch.ones(b, dtype=torch.bool)}


def _is_slim(path) -> bool:
    return os.path.exists(os.path.join(path, ckpt.SLIM_MARKER))


def _index(manager) -> dict:
    manager.wait_until_finished()
    with open(os.path.join(manager.ckpt_dir, "index.json")) as handle:
        index = json.load(handle)
    return {"entries": sorted((e["epoch"], e["kind"], round(e["metric"], 6))
                              for e in index["entries"]),
            "latest": index["latest"]}


# (save_top_k, resume_every, metrics, force the last epoch)
CASES = {
    "topk": (2, 1, [0.3, 0.6, 0.4, 0.9, 0.1], False),
    "skips": (2, 4, [0.5, 0.6, 0.3, 0.2, 0.1, 0.7, 0.2, 0.15], True),
    "floor": (2, 4, [0.5, 0.6, 0.3, 0.2, 0.1, 0.45, 0.55], False),
    "every-epoch": (1, 1, [0.9, 0.5, 0.4], False),
    "slim": (2, 10, [0.3, 0.6, 0.1], True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_retention_matches_jax(case, jax_state, tmp_path):
    top_k, every, metrics, force_last = CASES[case]
    jm = jax_ckpt.CheckpointManager(str(tmp_path / "jax"), save_top_k=top_k, resume_every=every)
    pm = ckpt.CheckpointManager(str(tmp_path / "port"), save_top_k=top_k, resume_every=every)
    state = _port_state()
    for epoch, metric in enumerate(metrics):
        force = force_last and epoch == len(metrics) - 1
        want = jm.save(jax_state, epoch, {KEY: metric}, force=force)
        got = pm.save(state, epoch, {KEY: metric}, force=force)
        assert (got is None) == (want is None), epoch
        if got is not None:
            assert os.path.basename(got) == os.path.basename(want)
    assert _index(pm) == _index(jm)
    assert pm.latest_epoch == jm.latest_epoch
    assert os.path.basename(pm.best_model_path) == os.path.basename(jm.best_model_path)
    kept = sorted(n for n in os.listdir(pm.ckpt_dir) if n.startswith("model-"))
    assert kept == sorted(n for n in os.listdir(jm.ckpt_dir) if n.startswith("model-"))
    for name in kept:
        entry = os.path.join(pm.ckpt_dir, name)
        assert _is_slim(entry) == jax_ckpt._is_slim(os.path.join(jm.ckpt_dir, name))
        with open(os.path.join(entry, "metrics.json")) as handle:
            assert json.load(handle)[KEY] == pytest.approx(float(name.rsplit("=", 1)[1]), abs=5e-5)


@pytest.mark.parametrize("name", [KEY, "val_JaccardIndex", "test_F1Score", "missing"])
def test_lookup_metric_matches_jax(name):
    metrics = {"val_MulticlassJaccardIndex": 0.4, "test_MulticlassF1Score": 0.7}
    assert ckpt.lookup_metric(metrics, name, -1) == jax_ckpt.lookup_metric(metrics, name, -1)


def test_async_equals_sync(tmp_path):
    managers = {mode: ckpt.CheckpointManager(str(tmp_path / mode), save_top_k=2,
                                             resume_every=2, async_save=(mode == "async"))
                for mode in ("async", "sync")}
    state = _port_state()
    for epoch, metric in enumerate([0.3, 0.6, 0.4, 0.9, 0.1]):
        state.step = epoch  # each entry distinguishable
        for manager in managers.values():
            manager.save(state, epoch, {KEY: metric})
    a, s = managers["async"], managers["sync"]
    assert _index(a) == _index(s)
    assert sorted(os.listdir(a.ckpt_dir)) == sorted(os.listdir(s.ckpt_dir))
    best = ckpt.read_checkpoint(a.best_model_path)
    assert best["step"] == 3 == ckpt.read_checkpoint(s.best_model_path)["step"]
    assert best.keys() == ckpt.read_checkpoint(s.best_model_path).keys()


def test_full_roundtrip_restores_everything(tmp_path):
    state = _port_state(ema=True)
    step = make_train_step(state.model, 0, NO_AUG, ema_decay=0.9)
    for seed in range(2):
        step(state, _batch(seed))
    manager = ckpt.CheckpointManager(str(tmp_path), save_top_k=1)
    path = manager.save(state, 0, {KEY: 0.5})
    fresh = _port_state(ema=True)
    manager.restore(path, fresh)
    assert fresh.step == state.step == 2
    for (k, v), w in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(v, w), k
    for k, v in state.ema_params.items():
        assert torch.equal(v, fresh.ema_params[k]), k
    want, got = state.optimizer.state_dict()["state"], fresh.optimizer.state_dict()["state"]
    assert want.keys() == got.keys()
    for i in want:
        for k in want[i]:
            assert torch.equal(want[i][k], got[i][k]), (i, k)


def test_slim_roundtrip(tmp_path):
    state = _port_state(ema=True)
    make_train_step(state.model, 0, NO_AUG, ema_decay=0.9)(state, _batch())
    manager = ckpt.CheckpointManager(str(tmp_path), save_top_k=2, resume_every=10)
    full = manager.save(state, 0, {KEY: 0.3})  # resume point: full
    slim = manager.save(state, 1, {KEY: 0.6})  # top-k only: slim
    manager.wait_until_finished()
    assert not _is_slim(full) and _is_slim(slim)
    assert "optimizer" in ckpt.read_checkpoint(full)
    assert "optimizer" not in ckpt.read_checkpoint(slim)
    with open(os.path.join(slim, ckpt.SLIM_MARKER)) as handle:
        assert json.load(handle)["layout"] == ["ema_params", "model", "step"]
    assert manager.latest_epoch == 0  # resume never targets a slim entry
    fresh = _port_state(ema=True)
    ckpt.load_checkpoint(slim, fresh)
    for (k, v), w in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(v, w), k
    for k, v in state.ema_params.items():
        assert torch.equal(v, fresh.ema_params[k]), k
    assert fresh.optimizer.state_dict()["state"] == {}  # the optimizer stays fresh
    # A checkpoint with an EMA needs a state built with one (JAX :396-402).
    with pytest.raises(ValueError, match="ema_params"):
        ckpt.load_checkpoint(slim, _port_state(ema=False))
    # A state with an EMA restored from a checkpoint without one drops it.
    plain = _port_state()
    no_ema = manager.save(plain, 2, {KEY: 0.9})
    manager.wait_until_finished()
    assert ckpt.load_checkpoint(no_ema, _port_state(ema=True)).ema_params is None


def test_write_error_surfaces_at_next_save(tmp_path, monkeypatch):
    manager = ckpt.CheckpointManager(str(tmp_path), save_top_k=1)
    state = _port_state()

    def disk_full(*args, **kwargs):
        raise RuntimeError("disk full")

    with monkeypatch.context() as patch:
        patch.setattr(ckpt.torch, "save", disk_full)
        manager.save(state, 0, {KEY: 0.5})
        with pytest.raises(RuntimeError, match="disk full"):
            manager.save(state, 1, {KEY: 0.6})
    # The manager stays usable: the next save lands.
    manager.save(state, 1, {KEY: 0.6})
    assert manager.latest_epoch == 1
    assert not any(n.endswith(".tmp") for n in os.listdir(manager.ckpt_dir)
                   if n.startswith("model-epoch=01"))


def test_snapshot_survives_in_place_steps(tmp_path):
    """An async save followed by more steps writes the pre-step values: the
    steps update the parameters and the Adam moments in place while the
    write is still pending."""
    state = _port_state()
    step = make_train_step(state.model, 0, NO_AUG)
    step(state, _batch(0))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    moments = {k: v.clone() for k, v in state.optimizer.state_dict()["state"][0].items()}
    manager = ckpt.CheckpointManager(str(tmp_path), save_top_k=1)
    write = manager._write

    def slow_write(*args):
        time.sleep(0.3)
        return write(*args)

    manager._write = slow_write
    path = manager.save(state, 0, {KEY: 0.5})
    for seed in (1, 2):
        step(state, _batch(seed))
    manager.wait_until_finished()
    saved = ckpt.read_checkpoint(path)
    assert saved["step"] == 1 and state.step == 3
    for k, v in before.items():
        assert torch.equal(saved["model"][k], v), k
    assert any(not torch.equal(v, state.model.state_dict()[k]) for k, v in before.items())
    for k, v in moments.items():
        assert torch.equal(saved["optimizer"]["state"][0][k], v), k


def test_restore_repacks_the_eval_cache(tmp_path):
    """load_state_dict copies into the parameters in place, which moves the
    eval pack cache's key (models/unet.py::DoubleConv._pack_key): the first
    eval after a restore does not reuse operands packed before it."""
    state = _port_state(conv_impl="pallas_fused")
    manager = ckpt.CheckpointManager(str(tmp_path), save_top_k=1, async_save=False)
    path = manager.save(state, 0, {KEY: 0.5})
    convs = [m for m in state.model.modules() if hasattr(m, "_pack_key")]
    y = torch.zeros(1)
    keys = [m._pack_key(y) for m in convs]
    manager.restore(path, state)
    assert all(m._pack_key(y) != k for m, k in zip(convs, keys))
    # And the eval after the restore runs on the restored weights.
    eval_step = make_eval_step(state.model, 0)
    got = eval_step(state, _batch(4))["loss"]
    fresh = _port_state(conv_impl="pallas_fused")
    manager.restore(path, fresh)
    assert torch.equal(got, make_eval_step(fresh.model, 0)(fresh, _batch(4))["loss"])
