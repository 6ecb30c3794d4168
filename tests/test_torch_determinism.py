"""``fit_model`` runs under deterministic algorithms (train/fit.py::
deterministic_algorithms) and gives the process its own setting back,
after a fit and after a fit that raises; the cuBLAS workspace setting it
needs on a card. The JAX fit is deterministic by construction and has no
such setting: its reproduction contract (ARCHITECTURE.md, resume) is what
the port's fit is held to, on the CPU by tests/test_torch_fit.py and on a
card by chip_smoke.py's fit phase. The forms that keep the mode from
costing time (the loss's class pick, the confusion counts) equal the ones
they replace bit for bit."""

import numpy as np
import pytest
import torch

from floodplanet_code_tpu_torch.config import compose
from floodplanet_code_tpu_torch.train import fit as fit_module
from floodplanet_code_tpu_torch.train import fit_model


def _overrides(root, *extra):
    return [
        "dataset.sensor=PS", "eval_region=RegionA", "crop_height=32", "crop_width=32",
        "crop_stride=32", "batch_size=4", "n_workers=2", "n_epochs=1",
        "limit_train_batches=2", "limit_val_batches=1", "tpu.compute_dtype=float32",
        "model.model_kwargs.base_feat_channels=8", "transforms.rotate.active=false",
        f"dataset.dataset_kwargs.root_dir={root}", *extra,
    ]


@pytest.fixture()
def steps_seen(monkeypatch):
    """fit_model's train steps, recording the deterministic setting each
    ran under; with ``raise_at`` set, that step raises."""
    seen = {"modes": [], "raise_at": None}
    make = fit_module.make_train_step

    def making(*args, **kwargs):
        step = make(*args, **kwargs)

        def recorded(state, batch, generator=None):
            seen["modes"].append((torch.are_deterministic_algorithms_enabled(),
                                  torch.is_deterministic_algorithms_warn_only_enabled()))
            if len(seen["modes"]) == seen["raise_at"]:
                raise RuntimeError("a step that fails")
            return step(state, batch, generator)

        return recorded

    monkeypatch.setattr(fit_module, "make_train_step", making)
    return seen


@pytest.fixture()
def restore_mode():
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    yield
    torch.use_deterministic_algorithms(before[0], warn_only=before[1])


@pytest.mark.parametrize("before", [(False, False), (True, True)], ids=["off", "warn_only"])
def test_fit_runs_deterministic_and_restores(synthetic_csdap_root, tmp_path, steps_seen,
                                             restore_mode, before):
    torch.use_deterministic_algorithms(before[0], warn_only=before[1])
    fill = torch.utils.deterministic.fill_uninitialized_memory
    fit_model(compose(overrides=_overrides(synthetic_csdap_root)),
              overwrite_exp_dir=str(tmp_path / "exp"), device="cpu")
    assert steps_seen["modes"] == [(True, False)] * 2
    assert (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled()) == before
    assert torch.utils.deterministic.fill_uninitialized_memory == fill


def test_fit_that_raises_restores(synthetic_csdap_root, tmp_path, steps_seen, restore_mode):
    torch.use_deterministic_algorithms(False)
    steps_seen["raise_at"] = 1
    with pytest.raises(RuntimeError, match="a step that fails"):
        fit_model(compose(overrides=_overrides(synthetic_csdap_root)),
                  overwrite_exp_dir=str(tmp_path / "exp"), device="cpu")
    assert steps_seen["modes"] == [(True, False)]
    assert not torch.are_deterministic_algorithms_enabled()


def test_cublas_workspace_config(monkeypatch):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    fit_module.check_cublas_workspace_config(torch.device("cpu"))
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG=:4096:8"):
        fit_module.check_cublas_workspace_config(torch.device("cuda"))
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":0:0")
    with pytest.raises(RuntimeError, match="it is ':0:0'"):
        fit_module.check_cublas_workspace_config(torch.device("cuda", 0))
    fit_module.set_cublas_workspace_config()  # an entry point keeps what is set
    assert fit_module.os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":0:0"
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG")
    fit_module.set_cublas_workspace_config()
    fit_module.check_cublas_workspace_config(torch.device("cuda"))


@pytest.mark.parametrize("per_sample", [False, True], ids=["one", "per_sample"])
def test_confusion_counts_equal_index_add(rng, per_sample):
    """The confusion counts by comparison equal an f32 ``index_add_`` of
    the 0/1 weights into the cells, bit for bit (ignored, out-of-range and
    padded pixels dropped)."""
    from floodplanet_code_tpu_torch.ops.metrics import confusion_from_preds

    preds = torch.from_numpy(rng.integers(0, 3, (4, 9, 11)))
    target = torch.from_numpy(rng.integers(-1, 4, (4, 9, 11)))
    weight = torch.tensor([1.0, 0.0, 1.0, 1.0])[:, None, None]
    got = confusion_from_preds(preds, target, 3, 0, weight, per_sample=per_sample)
    valid = (torch.broadcast_to(weight, target.shape) * (target != 0) * (target >= 0)
             * (target < 3)).float()
    index = target.clamp(0, 2) * 3 + preds
    n = 4 if per_sample else 1
    index = index + (torch.arange(4).view(4, 1, 1) * 9 if per_sample else 0)
    want = torch.zeros(n * 9).index_add_(0, index.reshape(-1), valid.reshape(-1))
    assert torch.equal(got.reshape(-1), want)


def test_pick_equals_gather_forward_and_backward(rng):
    """The loss's class pick by selection equals ``gather``, value and
    gradient, bit for bit."""
    from floodplanet_code_tpu_torch.ops.losses import _pick

    values = torch.from_numpy(rng.standard_normal((2, 3, 5, 7)).astype(np.float32))
    target = torch.from_numpy(rng.integers(0, 3, (2, 5, 7)))
    g = torch.from_numpy(rng.standard_normal((2, 5, 7)).astype(np.float32))
    ours, ref = values.clone().requires_grad_(), values.clone().requires_grad_()
    got, want = _pick(ours, target), ref.gather(1, target.unsqueeze(1)).squeeze(1)
    assert torch.equal(got, want)
    got.backward(g)
    want.backward(g)
    assert torch.equal(ours.grad, ref.grad)
