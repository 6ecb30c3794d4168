"""The port's losses and metrics (ops/losses.py, ops/metrics.py) against the
JAX package's on the CPU: same logits (NHWC there, NCHW here) and targets,
agreement to 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodplanet_code_tpu.ops import losses as jl
from floodplanet_code_tpu.ops import metrics as jm
from floodplanet_code_tpu_torch.ops import losses as tl
from floodplanet_code_tpu_torch.ops import metrics as tm

TOL = 1e-6


def _data(rng, c=3, target_values=None):
    logits = (rng.standard_normal((2, 9, 11, c)) * 2).astype(np.float32)
    values = list(range(c)) + [-1, c] if target_values is None else target_values
    target = rng.choice(values, (2, 9, 11)).astype(np.int32)
    return logits, target


def _t(logits):
    return torch.from_numpy(np.ascontiguousarray(logits.transpose(0, 3, 1, 2)))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL, rtol=TOL)


WEIGHT = np.asarray([1.0, 0.0, 1.0], np.float32)[:, None, None]  # drop sample 1


@pytest.mark.parametrize("ignore", [0, None, 2])
@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy(rng, ignore, weighted):
    # Targets include -1 and n_classes: always dropped, never clipped in.
    logits, target = _data(rng)
    sw = WEIGHT[:2] if weighted else None
    want = jl.cross_entropy_ignore(jnp.asarray(logits), jnp.asarray(target), ignore,
                                   sample_weight=None if sw is None else jnp.asarray(sw))
    got = tl.cross_entropy_ignore(_t(logits), torch.from_numpy(target), ignore,
                                  sample_weight=None if sw is None else torch.from_numpy(sw))
    _close(got, want)


def test_all_ignored_is_zero_not_nan(rng):
    logits, _ = _data(rng)
    target = np.zeros((2, 9, 11), np.int32)
    for fn_t, fn_j in [(tl.cross_entropy_ignore, jl.cross_entropy_ignore)]:
        got = fn_t(_t(logits), torch.from_numpy(target), 0)
        assert got.item() == 0.0 == float(fn_j(jnp.asarray(logits), jnp.asarray(target), 0))
    cw = np.asarray([0.2, 1.0, 3.0], np.float32)
    got = tl.weighted_cross_entropy(_t(logits), torch.from_numpy(target), torch.from_numpy(cw), 0)
    assert got.item() == 0.0


@pytest.mark.parametrize("ignore", [0, None])
def test_weighted_cross_entropy(rng, ignore):
    logits, target = _data(rng)
    cw = np.asarray([0.2, 1.0, 3.0], np.float32)
    want = jl.weighted_cross_entropy(jnp.asarray(logits), jnp.asarray(target),
                                     jnp.asarray(cw), ignore)
    got = tl.weighted_cross_entropy(_t(logits), torch.from_numpy(target),
                                    torch.from_numpy(cw), ignore)
    _close(got, want)


@pytest.mark.parametrize("ignore", [0, None])
def test_dice_loss(rng, ignore):
    logits, target = _data(rng)
    sw = WEIGHT[:2]
    want = jl.dice_loss(jnp.asarray(logits), jnp.asarray(target), ignore,
                        sample_weight=jnp.asarray(sw))
    got = tl.dice_loss(_t(logits), torch.from_numpy(target), ignore,
                       sample_weight=torch.from_numpy(sw))
    _close(got, want)


@pytest.mark.parametrize("ignore", [0, 2, None, -1])
def test_confusion_and_metrics(rng, ignore):
    logits, target = _data(rng, c=4)
    sw = WEIGHT[:2]
    want = jm.confusion_from_logits(jnp.asarray(logits), jnp.asarray(target), ignore,
                                    sample_weight=jnp.asarray(sw))
    got = tm.confusion_from_logits(_t(logits), torch.from_numpy(target), ignore,
                                   sample_weight=torch.from_numpy(sw))
    assert got.dtype == torch.float32 and got.shape == (4, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want_m = jm.compute_metrics(want, "val_", ignore)
    got_m = tm.compute_metrics(got, "val_", ignore)
    assert set(got_m) == set(want_m)
    for key in want_m:
        _close(got_m[key], want_m[key])


def test_binary_metrics_and_key_names(rng):
    logits, target = _data(rng)
    cm_j = jm.confusion_from_logits(jnp.asarray(logits), jnp.asarray(target), 0)
    cm_t = tm.confusion_from_logits(_t(logits), torch.from_numpy(target), 0)
    want = jm.compute_binary_class_metrics(cm_j, 1, "test_")
    got = tm.compute_binary_class_metrics(cm_t, 1, "test_")
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key])
    empty = tm.compute_binary_class_metrics(torch.zeros(3, 3))
    assert all(v.item() == 0.0 for v in empty.values())
    assert tm.torchmetrics_key_names("val_") == jm.torchmetrics_key_names("val_")
