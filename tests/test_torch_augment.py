"""The port's augmentation (floodplanet_code_tpu_torch/data/augment.py)
against the JAX package's ``augment_batch`` on the CPU.

torch cannot replay ``jax.random``, so each test reproduces the draws that
JAX's ``augment_batch`` makes from its key (augment.py:118-140) and feeds
them to the port's ``apply_augmentation``. The JAX Pallas shear runs in
interpret mode. Images agree to 1e-5, targets exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodplanet_code_tpu.data.augment import TransformParams as JParams
from floodplanet_code_tpu.data.augment import augment_batch as jax_augment
from floodplanet_code_tpu.ops import rotate as jrot
from floodplanet_code_tpu_torch.data.augment import (
    AugmentDraws,
    TransformParams,
    apply_augmentation,
    augment_batch,
    draw_augmentation,
)


@pytest.fixture()
def interpret_mode():
    old = jrot._INTERPRET
    jrot._INTERPRET = True
    jrot._shear_x_pallas_batch.clear_cache()
    yield
    jrot._INTERPRET = old
    jrot._shear_x_pallas_batch.clear_cache()


def _jax_draws(key, b, p: JParams) -> AugmentDraws:
    """augment.py:118-140 outside the jit, as torch tensors."""
    k_h, k_v, k_r, k_a = jax.random.split(key, 4)
    off = jnp.zeros((b,), bool)
    do_h = jax.random.uniform(k_h, (b,)) < p.hflip_likelihood if p.hflip_active else off
    do_v = jax.random.uniform(k_v, (b,)) < p.vflip_likelihood if p.vflip_active else off
    do_r = jax.random.uniform(k_r, (b,)) < p.rotate_likelihood if p.rotate_active else off
    angles = jax.random.uniform(
        k_a, (b,), minval=p.min_rot_angle, maxval=p.max_rot_angle
    ) * (jnp.pi / 180.0)
    angles = jnp.where(do_r, angles, 0.0)
    t = lambda v: torch.from_numpy(np.array(v))  # noqa: E731
    return AugmentDraws(t(do_h), t(do_v), t(do_r), t(angles))


def _batch(rng, b=6, hw=32, c=4):
    image = rng.standard_normal((b, hw, hw, c)).astype(np.float32)
    target = rng.choice([0, 1, 2], (b, hw, hw)).astype(np.int32)
    return image, target


def _params(**kw):
    fields = dict(hflip_active=True, hflip_likelihood=0.5, vflip_active=True,
                  vflip_likelihood=0.5, rotate_active=True, rotate_likelihood=0.7,
                  min_rot_angle=0.0, max_rot_angle=360.0)
    fields.update(kw)
    return JParams(**fields), TransformParams(**fields)


CASES = {
    "shear": dict(rotate_impl="shear"),
    "shear-fill-ignore": dict(rotate_impl="shear", fill_ignore=True),
    "shear_pallas": dict(rotate_impl="shear_pallas"),
    "shear_pallas-fill-ignore": dict(rotate_impl="shear_pallas", fill_ignore=True),
    "flips-only": dict(rotate_active=False),
    "inactive": dict(hflip_active=False, vflip_active=False, rotate_active=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_apply_matches_jax_augment_batch(rng, interpret_mode, case):
    jp, tp = _params(**CASES[case])
    image, target = _batch(rng)
    ignore = 2  # a class id, so fill_ignore is visible in the target
    key = jax.random.key(2)  # draws cover every flip pair, rotated and not
    want_img, want_tgt = jax_augment(key, jnp.asarray(image), jnp.asarray(target), jp, ignore)
    draws = _jax_draws(key, image.shape[0], jp)
    if tp.rotate_active:
        assert draws.do_r.any() and not draws.do_r.all() and (draws.do_h ^ draws.do_v).any()
    got_img, got_tgt = apply_augmentation(
        torch.from_numpy(image), torch.from_numpy(target), draws, tp, ignore
    )
    assert got_tgt.dtype == torch.int32
    np.testing.assert_allclose(got_img.float().numpy(), np.asarray(want_img), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got_tgt.numpy(), np.asarray(want_tgt))


def test_draws_follow_the_params():
    tp = TransformParams(rotate_likelihood=1.0, min_rot_angle=10.0, max_rot_angle=20.0,
                         hflip_active=False)
    gen = torch.Generator().manual_seed(3)
    d = draw_augmentation(gen, 64, tp, "cpu")
    assert not d.do_h.any() and d.do_r.all()
    deg = d.angles * (180.0 / np.pi)
    assert ((deg >= 10.0 - 1e-4) & (deg <= 20.0 + 1e-4)).all()
    again = draw_augmentation(torch.Generator().manual_seed(3), 64, tp, "cpu")
    assert torch.equal(d.do_v, again.do_v) and torch.equal(d.angles, again.angles)


def test_bf16_augment_keeps_labels_exact(rng):
    tp = TransformParams(rotate_likelihood=1.0, dtype="bfloat16", rotate_impl="shear_pallas")
    image, target = _batch(rng)
    img, tgt = augment_batch(torch.Generator().manual_seed(0), torch.from_numpy(image),
                             torch.from_numpy(target), tp, 0)
    assert img.dtype == torch.bfloat16 and tgt.dtype == torch.int32
    assert set(np.unique(tgt.numpy())) <= {0, 1, 2}


@pytest.mark.parametrize("fill_ignore", [False, True, None], ids=["keep", "fill", "unset"])
def test_from_config_matches_jax(fill_ignore):
    from floodplanet_code_tpu.config import Config as JConfig
    from floodplanet_code_tpu_torch.config import Config

    rotate = dict(active=True, likelihood=0.3, min_rot_angle=10, max_rot_angle=200)
    if fill_ignore is not None:
        rotate["fill_ignore"] = fill_ignore
    cfg = dict(hflip=dict(active=False, likelihood=0.4),
               vflip=dict(active=True, likelihood=0.6), rotate=rotate)
    got = TransformParams.from_config(Config(cfg))
    assert dataclasses.asdict(got) == dataclasses.asdict(JParams.from_config(JConfig(cfg)))
    inactive = TransformParams.from_config(None)
    assert dataclasses.asdict(inactive) == dataclasses.asdict(JParams.from_config(None))
    assert not inactive.any_active


@pytest.mark.parametrize("kw", [dict(rotate_impl="map_coordinates"), dict()])
def test_unported_rotations_raise(rng, kw):
    tp = TransformParams(**kw)
    image, target = _batch(rng, hw=16)
    if not kw:  # non-square crops
        image, target = image[:, :, :12], target[:, :, :12]
    draws = draw_augmentation(torch.Generator().manual_seed(0), 6, tp, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        apply_augmentation(torch.from_numpy(np.ascontiguousarray(image)),
                           torch.from_numpy(np.ascontiguousarray(target)), draws, tp)
