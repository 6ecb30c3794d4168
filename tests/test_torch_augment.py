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


# The map_coordinates rotation (JAX augment.py:78-100, 212-235): square
# crops under rotate_impl="map_coordinates", non-square crops under "auto",
# label fill 0 or ignore_index -1, random angles and exactly 90 and 45
# degrees (a 90-degree turn of an odd width puts source coordinates on
# half-integers, where nearest-neighbour rounding decides).
MC_CASES = {
    "square-map_coordinates": ((32, 32), dict(rotate_impl="map_coordinates")),
    "square-map_coordinates-fill": ((32, 32), dict(rotate_impl="map_coordinates",
                                                   fill_ignore=True)),
    "nonsquare-auto": ((24, 40), dict()),
    "nonsquare-auto-fill": ((24, 40), dict(fill_ignore=True)),
    "nonsquare-90-fill": ((24, 31), dict(min_rot_angle=90.0, max_rot_angle=90.0,
                                         fill_ignore=True)),
    "nonsquare-45": ((31, 24), dict(min_rot_angle=45.0, max_rot_angle=45.0)),
}


def _jax_source_coords(draws, h, w):
    """JAX's source coordinates per sample (augment.py:83-89), [B, H, W]."""
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = jnp.arange(h, dtype=jnp.float32)[None, :, None]
    xx = jnp.arange(w, dtype=jnp.float32)[None, None, :]
    a = jnp.asarray(draws.angles.numpy())[:, None, None]
    cos, sin = jnp.cos(a), jnp.sin(a)
    return (np.asarray(cos * (yy - cy) + sin * (xx - cx) + cy),
            np.asarray(-sin * (yy - cy) + cos * (xx - cx) + cx))


@pytest.mark.parametrize("case", list(MC_CASES))
def test_map_coordinates_rotation_matches_jax(case):
    """Images within 1e-5 absolute, on values uniform in [0, 1) (the scale
    of range-normalized inputs): XLA's jit rounds the coordinates'
    arithmetic differently from its own eager evaluation, which the port
    equals (test_map_coordinates_equals_jax_eager_bit_for_bit), and an ulp
    of a coordinate moves an image by that times the step between
    neighbouring pixels. Labels equal except where JAX's source coordinate
    lies within 1e-4 of a half-integer, on at most 0.1% of the pixels."""
    (h, w), kw = MC_CASES[case]
    jp, tp = _params(**kw)
    rng = np.random.default_rng(7)
    image = rng.random((6, h, w, 4), dtype=np.float32)
    target = rng.choice([0, 1, 2], (6, h, w)).astype(np.int32)
    ignore = -1
    key = jax.random.key(2)
    want_img, want_tgt = jax_augment(key, jnp.asarray(image), jnp.asarray(target), jp, ignore)
    draws = _jax_draws(key, 6, jp)
    assert draws.do_r.any() and not draws.do_r.all()
    got_img, got_tgt = apply_augmentation(torch.from_numpy(image), torch.from_numpy(target),
                                          draws, tp, ignore)
    assert got_img.dtype == torch.float32 and got_tgt.dtype == torch.int32
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), atol=1e-5, rtol=0)
    # Rotation runs after the flips on the flipped sample; its coordinates
    # do not depend on the pixels.
    src_y, src_x = _jax_source_coords(draws, h, w)
    near_half = ((np.abs(src_y - np.floor(src_y) - 0.5) < 1e-4)
                 | (np.abs(src_x - np.floor(src_x) - 0.5) < 1e-4))
    differ = got_tgt.numpy() != np.asarray(want_tgt)
    assert not (differ & ~near_half).any()
    assert differ.mean() <= 1e-3
    if kw.get("fill_ignore"):
        assert (got_tgt.numpy() == ignore).any()


def test_map_coordinates_equals_jax_eager_bit_for_bit():
    """Against JAX's augment_batch evaluated op by op (jax.disable_jit), on
    standard-normal images at 45 degrees: equal, images and labels. The
    jitted function rounds the coordinates' arithmetic otherwise."""
    (h, w), kw = MC_CASES["nonsquare-45"]
    jp, tp = _params(**kw)
    rng = np.random.default_rng(8)
    image = rng.standard_normal((6, h, w, 4)).astype(np.float32)
    target = rng.choice([0, 1, 2], (6, h, w)).astype(np.int32)
    key = jax.random.key(2)
    with jax.disable_jit():
        want_img, want_tgt = jax_augment(key, jnp.asarray(image), jnp.asarray(target), jp, 0)
    got_img, got_tgt = apply_augmentation(torch.from_numpy(image), torch.from_numpy(target),
                                          _jax_draws(key, 6, jp), tp, 0)
    np.testing.assert_array_equal(got_img.numpy(), np.asarray(want_img))
    np.testing.assert_array_equal(got_tgt.numpy(), np.asarray(want_tgt))


def test_map_coordinates_keeps_the_image_dtype_and_warns_per_shape(rng):
    """Non-square crops warn once per shape and take map_coordinates, which
    keeps the image's dtype whatever ``params.dtype`` says (JAX
    augment.py:221-235); square crops under "auto" shear silently."""
    import warnings

    tp = TransformParams(rotate_likelihood=1.0, dtype="float32")
    image, target = _batch(rng, hw=16)
    image = torch.from_numpy(np.ascontiguousarray(image[:, :, :12])).to(torch.bfloat16)
    target = torch.from_numpy(np.ascontiguousarray(target[:, :, :12]))
    draws = draw_augmentation(torch.Generator().manual_seed(0), 6, tp, "cpu")
    with pytest.warns(UserWarning, match="non-square crops 16x12"):
        img, tgt = apply_augmentation(image, target, draws, tp)
    assert img.dtype == torch.bfloat16 and img.shape == image.shape
    assert tgt.dtype == torch.int32
    square, square_tgt = _batch(rng, hw=16)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        apply_augmentation(torch.from_numpy(square), torch.from_numpy(square_tgt), draws, tp)
    with pytest.raises(ValueError, match="rotate_impl"):
        apply_augmentation(image, target, draws, TransformParams(rotate_impl="bicubic"))
