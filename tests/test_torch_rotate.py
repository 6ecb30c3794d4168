"""The port's shear and rotation (floodplanet_code_tpu_torch/ops/rotate.py)
against the JAX package's ops/rotate.py on the CPU.

The JAX Pallas row-shear runs in interpret mode (the fixture pattern of
tests/test_rotate.py); the port's ``impl="pallas"`` runs its plain version
on a CPU tensor, the oracle its CUDA kernel is held to on the card. f32
agrees to 1e-6 (the blend is the same two products and a sum; XLA may
contract them into an FMA); label and validity channels (nearest) are
equal; bf16 is within one bf16 rounding step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodplanet_code_tpu.ops import rotate as jrot
from floodplanet_code_tpu_torch.ops import LAUNCHES
from floodplanet_code_tpu_torch.ops import rotate as trot

ANGLES = [17.0, 133.0, 251.0, 344.0]
FLIP_H = [False, True, False, True]
FLIP_V = [False, False, True, True]


@pytest.fixture()
def interpret_mode():
    old = jrot._INTERPRET
    jrot._INTERPRET = True
    jrot._shear_x_pallas_batch.clear_cache()
    yield
    jrot._INTERPRET = old
    jrot._shear_x_pallas_batch.clear_cache()


def _combined(rng, b, hw, n_img):
    """[image | label | validity] as augment_batch builds it."""
    img = rng.random((b, hw, hw, n_img)).astype(np.float32)
    lbl = rng.integers(0, 3, (b, hw, hw, 1)).astype(np.float32)
    return np.concatenate([img, lbl, np.ones((b, hw, hw, 1), np.float32)], axis=-1)


def _jax_rotate_flip(x, impl, nearest_from, dtype=jnp.float32):
    b = x.shape[0]
    out = jrot.rotate_flip_batch(
        jnp.asarray(x, dtype), jnp.asarray(ANGLES[:b]), jnp.asarray(FLIP_H[:b]),
        jnp.asarray(FLIP_V[:b]), order=1, cval=0.0, impl=impl, nearest_from=nearest_from,
    )
    return np.asarray(out.astype(jnp.float32))


def _torch_rotate_flip(x, impl, nearest_from, dtype=torch.float32):
    b = x.shape[0]
    out = trot.rotate_flip_batch(
        torch.from_numpy(x).to(dtype), torch.tensor(ANGLES[:b]), torch.tensor(FLIP_H[:b]),
        torch.tensor(FLIP_V[:b]), order=1, cval=0.0, impl=impl, nearest_from=nearest_from,
    )
    return out.float().numpy()


@pytest.mark.parametrize(
    "b,hw,n_img,nearest",
    [(4, 32, 3, False), (1, 300, 4, True), (2, 48, 2, True)],
    ids=["32px-c3", "300px-all-rows", "mixed-order"],
)
def test_pallas_rotate_flip_matches_jax(rng, interpret_mode, b, hw, n_img, nearest):
    x = _combined(rng, b, hw, n_img)
    nf = n_img if nearest else None
    want = _jax_rotate_flip(x, "pallas", nf)
    before = LAUNCHES["shear"]
    got = _torch_rotate_flip(x, "pallas", nf)
    assert LAUNCHES["shear"] == before  # a CPU tensor runs the plain version
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[..., :n_img], want[..., :n_img], atol=1e-6, rtol=0)
    if nearest:
        np.testing.assert_array_equal(got[..., n_img:], want[..., n_img:])
    else:
        np.testing.assert_allclose(got[..., n_img:], want[..., n_img:], atol=1e-6, rtol=0)


@pytest.mark.parametrize("axis", [2, 1])
@pytest.mark.parametrize("order", [0, 1])
def test_shear_plain_matches_jax_pallas(rng, interpret_mode, axis, order):
    # One shear along each axis at both orders, slopes up to sin(45 deg).
    x = _combined(rng, 3, 40, 3)
    shear = np.asarray([-0.7071, 0.18, 0.4142], np.float32)
    jfn = jrot._shear_x_batch if axis == 2 else jrot._shear_y_batch
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(shear), order, 0.0, "pallas", 3))
    shifts = trot._row_shifts(torch.from_numpy(shear), 40)
    got = trot.shear_plain(torch.from_numpy(x), shifts, order, 0.0, 3, axis).numpy()
    np.testing.assert_allclose(got[..., :3], want[..., :3], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[..., 3:], want[..., 3:])


@pytest.mark.parametrize("axis", [2, 1])
@pytest.mark.parametrize("order", [0, 1])
def test_shear_plain_matches_jax_pallas_at_quantization_edges(rng, interpret_mode, axis, order):
    # On 41 lines (odd: every line offset from the centre is an integer):
    # slope +-1 makes every shift an exact integer and the outer lines pass
    # +-(pad-1), where the clip binds; slope 3/2^17 puts frac*65536 on a .5
    # tie at every odd offset (both sides round half to even).
    n = 41
    x = _combined(rng, 3, n, 3)
    shear = np.asarray([1.0, 3.0 / 131072.0, -1.0], np.float32)
    shifts = trot._row_shifts(torch.from_numpy(shear), n)
    pad = trot._pad(n)
    assert (shifts.abs() > pad - 1).any() and torch.equal(shifts[0], shifts[0].round())
    assert ((shifts[1] * 65536.0).frac().abs() == 0.5).any()
    jfn = jrot._shear_x_batch if axis == 2 else jrot._shear_y_batch
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(shear), order, 0.0, "pallas", 3))
    got = trot.shear_plain(torch.from_numpy(x), shifts, order, 0.0, 3, axis).numpy()
    np.testing.assert_allclose(got[..., :3], want[..., :3], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[..., 3:], want[..., 3:])


def test_bf16_within_one_rounding_step(rng, interpret_mode):
    # The JAX Pallas body stores its f32 blend into the bf16 output ref,
    # which this JAX version refuses at trace time ("Invalid dtype for
    # swap"), so JAX's bf16 result is taken as its f32 kernel on the
    # bf16-rounded input, rounded once to bf16 after every shear: the
    # kernel's function (blend in f32, one rounding at the store).
    x = _combined(rng, 4, 32, 4)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    b = x.shape[0]
    k, residual = trot._reduce_angles(torch.tensor(ANGLES), "cpu")
    sigma = np.where(np.asarray(FLIP_H) ^ np.asarray(FLIP_V), -1.0, 1.0).astype(np.float32)
    theta = torch.from_numpy(sigma) * residual * (np.pi / 180.0)
    a = jnp.asarray((-torch.tan(theta / 2.0)).numpy())
    s = jnp.asarray(torch.sin(theta).numpy())

    def rnd(v):
        return v.astype(jnp.bfloat16).astype(jnp.float32)

    out = rnd(jrot._shear_x_batch(jnp.asarray(xb), a, 1, 0.0, "pallas", 4))
    out = rnd(jrot._shear_y_batch(out, s, 1, 0.0, "pallas", 4))
    out = rnd(jrot._shear_x_batch(out, a, 1, 0.0, "pallas", 4))
    k = np.asarray(k)
    h, v = np.asarray(FLIP_H[:b]), np.asarray(FLIP_V[:b])
    fh = np.choose(k, [v, ~h, ~v, h])
    fw = np.choose(k, [h, v, ~h, ~v])
    want = np.asarray(jrot.dihedral_batch(out, jnp.asarray(k % 2 == 1), jnp.asarray(fh),
                                          jnp.asarray(fw)))
    got = _torch_rotate_flip(x, "pallas", 4, torch.bfloat16)
    # One bf16 step at |v| is at most 2^-7 |v| (8 significand bits).
    assert (np.abs(got - want) <= 2.0**-7 * np.abs(want)).all()
    np.testing.assert_array_equal(got[..., 4:], want[..., 4:])


@pytest.mark.parametrize("impl", ["gather", "roll"])
def test_gather_matches_jax_gather(rng, impl):
    # The port's "roll" is the same gather: the JAX roll backend computes
    # that function (its clip never binds), so both meet JAX's gather.
    x = _combined(rng, 4, 48, 3)
    want = _jax_rotate_flip(x, "gather", 3)
    got = _torch_rotate_flip(x, impl, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("order", [0, 1])
def test_rotate_batch_matches_jax(rng, order):
    x = rng.random((4, 32, 32, 2)).astype(np.float32)
    want = np.asarray(jrot.rotate_batch(jnp.asarray(x), jnp.asarray(ANGLES), order=order))
    got = trot.rotate_batch(torch.from_numpy(x), torch.tensor(ANGLES), order=order).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_shear_checks_its_arguments():
    img = torch.zeros(2, 8, 8, 3)
    with pytest.raises(ValueError, match="shifts"):
        trot.shear(img, torch.zeros(2, 7))
    with pytest.raises(ValueError, match="axis"):
        trot.shear(img, torch.zeros(2, 8), axis=3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        trot.shear_cuda(img, torch.zeros(2, 8))
    with pytest.raises(ValueError, match="square"):
        trot.rotate_flip_batch(torch.zeros(1, 8, 9, 1), torch.zeros(1),
                               torch.zeros(1, dtype=torch.bool),
                               torch.zeros(1, dtype=torch.bool))
