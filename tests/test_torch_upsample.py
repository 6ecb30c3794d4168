"""The port's 2x bilinear upsample (models/unet.py::_upsample2x) against
``F.interpolate`` and the JAX package's ``_upsample2x``.

Its forward is ``F.interpolate`` itself: bit for bit. Its backward is its
own (``_Upsample2x``: the half-pixel stencil's adjoint, or the transposed
align_corners matrices, in f32 and rounded once) and is held to autograd
through ``F.interpolate`` on the CPU (f32 1e-6 of the largest element,
bf16 within one rounding step of it) and to ``jax.vjp`` of the JAX
``_upsample2x(x, False, "conv")`` and ``_upsample2x(x, True)`` (f32 1e-5).
Heights and widths 1-7, odd and even, each in one shape of 7 (h, 8 - h).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from floodplanet_code_tpu.models.unet import _upsample2x as jax_upsample2x
from floodplanet_code_tpu_torch.models.unet import _upsample2x

SHAPES = [(h, 8 - h) for h in range(1, 8)]  # every height and width 1-7
TOL = {torch.float32: 1e-6, torch.bfloat16: 2 ** -7}  # of the largest element


def _interpolate(x, align_corners):
    h, w = x.shape[-2:]
    return F.interpolate(x, size=(2 * h, 2 * w), mode="bilinear",
                         align_corners=align_corners)


def _inputs(rng, hw, dtype, channels_last):
    x = torch.from_numpy(rng.standard_normal((2, 3, *hw)).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.standard_normal((2, 3, 2 * hw[0], 2 * hw[1]))
                         .astype(np.float32)).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    return x, g


@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("align_corners", [False, True], ids=["half_pixel", "align_corners"])
def test_matches_interpolate(rng, align_corners, dtype, channels_last):
    for hw in SHAPES:
        x, g = _inputs(rng, hw, dtype, channels_last)
        ours, ref = x.clone().requires_grad_(), x.clone().requires_grad_()
        y = _upsample2x(ours, align_corners)
        want = _interpolate(ref, align_corners)
        assert y.dtype == want.dtype and torch.equal(y, want), hw
        y.backward(g)
        want.backward(g)
        assert ours.grad.dtype == dtype and ours.grad.shape == x.shape
        assert ours.grad.is_contiguous(
            memory_format=torch.channels_last if channels_last else torch.contiguous_format)
        got, ref_grad = ours.grad.double(), ref.grad.double()
        err = (got - ref_grad).abs().max() / ref_grad.abs().max()
        assert err <= TOL[dtype], (hw, err.item())


@pytest.mark.parametrize("align_corners", [False, True], ids=["half_pixel", "align_corners"])
def test_backward_matches_jax_vjp(rng, align_corners):
    for hw in SHAPES:
        x, g = _inputs(rng, hw, torch.float32, True)
        xt = x.clone().requires_grad_()
        _upsample2x(xt, align_corners).backward(g)
        nhwc = lambda t: jnp.asarray(t.permute(0, 2, 3, 1).numpy())  # noqa: E731
        if align_corners:
            fn = lambda v: jax_upsample2x(v, True)  # noqa: E731
        else:
            fn = lambda v: jax_upsample2x(v, False, "conv")  # noqa: E731
        _, vjp = jax.vjp(fn, nhwc(x))
        want = np.asarray(vjp(nhwc(g))[0]).transpose(0, 3, 1, 2)
        got = xt.grad.numpy()
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-5, (hw, err)


@pytest.mark.parametrize("align_corners", [False, True], ids=["half_pixel", "align_corners"])
def test_no_grad_forward_is_interpolate(rng, align_corners):
    """Serving and export (no gradient) run ``F.interpolate`` alone."""
    x, _ = _inputs(rng, (5, 6), torch.bfloat16, True)
    with torch.no_grad():
        assert torch.equal(_upsample2x(x, align_corners), _interpolate(x, align_corners))
    with torch.inference_mode():
        assert torch.equal(_upsample2x(x, align_corners), _interpolate(x, align_corners))
