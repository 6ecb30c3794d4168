"""The port's fused BN-apply + ReLU + conv3x3 (plain version and autograd
op, on the CPU) against the JAX package's oracle and its Pallas kernel.

The CUDA kernel itself runs only on the card; chip_smoke.py holds it to the
plain version there. Here: f32, absolute tolerance 1e-5 for the forward
(different summation orders) and 1e-4 for gradients, as
tests/test_conv_fused.py uses for the JAX kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodplanet_code_tpu.ops import conv_fused as jax_conv_fused
from floodplanet_code_tpu_torch.ops import LAUNCHES
from floodplanet_code_tpu_torch.ops.conv_fused import (
    KERNEL,
    pack,
    relu_affine_conv3x3,
    relu_affine_conv3x3_cuda,
    relu_affine_conv3x3_plain,
)


def _inputs(rng, shape, c2):
    y = rng.standard_normal(shape).astype(np.float32)
    a = rng.standard_normal(shape[-1]).astype(np.float32)
    # b > 0: a border that wrongly padded with relu(b) instead of 0 fails.
    b = (np.abs(rng.standard_normal(shape[-1])) + 0.5).astype(np.float32)
    w = (rng.standard_normal((3, 3, shape[-1], c2)) * 0.1).astype(np.float32)
    return y, a, b, w


def _to_torch(y, a, b, w):
    """JAX layouts (NHWC, HWIO) -> the port's (NCHW channels_last, OIHW)."""
    return (
        torch.from_numpy(y).permute(0, 3, 1, 2),
        torch.from_numpy(a),
        torch.from_numpy(b),
        torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
    )


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("fn", [relu_affine_conv3x3_plain, relu_affine_conv3x3])
@pytest.mark.parametrize("shape,c2", [((2, 16, 16, 8), 12), ((1, 13, 11, 5), 7)])
def test_forward_matches_xla_reference(rng, fn, shape, c2):
    y, a, b, w = _inputs(rng, shape, c2)
    want = np.asarray(jax_conv_fused.xla_reference(*map(jnp.asarray, (y, a, b, w))))
    np.testing.assert_allclose(_nhwc(fn(*_to_torch(y, a, b, w))), want, atol=1e-5, rtol=0)


def test_forward_matches_pallas_interpret(rng):
    # The Pallas kernel needs H divisible by its strip height, so only the
    # even shape runs here; the odd one runs against xla_reference above.
    y, a, b, w = _inputs(rng, (2, 16, 16, 8), 12)
    want = np.asarray(
        jax_conv_fused.relu_affine_conv3x3(*map(jnp.asarray, (y, a, b, w)), True)
    )
    got = relu_affine_conv3x3(*_to_torch(y, a, b, w))
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-5, rtol=0)


def test_gradients_match_jax_vjp(rng):
    y, a, b, w = _inputs(rng, (1, 16, 16, 8), 8)
    g = rng.standard_normal((1, 16, 16, 8)).astype(np.float32)
    _, vjp = jax.vjp(jax_conv_fused.xla_reference, *map(jnp.asarray, (y, a, b, w)))
    want = [np.asarray(v) for v in vjp(jnp.asarray(g))]

    inputs = [t.clone().requires_grad_(True) for t in _to_torch(y, a, b, w)]
    out = relu_affine_conv3x3(*inputs)
    out.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    got = [
        _nhwc(inputs[0].grad),
        inputs[1].grad.numpy(),
        inputs[2].grad.numpy(),
        inputs[3].grad.numpy().transpose(2, 3, 1, 0),
    ]
    for name, gv, wv in zip("yabw", got, want):
        np.testing.assert_allclose(gv, wv, atol=1e-4, rtol=0, err_msg=name)


def test_cpu_tensor_never_counts_a_launch(rng):
    before = LAUNCHES[KERNEL]
    relu_affine_conv3x3(*_to_torch(*_inputs(rng, (1, 8, 8, 4), 4)))
    assert LAUNCHES[KERNEL] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_lays_out_jax_hwio_taps_zero_padded(rng, dtype):
    # The kernel's weight operand is the JAX kernel's HWIO weight with the
    # two tap axes merged (tap = dy*3 + dx), zero-padded to whole blocks.
    y, a, b, w = _inputs(rng, (1, 8, 8, 5), 7)
    ap, bp, wp = pack(*_to_torch(y, a, b, w)[1:], dtype)
    assert wp.shape == (9, 32, 64) and ap.shape == bp.shape == (32,)
    assert all(t.dtype == dtype for t in (ap, bp, wp))
    want = torch.from_numpy(w.reshape(9, 5, 7)).to(dtype)
    assert torch.equal(wp[:, :5, :7], want)
    assert not wp[:, 5:].any() and not wp[:, :, 7:].any()
    assert torch.equal(ap[:5], torch.from_numpy(a).to(dtype)) and not ap[5:].any()
    assert torch.equal(bp[:5], torch.from_numpy(b).to(dtype)) and not bp[5:].any()


def test_kernel_wrapper_refuses_cpu_tensors(rng):
    with pytest.raises(ValueError, match="CUDA tensor"):
        relu_affine_conv3x3_cuda(*_to_torch(*_inputs(rng, (1, 8, 8, 4), 4)))
