"""The port's fused BN-apply + ReLU + conv3x3 (plain version and autograd
op, on the CPU) against the JAX package's oracle and its Pallas kernel.

The CUDA kernel itself runs only on the card; chip_smoke.py holds it to the
plain version there. Here: f32, absolute tolerance 1e-5 for the forward
(different summation orders) and 1e-4 for gradients, as
tests/test_conv_fused.py uses for the JAX kernel.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodplanet_code_tpu.ops import conv_fused as jax_conv_fused
from floodplanet_code_tpu_torch.ops import LAUNCHES, cuda_build
from floodplanet_code_tpu_torch.ops.conv_fused import (
    KERNEL,
    pack,
    relu_affine_conv3x3,
    relu_affine_conv3x3_cuda,
    relu_affine_conv3x3_plain,
    tile_config,
    unpack,
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
    # unpack() carries every packed stage back to the JAX kernel's HWIO
    # weight exactly; every element past C1 and C2 (tails in both here) is 0.
    c1, c2 = 70, 130
    y, a, b, w = _inputs(rng, (1, 8, 8, c1), c2)
    ap, bp, wp = pack(*_to_torch(y, a, b, w)[1:], dtype)
    if dtype == torch.bfloat16:  # [C2p/BN, C1p/64, 9, BN, 64], BN = 256
        assert wp.shape == (1, 2, 9, 256, 64) and ap.shape == bp.shape == (128,)
    else:  # [9, C1p, C2p]
        assert wp.shape == (9, 96, 192) and ap.shape == bp.shape == (96,)
    assert all(t.dtype == dtype for t in (ap, bp, wp))
    a2, b2, w2, pad = unpack(ap, bp, wp, c1, c2)
    assert torch.equal(w2.permute(2, 3, 1, 0), torch.from_numpy(w).to(dtype))
    assert torch.equal(a2, torch.from_numpy(a).to(dtype))
    assert torch.equal(b2, torch.from_numpy(b).to(dtype))
    assert pad.numel() == wp.numel() - 9 * c1 * c2 + 2 * (ap.numel() - c1)
    assert not pad.any()


def test_bf16_pack_is_the_swizzled_stage_image(rng):
    # Independently of unpack: stage (nt, kc, tap) row n holds w[co, ci] for
    # co = nt*BN + n, ci = kc*64 + k at the 16-byte group (k // 8) ^ (n % 8),
    # the 128-byte swizzle of the kernel's shared-memory descriptor.
    c1, c2 = 100, 300
    _, a, b, w = _inputs(rng, (1, 4, 4, c1), c2)
    wt = _to_torch(np.zeros((1, 4, 4, c1), np.float32), a, b, w)[3]
    wp = pack(torch.from_numpy(a), torch.from_numpy(b), wt, torch.bfloat16)[2].float().numpy()
    bn = tile_config(c2)[0]
    nt, kc, tap, n, pos = np.indices(wp.shape)
    k = ((pos // 8) ^ (n % 8)) * 8 + pos % 8
    co, ci = nt * bn + n, kc * 64 + k
    valid = (co < c2) & (ci < c1)
    want = w[tap // 3, tap % 3, np.minimum(ci, c1 - 1), np.minimum(co, c2 - 1)]
    want = torch.from_numpy(np.where(valid, want, 0.0)).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(wp, want)


def test_tile_configs_are_instantiated():
    # Every configuration tile_config picks for the UNet's C2 (and the
    # parity cases' tails) is one the CUDA source instantiates.
    src = open(cuda_build.source("conv_fused")).read()
    macro = src[src.index("#define FP_BF16_CONFIGS(X)"):].split("\n")[1]
    built = {tuple(int(v) for v in m.split(",")) for m in re.findall(r"X\(([\d, ]+)\)", macro)}
    for c2 in (7, 40, 64, 72, 96, 128, 200, 256, 300, 512):
        assert tile_config(c2) in built


def test_kernel_wrapper_refuses_cpu_tensors(rng):
    with pytest.raises(ValueError, match="CUDA tensor"):
        relu_affine_conv3x3_cuda(*_to_torch(*_inputs(rng, (1, 8, 8, 4), 4)))
