"""The port's train-mode BatchNorm + ReLU (ops/batchnorm.py, and
``BatchNormReLU`` in models/unet.py) against the JAX package's
``bn_relu_train`` and flax ``FusedBatchNormReLU`` on the CPU, in f32.

Forward and backward agree to 1e-5 (the two sum the statistics in other
orders); the running statistics after one train forward to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodplanet_code_tpu.models.unet import FusedBatchNormReLU
from floodplanet_code_tpu.ops.batchnorm import bn_relu_train as jax_bn_relu_train
from floodplanet_code_tpu_torch.models.unet import BatchNormReLU
from floodplanet_code_tpu_torch.ops.batchnorm import bn_relu_train

TOL = 1e-5


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _inputs(rng, c=6):
    x = (rng.standard_normal((3, 5, 7, c)) * 2 + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.3, c).astype(np.float32)
    dz = rng.standard_normal(x.shape).astype(np.float32)
    return x, scale, bias, dz


def test_forward_and_backward_match_jax_vjp(rng):
    x, scale, bias, dz = _inputs(rng)
    (z, mean, var), vjp = jax.vjp(
        lambda x, s, b: jax_bn_relu_train(x, s, b, 1e-5, None),
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
    )
    dx, dscale, dbias = vjp((jnp.asarray(dz), jnp.zeros_like(mean), jnp.zeros_like(var)))

    tx = _nchw(x).requires_grad_(True)
    ts = torch.from_numpy(scale).requires_grad_(True)
    tb = torch.from_numpy(bias).requires_grad_(True)
    tz, tmean, tvar = bn_relu_train(tx, ts, tb, 1e-5)
    assert not tmean.requires_grad and not tvar.requires_grad
    tz.backward(_nchw(dz))
    for got, want in [(_nhwc(tz), z), (tmean, mean), (tvar, var), (_nhwc(tx.grad), dx),
                      (ts.grad, dscale), (tb.grad, dbias)]:
        got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
        np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


def test_f64_input_keeps_f64_statistics(rng):
    """An f64 x (the f64 reference step on the card) computes its statistics
    and backward in f64: equal to autograd through the textbook expression
    to 1e-12, where f32 statistics would miss by ~1e-7."""
    x, scale, bias, dz = (torch.from_numpy(v).double() for v in _inputs(rng))
    x, dz = _nchw(x.numpy()), _nchw(dz.numpy())
    grads = []
    for fn in ("port", "textbook"):
        tx, ts, tb = (t.clone().requires_grad_(True) for t in (x, scale, bias))
        if fn == "port":
            z, mean, var = bn_relu_train(tx, ts, tb, 1e-5)
            assert mean.dtype == var.dtype == torch.float64
        else:
            mu = tx.mean(dim=(0, 2, 3), keepdim=True)
            v = tx.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
            z = torch.relu((tx - mu) / torch.sqrt(v + 1e-5) * ts.view(1, -1, 1, 1)
                           + tb.view(1, -1, 1, 1))
        z.backward(dz)
        grads.append([z.detach(), tx.grad, ts.grad, tb.grad])
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-12, rtol=1e-12)


def test_bf16_forward_rounds_like_jax(rng):
    x, scale, bias, _ = _inputs(rng)
    z = jax_bn_relu_train(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale),
                          jnp.asarray(bias), 1e-5, None)[0]
    tz = bn_relu_train(_nchw(x).bfloat16(), torch.from_numpy(scale),
                       torch.from_numpy(bias), 1e-5)[0]
    want = np.asarray(z.astype(jnp.float32))
    # a and b are identical; x*a + b may differ by one bf16 step where the
    # f32 statistics differ in their last bit.
    assert (np.abs(_nhwc(tz.float()) - want) <= 2.0**-7 * np.abs(want) + 1e-6).all()


@pytest.mark.parametrize("return_affine", [False, True], ids=["apply", "affine"])
def test_running_stats_match_flax(rng, return_affine):
    x, scale, bias, _ = _inputs(rng)
    mean0 = rng.normal(0, 0.2, 6).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    flax_bn = FusedBatchNormReLU(return_affine=return_affine)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    out, upd = flax_bn.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])

    bn = BatchNormReLU(6).train()
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.mean.copy_(torch.from_numpy(mean0))
        bn.var.copy_(torch.from_numpy(var0))
    version = bn.mean._version
    if return_affine:
        a, b = bn.batch_affine(_nchw(x))
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(out[0]), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(out[1]), atol=TOL, rtol=TOL)
    else:
        np.testing.assert_allclose(_nhwc(bn(_nchw(x))), np.asarray(out), atol=TOL, rtol=TOL)
    assert bn.mean._version > version  # in place: the eval pack cache sees it
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(upd["batch_stats"][name]), atol=1e-6, rtol=0)


def test_fold_is_eval_only():
    bn = BatchNormReLU(3).train()
    with pytest.raises(RuntimeError, match="eval-mode"):
        bn.fold()
    assert len(bn.eval().fold()) == 2
