"""The port's train-mode BatchNorm + ReLU (ops/batchnorm.py, and
``BatchNormReLU`` in models/unet.py) against the JAX package's
``bn_relu_train`` and flax ``FusedBatchNormReLU`` on the CPU, in f32.

Forward and backward agree to 1e-5 (the two sum the statistics in other
orders); the running statistics after one train forward to 1e-6.

The kernel path (``csrc/batchnorm.cu``) runs only on a card
(``chip_smoke.py::bn_relu_parity``); here its wrapper runs against a
stand-in for the C functions that computes with the plain expressions over
the memory the pointers name, so that every argument is checked where the
C code reads it. Also: the checks that raise before any build, the grid at
every BatchNorm shape of both benchmark configurations, and the tracer's
counters.
"""

import contextlib
import ctypes
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from floodplanet_code_tpu.models.unet import FusedBatchNormReLU
from floodplanet_code_tpu.ops.batchnorm import bn_relu_train as jax_bn_relu_train
from floodplanet_code_tpu_torch.models.unet import BatchNormReLU
from floodplanet_code_tpu_torch.ops import LAUNCHES, batchnorm, cuda_build
from floodplanet_code_tpu_torch.ops.batchnorm import bn_relu_train
from floodplanet_code_tpu_torch.utils import trace

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


def test_cpu_tensor_takes_the_plain_path_and_counts_it(rng, monkeypatch):
    monkeypatch.setattr(trace.TRACER, "enabled", True)
    x, scale, bias, dz = _inputs(rng)
    before, launches = trace.counters(), LAUNCHES[batchnorm.KERNEL]
    tx = _nchw(x).requires_grad_(True)
    z = bn_relu_train(tx, torch.from_numpy(scale), torch.from_numpy(bias))[0]
    z.backward(_nchw(dz))
    after = trace.counters()
    for name, calls in (("bn_relu.plain", 2), ("bn_relu.kernel", 0)):  # a forward, a backward
        assert after.get(name, 0) - before.get(name, 0) == calls
    assert LAUNCHES[batchnorm.KERNEL] == launches


def test_kernel_checks_raise_before_any_build(monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("a build was tried")

    monkeypatch.setattr(cuda_build, "build", no_build)
    monkeypatch.setattr(cuda_build, "load", no_build)
    x, s = torch.zeros(2, 3, 4, 4), torch.ones(3)
    with pytest.raises(TypeError, match="float16"):
        batchnorm.forward_cuda(x.half(), s, s)
    with pytest.raises(ValueError, match=r"\[N, C, H, W\]"):
        batchnorm.forward_cuda(x[0], s, s)
    with pytest.raises(ValueError, match="empty"):
        batchnorm.forward_cuda(x[:0], s, s)
    with pytest.raises(ValueError, match="scale"):
        batchnorm.forward_cuda(x, torch.ones(4), s)
    with pytest.raises(TypeError, match="bias"):
        batchnorm.forward_cuda(x, s, s.double())  # f64 statistics for an f32 x
    # Any tensor but a CUDA one takes the plain version: no build on meta.
    z, mean, var = bn_relu_train(x.to("meta"), s.to("meta"), s.to("meta"))
    assert (z.device.type, z.shape, mean.shape, var.shape) == ("meta", x.shape, (3,), (3,))


@pytest.mark.parametrize("cfg", sorted(chip_smoke.BN_CONFIGS))
def test_grid_fills_the_card_at_every_level(cfg):
    """Every train-mode BatchNorm input of the configuration's UNet (the
    benchmark's batch of 10): every row and channel covered once, no empty
    slab, a block for each of the 132 SMs at least, and at least 4 rows a
    thread where the slabs are many."""
    model, channels, tile = chip_smoke.BN_CONFIGS[cfg]
    shapes = chip_smoke.bn_relu_shapes(model, channels, tile, chip_smoke.BN_BATCH)
    assert len(shapes) == 18
    for n, c, h, w in shapes + [s for _, s in chip_smoke.BN_TAILS]:
        m = n * h * w
        slabs, rows, tx = batchnorm.grid(m, c)
        tiles = -(-c // (8 * tx))
        assert tx in (1, 2, 4, 8, 16, 32) and 8 * tx * (tiles - 1) < c <= 8 * tx * tiles
        assert (slabs - 1) * rows < m <= slabs * rows
        lanes = 256 // tx
        if m >= 132 * lanes * 4:
            assert slabs * tiles >= 132 and rows >= 4 * lanes, (n, c, h, w)


def _mem(ptr: int, n: int, dtype: torch.dtype) -> torch.Tensor:
    """The n elements of ``dtype`` at address ``ptr``, as a CPU tensor over
    that memory."""
    size = torch.empty((), dtype=dtype).element_size()
    raw = np.frombuffer((ctypes.c_char * (n * size)).from_address(ptr), dtype=np.uint8)
    return torch.from_numpy(raw).view(dtype)


class _StandIn:
    """``csrc/batchnorm.cu``'s ``bnr_forward`` and ``bnr_backward``, argument
    for argument, computing with the plain expressions on CPU memory."""

    DTYPES = (torch.bfloat16, torch.float32, torch.float64)

    def __init__(self):
        self.calls = []

    def bnr_forward(self, stage, dtype, vec, x, z, m, c, slabs, rows, tx, scale, bias, eps,
                    part, mean, m2, var, inv, a, b, stream):
        self.calls.append(("forward", stage, vec, (slabs, rows, tx)))
        t = self.DTYPES[dtype]
        acc = torch.promote_types(t, torch.float32)
        xs = _mem(x, m * c, t).view(m, c)
        if stage != 2:
            assert part is not None
            xf = xs.to(acc)
            _mem(mean, c, acc).copy_(xf.mean(0))
            _mem(m2, c, acc).copy_((xf * xf).mean(0))
        if stage != 1:
            mu, sq = _mem(mean, c, acc), _mem(m2, c, acc)
            v = torch.clamp_min(sq - mu * mu, 0.0)
            iv = torch.rsqrt(v + eps)
            sc, bi = _mem(scale, c, acc), _mem(bias, c, acc)
            av, bv = (iv * sc).to(t), (bi - mu * iv * sc).to(t)
            for ptr, value in ((var, v), (inv, iv), (a, av), (b, bv)):
                _mem(ptr, c, value.dtype).copy_(value)
            _mem(z, m * c, t).view(m, c).copy_(F.relu(xs * av + bv))
        return 0

    def bnr_backward(self, stage, dtype, vec, x, dz, dx, m, c, slabs, rows, tx, a, b, mean,
                     inv, scale, part, sums, n_total, coef, stream):
        self.calls.append(("backward", stage, vec, (slabs, rows, tx)))
        t = self.DTYPES[dtype]
        acc = torch.promote_types(t, torch.float32)
        xs, gs = _mem(x, m * c, t).view(m, c), _mem(dz, m * c, t).view(m, c)
        av, bv = _mem(a, c, t), _mem(b, c, t)
        mu, iv = _mem(mean, c, acc), _mem(inv, c, acc)
        dzm = torch.where(xs * av + bv > 0, gs, 0).to(acc)
        xhat = (xs.to(acc) - mu) * iv
        if stage != 2:
            assert part is not None
            _mem(sums, 2 * c, acc).copy_(torch.cat([dzm.sum(0), (dzm * xhat).sum(0)]))
        if stage != 1:
            s = _mem(sums, 2 * c, acc)
            n = m if n_total is None else _mem(n_total, 1, acc)
            co = _mem(coef, 3 * c, acc).view(3, c)
            co[0], co[1], co[2] = _mem(scale, c, acc) * iv, s[:c] / n, s[c:] / n
            _mem(dx, m * c, t).view(m, c).copy_((co[0] * (dzm - co[1] - xhat * co[2])).to(t))
        return 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64],
                         ids=["bf16", "f32", "f64"])
@pytest.mark.parametrize("group", [None, "one rank"], ids=["local", "group"])
@pytest.mark.parametrize("layout", ["channels_last", "nchw", "ragged"])
def test_kernel_wrapper_against_the_plain_version(rng, monkeypatch, dtype, group, layout):
    """``_BNReLUTrainCUDA`` through the stand-in equals ``_BNReLUTrain``: the
    stages in order (a one-rank group: stage 1, the collective, stage 2),
    the 16-byte flag, the grid, the launch count and the tracer's counter.
    Outside a process group the collective is a no-op."""
    lib = _StandIn()
    monkeypatch.setattr(cuda_build, "load", lambda *args, **kwargs: lib)
    monkeypatch.setattr(cuda_build, "sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(trace.TRACER, "enabled", True)
    x, scale, bias, dz = _inputs(rng, c=5 if layout == "ragged" else 16)
    x, dz = _nchw(x).to(dtype), _nchw(dz).to(dtype)
    if layout != "nchw":
        x, dz = (t.contiguous(memory_format=torch.channels_last) for t in (x, dz))
    outs = []
    for fn in (batchnorm._BNReLUTrainCUDA, batchnorm._BNReLUTrain):
        tx, ts, tb = (t.clone().requires_grad_(True)
                      for t in (x, torch.from_numpy(scale), torch.from_numpy(bias)))
        before, launches = trace.counters().get("bn_relu.kernel", 0), LAUNCHES[batchnorm.KERNEL]
        z, mean, var = fn.apply(tx, ts, tb, 1e-5, group)
        z.backward(dz)
        outs.append([z, mean, var, tx.grad, ts.grad, tb.grad])
        if fn is batchnorm._BNReLUTrainCUDA:
            assert trace.counters().get("bn_relu.kernel", 0) - before == 2
            assert LAUNCHES[batchnorm.KERNEL] - launches == (6 if group is None else 8)
            assert z.is_contiguous(memory_format=torch.channels_last)
    stages = [(kind, stage) for kind, stage, _, _ in lib.calls]
    assert stages == ([("forward", 0), ("backward", 0)] if group is None else
                      [("forward", 1), ("forward", 2), ("backward", 1), ("backward", 2)])
    m = x.shape[0] * x.shape[2] * x.shape[3]
    for _, _, vec, dims in lib.calls:
        assert dims == batchnorm.grid(m, x.shape[1])
        assert vec == (layout != "ragged")
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-6
    for got, want in zip(*outs):
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got.detach().double().numpy(), want.detach().double().numpy(),
                                   atol=tol, rtol=tol)
