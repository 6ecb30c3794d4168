"""Train-mode BatchNorm + ReLU with a hand-written backward.

The port of ``floodplanet_code_tpu/ops/batchnorm.py::bn_relu_train``, same
arithmetic in the same order, on NCHW tensors (any memory format):

- statistics: mean and E[x^2] over (N, H, W) in f32 (in f64 for an f64 x,
  which the JAX package does not run: the port's f64 reference step); the
  batch variance is the biased ``max(E[x^2] - mean^2, 0)``;
- forward: ``a = inv*scale`` and ``b = bias - mean*inv*scale`` in f32, cast
  to x's dtype, then ``relu(x*a + b)`` in x's dtype;
- backward: saves (x, mean, inv), not the normalized tensor; the ReLU mask
  comes from the recomputed pre-activation and ``xhat`` is rebuilt in f32.

``torch.nn.functional.batch_norm`` is not used: it rounds differently and
its running update takes the unbiased variance. Cross-device statistics
(the JAX ``axis_name``) wait for the multi-device slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_AXES = (0, 2, 3)  # N, H, W of an NCHW tensor


def _channel(t: torch.Tensor) -> torch.Tensor:
    return t.view(1, -1, 1, 1)


def _acc(x: torch.Tensor) -> torch.Tensor:
    """x in the statistics' type: f32, or f64 for an f64 x."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def batch_stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, E[x^2]) per channel in f32 (ops/batchnorm.py:38-47)."""
    xf = _acc(x)
    return xf.mean(dim=_AXES), (xf * xf).mean(dim=_AXES)


def _affine(x, scale, bias, mean, inv):
    a = (inv * scale).to(x.dtype)
    b = (bias - mean * inv * scale).to(x.dtype)
    return _channel(a), _channel(b)


class _BNReLUTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        mean, m2 = batch_stats(x)
        var = torch.clamp_min(m2 - mean * mean, 0.0)
        inv = torch.rsqrt(var + eps)
        a, b = _affine(x, scale, bias, mean, inv)
        z = F.relu(x * a + b)
        ctx.save_for_backward(x, scale, bias, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return z, mean, var

    @staticmethod
    def backward(ctx, dz, _dmean, _dvar):
        # The statistics feed the running averages only: no gradient.
        x, scale, bias, mean, inv = ctx.saved_tensors
        n = x.shape[0] * x.shape[2] * x.shape[3]
        a, b = _affine(x, scale, bias, mean, inv)
        dz = _acc(torch.where(x * a + b > 0, dz, 0))
        xhat = (_acc(x) - _channel(mean)) * _channel(inv)
        sum_dz = dz.sum(dim=_AXES)
        sum_dz_xhat = (dz * xhat).sum(dim=_AXES)
        g = _channel(scale * inv)
        dx = g * (dz - _channel(sum_dz / n) - xhat * _channel(sum_dz_xhat / n))
        return dx.to(x.dtype), sum_dz_xhat.to(scale.dtype), sum_dz.to(bias.dtype), None


def bn_relu_train(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``relu(normalize(x)*scale + bias)`` with batch statistics.

    x: [N, C, H, W] in the compute dtype; scale, bias: [C] f32. Returns
    (z, mean, var): z in x's dtype, and the f32 batch mean and biased
    variance for the running-statistic update (not differentiable).
    """
    return _BNReLUTrain.apply(x, scale, bias, eps)
