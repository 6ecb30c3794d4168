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
its running update takes the unbiased variance.

``group`` (the JAX ``axis_name``, SyncBN): each rank holds its rows of the
batch and the statistics are the whole batch's. Forward: the group's mean
and E[x^2] are ``sum_k n_k * stat_k / sum_k n_k`` over the ranks' pixel
counts n_k, which differ under spatial partitioning once a level splits
into blocks of unequal height (``parallel/rows.py``); with equal counts it
is ``pmean``. Backward: ``sum_dz``, ``sum_dz_xhat`` and the count are
summed over the group for ``dx``. dscale and dbias are returned as this rank's
LOCAL sums: the train step sums every gradient over the group once
(``parallel/shard_step.py``), which makes them global there. (JAX returns
them global, ``:99-103`` there, because its typed AD adds no second sum.)
``batch_stats`` with a group is the differentiable form for the statistics
the fused pair and the flax BatchNorm take through autograd: its backward
gives rank k ``n_k / N`` of the statistics' cotangent summed over the group
(N the group's count), the term through which every rank's pixels reach
every other rank's through the shared statistics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from floodplanet_code_tpu_torch.parallel.collectives import all_reduce

_AXES = (0, 2, 3)  # N, H, W of an NCHW tensor


def _channel(t: torch.Tensor) -> torch.Tensor:
    return t.view(1, -1, 1, 1)


def _acc(x: torch.Tensor) -> torch.Tensor:
    """x in the statistics' type: f32, or f64 for an f64 x."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _local_stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    xf = _acc(x)
    return xf.mean(dim=_AXES), (xf * xf).mean(dim=_AXES)


def _group_mean(stats: list, n: int, group) -> tuple[list, torch.Tensor]:
    """Each of ``stats``, this rank's means over its ``n`` pixels, as the
    mean over the group's pixels, ``sum_k n_k * stat_k / sum_k n_k``, and
    the group's count (one all-reduce, no host sync)."""
    ref = stats[0]
    buf = torch.cat([s.reshape(-1) * n for s in stats] + [ref.new_full((1,), float(n))])
    all_reduce(buf, group)
    out, offset, total = [], 0, buf[-1]
    for s in stats:
        out.append((buf[offset:offset + s.numel()] / total).view_as(s))
        offset += s.numel()
    return out, total


class _SyncedStats(torch.autograd.Function):
    """(mean, E[x^2]) of local statistics over a group's pixels; the
    backward gives this rank ``n / N`` of the cotangents summed over the
    group (module docstring)."""

    @staticmethod
    def forward(ctx, mean, m2, n, group):
        (mean, m2), total = _group_mean([mean, m2], n, group)
        ctx.group, ctx.share = group, n / total
        return mean, m2

    @staticmethod
    def backward(ctx, dmean, dm2):
        c = dmean.numel()
        buf = torch.cat([dmean.reshape(-1), dm2.reshape(-1)])
        all_reduce(buf, ctx.group)
        return ((buf[:c] * ctx.share).view_as(dmean), (buf[c:] * ctx.share).view_as(dm2),
                None, None)


def batch_stats(x: torch.Tensor, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, E[x^2]) per channel in f32 (ops/batchnorm.py:38-47), over
    the group's whole batch when ``group`` is given; differentiable."""
    mean, m2 = _local_stats(x)
    if group is None:
        return mean, m2
    n = x.shape[0] * x.shape[2] * x.shape[3]
    return _SyncedStats.apply(mean, m2, n, group)


def _affine(x, scale, bias, mean, inv):
    a = (inv * scale).to(x.dtype)
    b = (bias - mean * inv * scale).to(x.dtype)
    return _channel(a), _channel(b)


class _BNReLUTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps, group):
        mean, m2 = _local_stats(x)
        if group is not None:
            (mean, m2), _ = _group_mean([mean, m2], x.shape[0] * x.shape[2] * x.shape[3], group)
        var = torch.clamp_min(m2 - mean * mean, 0.0)
        inv = torch.rsqrt(var + eps)
        a, b = _affine(x, scale, bias, mean, inv)
        z = F.relu(x * a + b)
        ctx.save_for_backward(x, scale, bias, mean, inv)
        ctx.group = group
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
        # dscale and dbias: this rank's sums (module docstring).
        dscale, dbias = sum_dz_xhat.to(scale.dtype), sum_dz.to(bias.dtype)
        if ctx.group is not None:
            c = sum_dz.numel()
            buf = torch.cat([sum_dz, sum_dz_xhat, sum_dz.new_full((1,), float(n))])
            all_reduce(buf, ctx.group)
            sum_dz, sum_dz_xhat, n = buf[:c], buf[c:2 * c], buf[-1]
        g = _channel(scale * inv)
        dx = g * (dz - _channel(sum_dz / n) - xhat * _channel(sum_dz_xhat / n))
        return dx.to(x.dtype), dscale, dbias, None, None


def bn_relu_train(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5,
    group=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``relu(normalize(x)*scale + bias)`` with batch statistics.

    x: [N, C, H, W] in the compute dtype; scale, bias: [C] f32. Returns
    (z, mean, var): z in x's dtype, and the f32 batch mean and biased
    variance for the running-statistic update (not differentiable).
    ``group``: statistics over the group's whole batch (SyncBN); the
    gradients of scale and bias stay this rank's (module docstring).
    """
    return _BNReLUTrain.apply(x, scale, bias, eps, group)
