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

A CUDA tensor runs the hand-written kernels of ``csrc/batchnorm.cu``
(``forward_cuda``, ``backward_cuda``: three launches each way, the same
per-element arithmetic, the sums in another fixed order, no atomics); a
non-channels_last input is made channels_last first. Any other tensor (the
CPU, the meta device) runs the plain PyTorch version below
(``_BNReLUTrain``), the kernels' oracle. Each
forward and backward call counts ``bn_relu.kernel`` or ``bn_relu.plain`` on
the port's tracer (``utils/trace.py``); ``LAUNCHES["bn_relu"]`` counts the
kernels' launches.

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

import ctypes
import functools

import torch
import torch.nn.functional as F

from floodplanet_code_tpu_torch.ops import LAUNCHES, cuda_build
from floodplanet_code_tpu_torch.parallel.collectives import all_reduce
from floodplanet_code_tpu_torch.utils import trace

_AXES = (0, 2, 3)  # N, H, W of an NCHW tensor
KERNEL = "bn_relu"
_NAME = "batchnorm"  # csrc/batchnorm.cu; its C functions carry the prefix bnr_
_DTYPES = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}  # the kernels' dtype codes
_CPT = 8  # channels a kernel thread owns (batchnorm.cu's CPT)
_THREADS = 256  # threads of a row kernel's block (THREADS)
_BLOCKS_PER_SM = 8  # a full wave of 256-thread blocks
_MIN_ROWS = 4  # rows a thread walks at least, so that a block's reduction is paid for
# Launches per call of bnr_forward / bnr_backward by stage: 0 whole, 1 the
# sums (before a group's collective), 2 the rest.
_STAGE_LAUNCHES = {0: 3, 1: 2, 2: 2}


def _channel(t: torch.Tensor) -> torch.Tensor:
    return t.view(1, -1, 1, 1)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _acc(x: torch.Tensor) -> torch.Tensor:
    """x in the statistics' type: f32, or f64 for an f64 x."""
    return x.to(_acc_dtype(x.dtype))


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
    """The plain version: every tensor but a CUDA one, and the kernels'
    oracle on the card."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, group):
        trace.count("bn_relu.plain", 1)
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
        trace.count("bn_relu.plain", 1)
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


@functools.lru_cache(maxsize=None)
def grid(m: int, c: int, sms: int = 132) -> tuple[int, int, int]:
    """The row kernels' grid for an [m, c] activation on a card of ``sms``
    SMs: (slabs, rows per slab, tx). A block is tx threads across channels
    (8 each; a power of two, at most 32) by 256 / tx row lanes and covers
    one slab of rows and 8 * tx channels. The slabs make about a full wave
    of blocks with the channel tiles, but no more than leave each thread
    ``_MIN_ROWS`` rows; none is empty."""
    if m < 1 or c < 1:
        raise ValueError(f"no rows or channels: [{m}, {c}]")
    tx = min(32, 1 << (-(-c // _CPT) - 1).bit_length())
    tiles = -(-c // (_CPT * tx))
    lanes = _THREADS // tx
    slabs = max(1, min(-(-sms * _BLOCKS_PER_SM // tiles), -(-m // (lanes * _MIN_ROWS))))
    rows = -(-m // slabs)
    return -(-m // rows), rows, tx


def _check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> None:
    """Raise on what the kernels do not take (before anything is built)."""
    if x.dim() != 4:
        raise ValueError(f"want x [N, C, H, W], got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the {KERNEL} kernels take bfloat16, float32 and float64, "
                        f"not {x.dtype}")
    if x.numel() == 0:
        raise ValueError(f"x {tuple(x.shape)} is empty")
    for name, t in (("scale", scale), ("bias", bias)):
        if tuple(t.shape) != (x.shape[1],):
            raise ValueError(f"want {name} [{x.shape[1]}], got {tuple(t.shape)}")
        if t.dtype not in (torch.float32, _acc_dtype(x.dtype)):
            raise TypeError(f"{name} must be float32 or {_acc_dtype(x.dtype)}, not {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bnr_forward.restype = i32
    lib.bnr_forward.argtypes = ([i32] * 3 + [ptr] * 2 + [ctypes.c_longlong] + [i32] * 4
                                + [ptr] * 2 + [ctypes.c_double] + [ptr] * 8)
    lib.bnr_backward.restype = i32
    lib.bnr_backward.argtypes = ([i32] * 3 + [ptr] * 3 + [ctypes.c_longlong] + [i32] * 4
                                 + [ptr] * 10)


def _defines(dtype: torch.dtype, vec: int) -> dict[str, int]:
    """``batchnorm.cu`` builds one library per type and load width (``vec``
    1: 16-byte loads): its macros."""
    return {"BNR_DTYPE": _DTYPES[dtype], "BNR_VEC": vec}


def build(dtype: torch.dtype, vec: int) -> tuple[str, str]:
    """Compile ``batchnorm.cu``'s library for ``dtype`` and ``vec``
    (``ops/cuda_build.py``); returns (library path, ``ptxas -v`` report,
    empty when it was built already)."""
    return cuda_build.build(_NAME, _defines(dtype, vec))


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x as the kernels read it: NCHW in channels_last memory, [M, C]."""
    return x.contiguous(memory_format=torch.channels_last)


def _arg(a):
    """A C argument: a tensor's address, None (a null pointer) or a number."""
    return a.data_ptr() if isinstance(a, torch.Tensor) else a


def _launch(fn: str, stage: int, x: torch.Tensor, rows: list, *args) -> None:
    """One ``bnr_<fn>`` call (fn: "forward" or "backward") of ``stage`` on
    x's current stream. ``rows``: the other [M, C] tensors (z; or dz and
    dx; None where the stage writes none), which with x decide the 16-byte
    loads; ``args``: the C function's arguments after them, tensors (None:
    null) or numbers."""
    dev = x.device
    m, c = x.shape[0] * x.shape[2] * x.shape[3], x.shape[1]
    slabs, per_slab, tx = grid(m, c, cuda_build.sm_count(dev))
    rows = [_arg(t) for t in (x, *rows)]
    vec = int(c % _CPT == 0 and all(p % 16 == 0 for p in rows if p is not None))
    lib = cuda_build.load(_NAME, "bnr", _declare, dev, defines=_defines(x.dtype, vec))
    args = [_arg(a) for a in args]
    with torch.cuda.device(dev):
        err = getattr(lib, f"bnr_{fn}")(
            stage, _DTYPES[x.dtype], vec, *rows, m, c, slabs, per_slab, tx,
            *args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} {fn} launch failed: "
                           f"{cuda_build.error_string(lib, 'bnr', err)} "
                           f"(x {tuple(x.shape)} {x.dtype}, stage {stage})")
    LAUNCHES[KERNEL] += _STAGE_LAUNCHES[stage]


def _partials(x: torch.Tensor) -> torch.Tensor:
    """The row kernels' per-slab sums: [2, slabs, C] in the statistics' type."""
    m, c = x.shape[0] * x.shape[2] * x.shape[3], x.shape[1]
    slabs = grid(m, c, cuda_build.sm_count(x.device))[0]
    return torch.empty(2, slabs, c, dtype=_acc_dtype(x.dtype), device=x.device)


def forward_stats_cuda(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 1 of the forward: this rank's (mean, E[x^2]) of a channels_last
    CUDA x, in the statistics' type."""
    mean, m2 = torch.empty(2, x.shape[1], dtype=_acc_dtype(x.dtype), device=x.device)
    _launch("forward", 1, x, [None], None, None, 0.0, _partials(x), mean, m2, None, None, None,
            None)
    return mean, m2


def forward_apply_cuda(x, scale, bias, eps, mean=None, m2=None):
    """The forward on a channels_last CUDA x with scale and bias in the
    statistics' type: from x's own statistics (stage 0), or from the given
    (mean, m2) (stage 2: a group's, or the plain version's in the card's
    checks). Returns (z, mean, var, inv, a, b)."""
    acc, c = _acc_dtype(x.dtype), x.shape[1]
    z = torch.empty_like(x, memory_format=torch.channels_last)
    a, b = torch.empty(2, c, dtype=x.dtype, device=x.device)
    if mean is None:
        mean, m2, var, inv = torch.empty(4, c, dtype=acc, device=x.device)
        stage, part = 0, _partials(x)
    else:
        var, inv = torch.empty(2, c, dtype=acc, device=x.device)
        stage, part = 2, None
    _launch("forward", stage, x, [z], scale, bias, float(eps), part, mean, m2, var, inv, a, b)
    return z, mean, var, inv, a, b


def backward_sums_cuda(x, dz, a, b, mean, inv) -> torch.Tensor:
    """Stage 1 of the backward: this rank's [sum_dz, sum_dz_xhat] as [2, C]
    in the statistics' type (dz masked by the ReLU, ``xhat = (x - mean) *
    inv``); x and dz channels_last on the card."""
    sums = torch.empty(2, x.shape[1], dtype=mean.dtype, device=x.device)
    _launch("backward", 1, x, [dz, None], a, b, mean, inv, None, _partials(x), sums, None, None)
    return sums


def backward_apply_cuda(x, dz, a, b, mean, inv, scale, sums=None, n_total=None):
    """dx of a channels_last CUDA x and dz: from their own sums (stage 0,
    count M), or from the given [2, C] ``sums`` divided by the device scalar
    ``n_total`` (stage 2: a group's; None: M). Returns (dx, sums)."""
    c = x.shape[1]
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    coef = torch.empty(3, c, dtype=mean.dtype, device=x.device)
    if sums is None:
        sums = torch.empty(2, c, dtype=mean.dtype, device=x.device)
        stage, part = 0, _partials(x)
    else:
        stage, part = 2, None
    _launch("backward", stage, x, [dz, dx], a, b, mean, inv, scale, part, sums, n_total, coef)
    return dx, sums


def forward_cuda(x, scale, bias, eps=1e-5, group=None):
    """The forward's kernels: (z, mean, var, inv, a, b). With a group, the
    local statistics go through ``_group_mean`` between stage 1 and 2."""
    _check(x, scale, bias)
    acc = _acc_dtype(x.dtype)
    x, scale, bias = _rows(x), scale.to(acc).contiguous(), bias.to(acc).contiguous()
    if group is None:
        return forward_apply_cuda(x, scale, bias, eps)
    n = x.shape[0] * x.shape[2] * x.shape[3]
    (mean, m2), _ = _group_mean(list(forward_stats_cuda(x)), n, group)
    return forward_apply_cuda(x, scale, bias, eps, mean.contiguous(), m2.contiguous())


def backward_cuda(x, dz, a, b, mean, inv, scale, group=None):
    """The backward's kernels: (dx, sum_dz, sum_dz_xhat), the sums this
    rank's; with a group, dx from the group's sums and count (one
    all-reduce between stage 1 and 2, as the plain version)."""
    if dz.shape != x.shape or dz.dtype != x.dtype:
        raise ValueError(f"dz {tuple(dz.shape)} {dz.dtype} for x {tuple(x.shape)} {x.dtype}")
    x, dz = _rows(x), _rows(dz)
    if group is None:
        dx, sums = backward_apply_cuda(x, dz, a, b, mean, inv, scale)
        return dx, sums[0], sums[1]
    n = x.shape[0] * x.shape[2] * x.shape[3]
    sums = backward_sums_cuda(x, dz, a, b, mean, inv)
    buf = torch.cat([sums.reshape(-1), sums.new_full((1,), float(n))])
    all_reduce(buf, group)
    c = x.shape[1]
    dx, _ = backward_apply_cuda(x, dz, a, b, mean, inv, scale, buf[:2 * c], buf[2 * c:])
    return dx, sums[0], sums[1]


class _BNReLUTrainCUDA(torch.autograd.Function):
    """``_BNReLUTrain``'s function through the kernels (CUDA tensors)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, group):
        trace.count("bn_relu.kernel", 1)
        z, mean, var, inv, a, b = forward_cuda(x, scale, bias, eps, group)
        ctx.save_for_backward(x, a, b, mean, inv, scale.to(mean.dtype))
        ctx.group, ctx.dtypes = group, (scale.dtype, bias.dtype)
        ctx.mark_non_differentiable(mean, var)
        return z, mean, var

    @staticmethod
    def backward(ctx, dz, _dmean, _dvar):
        trace.count("bn_relu.kernel", 1)
        x, a, b, mean, inv, scale = ctx.saved_tensors
        dx, sum_dz, sum_dz_xhat = backward_cuda(x, dz, a, b, mean, inv, scale, ctx.group)
        # dscale and dbias: this rank's sums (module docstring).
        return dx, sum_dz_xhat.to(ctx.dtypes[0]), sum_dz.to(ctx.dtypes[1]), None, None


def bn_relu_train(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5,
    group=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``relu(normalize(x)*scale + bias)`` with batch statistics.

    x: [N, C, H, W] in the compute dtype; scale, bias: [C] f32. Returns
    (z, mean, var): z in x's dtype, and the f32 batch mean and biased
    variance for the running-statistic update (not differentiable).
    ``group``: statistics over the group's whole batch (SyncBN); the
    gradients of scale and bias stay this rank's (module docstring). The
    kernels on a CUDA tensor, the plain version on any other.
    """
    if x.is_cuda:
        return _BNReLUTrainCUDA.apply(x, scale, bias, eps, group)
    return _BNReLUTrain.apply(x, scale, bias, eps, group)
