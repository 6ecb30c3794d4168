"""UNet backbone in PyTorch: the port of ``floodplanet_code_tpu/models/unet.py``.

Architecture contract from the reference (st_water_seg/models/unet.py:6-201):
DoubleConv (3x3 conv -> BN -> ReLU, twice), 4 maxpool downs to 1024//2
channels (bilinear variant), 4 bilinear-upsample ups with pad-to-match skip
concatenation, 1x1 output conv.

Port choices:
- Eval mode: BatchNorm uses its running statistics, folded exactly as the
  JAX package folds them (``BatchNormReLU.fold``). Train mode: batch
  statistics through ``ops/batchnorm.py::bn_relu_train`` (the fused pair's
  BN_0: differentiable statistics folded into the kernel's (a, b), the JAX
  ``return_affine`` path), and the running statistics move as
  ``0.9*old + 0.1*batch`` with the biased batch variance. Not
  ``nn.BatchNorm2d``: its momentum runs the other way and it updates with
  the unbiased variance.
- ``fused_bn=False`` builds flax's ``nn.BatchNorm`` + ReLU instead
  (``FlaxBatchNormReLU``: normalized in f32 and rounded once, in both
  modes, with autograd's gradient) and switches the fused conv pair off, as
  the JAX package does (models/unet.py:137 there). The parameter tree is
  the same either way.
- Params are f32; every module computes in the model's compute dtype (bf16
  by default): inputs and weights are cast at each conv, the logits are
  cast back to f32, as the flax ``dtype``/``param_dtype`` split does.
- Activations are NCHW tensors in ``channels_last`` memory (NHWC), the
  layout the fused kernel reads.
- ``bn_group`` (``set_bn_group``; the JAX ``bn_axis_name``): train-mode
  BatchNorm takes its statistics over a process group's whole batch
  (SyncBN, ops/batchnorm.py), in all three forms (the fused pair's BN_0,
  ``bn_relu_train``, the flax BatchNorm). Eval mode never reads it.
- ``space_group`` (``set_space_group``; spatial partitioning, which the JAX
  package leaves to GSPMD): each rank holds a block of the image's rows, in
  the group's rank order, at every level the rows ``parallel/rows.py``
  gives it (equal blocks of the input, then blocks of unequal height below
  an odd end or an odd level), and computes the whole image's output rows
  of its block. Every 3x3 conv and 2x upsample reads one row of each
  neighbour's block (``parallel/halo.py``); a 2x2 max pool whose window
  falls across two blocks reads the first row of the block below; the
  pad-to-match of an odd level pads the last block alone; 1x1 convs are
  local. Every height that the blocks divide runs, unless some block would
  be empty at some level (``rows.row_layout`` raises). None (one device,
  data parallelism, serving, export): no exchange.
- ``conv_impl='pallas_fused'`` (the JAX config's name, kept so experiment
  configs load unchanged) runs every DoubleConv's middle BN -> ReLU -> conv
  boundary as one hand-written CUDA kernel (ops/conv_fused.py) on all nine
  DoubleConvs. The JAX gate ``recommended()`` (C1 >= 256) was measured on a
  TPU and is not carried over. ``'xla'`` runs the unfused chain (cuDNN).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.optim.optimizer import register_optimizer_step_post_hook

from floodplanet_code_tpu_torch.ops.batchnorm import batch_stats, bn_relu_train
from floodplanet_code_tpu_torch.ops.conv_fused import pack, relu_affine_conv3x3
from floodplanet_code_tpu_torch.parallel import halo
from floodplanet_code_tpu_torch.parallel.rows import RowLayout, row_layout

CONV_IMPLS = ("xla", "pallas_fused")
# Running statistics move as MOMENTUM*old + (1-MOMENTUM)*batch: the value
# every BatchNorm of the JAX package uses (models/unet.py:41,87-88 there).
_MOMENTUM = 0.9

# Optimizer steps taken in this process, a part of the eval pack cache's
# key: a fused optimizer (Adam(fused=True)) updates parameters in place
# without moving their ``_version``.
_OPTIMIZER_STEPS = [0]


def _count_optimizer_step(optimizer, args, kwargs) -> None:
    _OPTIMIZER_STEPS[0] += 1


register_optimizer_step_post_hook(_count_optimizer_step)


def _conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` applied in x's dtype (f32 params cast per call)."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), bias, padding=conv.padding)


class BatchNormReLU(nn.Module):
    """BatchNorm + ReLU (the JAX package's FusedBatchNormReLU).

    Parameters ``scale``/``bias`` and buffers ``mean``/``var`` carry the flax
    names, so the weight bridge (tools/import_jax_params.py) maps 1:1. In
    train mode every forward moves the running statistics in place, from
    statistics over ``group``'s whole batch when it is set (SyncBN).
    """

    def __init__(self, channels: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.group = None  # a torch.distributed group: SyncBN (set_bn_group)
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def fold(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The running statistics as an f32 affine (a, b): BN(x) = x*a + b
        (models/unet.py:77-83 of the JAX package, same expression order).
        Eval mode only: train mode normalizes with batch statistics."""
        if self.training:
            raise RuntimeError(
                "fold() is the eval-mode affine of the running statistics; in "
                "train mode use forward() or batch_affine()"
            )
        inv = torch.rsqrt(self.var + self.epsilon)
        return inv * self.scale, self.bias - self.mean * inv * self.scale

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        # models/unet.py:71-76,87-88 of the JAX package, same expression.
        with torch.no_grad():
            m = _MOMENTUM
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)

    def batch_affine(self, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Train mode, BN not applied: (a, b) in f32 from y's batch
        statistics, for a consumer that applies them itself (the fused
        kernel). The statistics are plain differentiable reductions, so the
        gradient reaches y through them as well (models/unet.py:60-78 of
        the JAX package); the running update is detached."""
        mean, m2 = batch_stats(y, self.group)
        var = torch.clamp_min(m2 - mean * mean, 0.0)
        self._update_running(mean.detach(), var.detach())
        inv = torch.rsqrt(var + self.epsilon)
        return inv * self.scale, self.bias - mean * inv * self.scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            z, mean, var = bn_relu_train(x, self.scale, self.bias, self.epsilon, self.group)
            self._update_running(mean, var)
            return z
        a, b = self.fold()
        dt = x.dtype
        # The fold is cast to the compute dtype before the apply, and the
        # apply runs in that dtype; F.batch_norm would round differently.
        return F.relu(x * a.to(dt).view(1, -1, 1, 1) + b.to(dt).view(1, -1, 1, 1))


class FlaxBatchNormReLU(BatchNormReLU):
    """flax ``nn.BatchNorm`` then ReLU: the JAX package's ``fused_bn=False``
    (models/unet.py:178-190 there; flax ``_compute_stats``, ``_normalize``).

    Train mode: the mean and E[x^2] over (N, H, W) in f32 (x promoted
    first), the biased variance ``max(0, E[x^2] - mean^2)``, the running
    statistics moved as ``0.9*old + 0.1*batch``. Both modes then compute
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in f32 and round it
    once to x's dtype before the ReLU; eval mode uses the running
    statistics, not ``fold()``. The gradient is autograd's through that
    expression, statistics included (flax has no custom VJP here).
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, m2 = batch_stats(x, self.group)
            var = torch.clamp_min(m2 - mean * mean, 0.0)
            self._update_running(mean.detach(), var.detach())
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        y = (xf - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)
        return F.relu(y.to(x.dtype))


def set_bn_group(model: nn.Module, group) -> nn.Module:
    """Take every train-mode BatchNorm's statistics over ``group``'s whole
    batch (None: this process's batch alone); returns ``model``."""
    for module in model.modules():
        if isinstance(module, BatchNormReLU):
            module.group = group
    return model


def set_space_group(model: nn.Module, group) -> nn.Module:
    """Treat every activation as this rank's block of image rows within
    ``group`` (spatial partitioning: the 3x3 convs, the 2x upsamples and the
    pools of split windows exchange edge rows over it); None: whole images.
    Returns ``model``."""
    for module in model.modules():
        if isinstance(module, (DoubleConv, UNetEncoder, UNetDecoder)):
            module.space_group = group
    return model


def _row_layout(x: torch.Tensor, group) -> RowLayout | None:
    """The row layout of a forward whose input block is ``x`` (level 0:
    every block holds H / sp rows), or None without a space group."""
    if group is None:
        return None
    n = halo.position(group)[1]
    return row_layout(x.shape[2] * n, n)


def _own_block(x: torch.Tensor, layout: RowLayout, level: int, s: int) -> tuple[int, int]:
    """Block s's global rows [start, stop) at ``level``; raises unless x
    holds that many rows."""
    start, stop = layout.blocks[level][s]
    if x.shape[2] != stop - start:
        raise ValueError(f"block {s} holds {x.shape[2]} rows at UNet level {level}; the "
                         f"row layout gives it {stop - start} ({layout.blocks[level]})")
    return start, stop


class DoubleConv(nn.Module):
    """(conv3x3 => BN => ReLU) * 2 (reference unet.py:6-20).

    ``fused_pair``: BN_0's apply + ReLU and conv1 run as the fused op, under
    ``conv_impl="pallas_fused"`` with ``fused_bn`` (JAX models/unet.py:137).

    With a ``space_group`` each conv runs on the block extended by its
    neighbours' edge rows (``halo.apply_on_rows``). For the fused op those
    are rows of y, the pre-BN conv0 output: the kernel pads z = relu(y*a +
    b), not y, with zeros (``ops/conv_fused.py``), so a halo row stands for
    the neighbour's z only as a row of y, and at the image edge no row is
    joined and the kernel's own padding applies. ``a`` and ``b`` are the
    global fold of this block's rows alone (SyncBN over every rank). The
    op's backward gives ``dy`` for the joined rows, which the exchange sends
    to their owners, and ``da``, ``db`` from the recomputed z of every row
    it read: each z row's cotangent is split between the ranks whose output
    rows read it, and the gradient all-reduce of the train step adds the
    parts into the whole.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        mid_channels: int | None = None,
        conv_impl: str = "xla",
        fused_bn: bool = True,
    ):
        super().__init__()
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"conv_impl must be one of {CONV_IMPLS}, not {conv_impl!r}")
        mid = mid_channels or out_channels
        self.fused_pair = conv_impl == "pallas_fused" and fused_bn
        bn = BatchNormReLU if fused_bn else FlaxBatchNormReLU
        self.conv0 = nn.Conv2d(in_channels, mid, 3, padding=1, bias=False)
        self.bn0 = bn(mid)
        self.conv1 = nn.Conv2d(mid, out_channels, 3, padding=1, bias=False)
        self.bn1 = bn(out_channels)
        self._fused = (None, None)  # (key, (a, b, packed)), see _fused_operands
        self._frozen = False  # see freeze_fused_operands
        self.space_group = None  # set_space_group

    def freeze_fused_operands(self, dtype: torch.dtype) -> None:
        """Fold BN_0 and pack the fused op's operands for activations of
        ``dtype`` once, from the weights loaded now, into non-persistent
        buffers that every later forward uses (eval mode only). A traced
        program (tools/export_model.py) carries them as constants, as the
        JAX export carries its weights; tracing cannot read ``_pack_key``'s
        storage pointers and versions. The weights must not change after."""
        if not self.fused_pair:
            raise RuntimeError("freeze_fused_operands: this DoubleConv runs no fused pair")
        a, b = self.bn0.fold()
        ap, bp, wp = pack(a, b, self.conv1.weight, dtype)
        for name, t in (("frozen_a", a), ("frozen_b", b), ("frozen_ap", ap),
                        ("frozen_bp", bp), ("frozen_wp", wp)):
            self.register_buffer(name, t.detach().clone(), persistent=False)
        self._frozen = True

    def _pack_key(self, y: torch.Tensor) -> tuple:
        """What the packed operands depend on: y's dtype, the tensors'
        storage and ``_version`` (moved by load_state_dict, a train-mode
        forward and most in-place updates) and the count of optimizer steps
        (a fused optimizer leaves ``_version`` as it was). Writes through
        ``.data`` are not seen. Not y's shape: a pack serves every block
        height and batch (``pack`` reads the parameters alone)."""
        bn = self.bn0
        tensors = (bn.scale, bn.bias, bn.mean, bn.var, self.conv1.weight)
        return (y.dtype, _OPTIMIZER_STEPS[0],
                *((t.data_ptr(), t._version) for t in tensors))

    def _fused_operands(self, y: torch.Tensor):
        """(a, b, packed) for the fused op on y. Train mode: BN_0's batch
        statistics, packed per call. On a card under inference mode they are
        kept until a parameter or running statistic changes (``_pack_key``):
        a serving model folds and lays out its weights once, not per
        forward. Frozen operands (``freeze_fused_operands``) win."""
        if self._frozen:
            if self.bn0.training or y.dtype != self.frozen_ap.dtype:
                raise RuntimeError(f"operands frozen for eval-mode {self.frozen_ap.dtype} "
                                   f"activations, got {y.dtype} in "
                                   f"{'train' if self.bn0.training else 'eval'} mode")
            return self.frozen_a, self.frozen_b, (self.frozen_ap, self.frozen_bp, self.frozen_wp)
        if self.bn0.training:
            a, b = self.bn0.batch_affine(y)
            return a, b, None
        w = self.conv1.weight
        if not (w.is_cuda and torch.is_inference_mode_enabled()):
            a, b = self.bn0.fold()
            return a, b, None  # the op packs per call on a card
        key = self._pack_key(y)
        if self._fused[0] != key:
            a, b = self.bn0.fold()
            self._fused = (key, (a, b, pack(a, b, w, y.dtype)))
        return self._fused[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = self.space_group
        y = halo.apply_on_rows(lambda t: _conv(t, self.conv0), x, group)
        if self.fused_pair:
            # BN_0's apply + ReLU run inside Conv_1's kernel.
            a, b, packed = self._fused_operands(y)
            y = halo.apply_on_rows(
                lambda t: relu_affine_conv3x3(t, a, b, self.conv1.weight, packed), y, group)
        else:
            y = halo.apply_on_rows(lambda t: _conv(t, self.conv1), self.bn0(y), group)
        return self.bn1(y)


class Down(nn.Module):
    """maxpool(2) then DoubleConv (reference unet.py:23-32). The 2x2/2 pool
    floors odd sizes, as flax's VALID pool does.

    With a ``layout`` x is this rank's block at ``level`` of it, within
    the encoder's space ``group``, and the pool gives its block at level + 1
    (``_max_pool_rows``)."""

    def __init__(self, in_channels: int, out_channels: int, conv_impl: str = "xla",
                 fused_bn: bool = True):
        super().__init__()
        self.double_conv = DoubleConv(in_channels, out_channels, conv_impl=conv_impl,
                                      fused_bn=fused_bn)

    def forward(self, x: torch.Tensor, layout: RowLayout | None = None, level: int = 0,
                group=None) -> torch.Tensor:
        if layout is not None:
            return self.double_conv(_max_pool_rows(x, layout, level, group))
        return self.double_conv(F.max_pool2d(x, 2))


def _max_pool_rows(x: torch.Tensor, layout: RowLayout, level: int, group) -> torch.Tensor:
    """The 2x2 max pool of a height-sharded x: this block's rows of the
    whole image's pool, its block at level + 1 (``parallel/rows.py``).

    The block pools the windows whose first row it holds: it skips an odd
    first row (the block above owns that window), joins the first row of
    the block below where its last window is split
    (``halo.join_rows``, whose backward returns that row's gradient to its
    owner), and drops the last row of an odd level. Every rank joins or
    not together: the exchange runs when any block's window is split."""
    s, n = halo.position(group)
    start, stop = _own_block(x, layout, level, s)
    lo, hi = layout.blocks[level + 1][s]
    if any(layout.borrows_below(level, k) for k in range(n)):
        x = halo.join_rows(x, group, top=False, bottom=layout.borrows_below(level, s))
    return F.max_pool2d(x[:, :, 2 * lo - start:2 * hi - start], 2)


def _upsample2x(x: torch.Tensor, align_corners: bool = False) -> torch.Tensor:
    """Bilinear 2x upsample (reference nn.Upsample(bilinear), unet.py:43-45).

    ``align_corners=False`` is the half-pixel convention with clamped edges,
    which is what the JAX package's dilated-conv form computes;
    ``align_corners=True`` serves checkpoints imported from the reference.
    Under spatial partitioning ``_upsample2x_rows`` runs instead.
    """
    h, w = x.shape[-2:]
    return F.interpolate(
        x, size=(2 * h, 2 * w), mode="bilinear", align_corners=align_corners
    )


@functools.lru_cache(maxsize=64)
def _align_corners_matrix(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """[n_out, n_in] f32 linear-interpolation matrix of torch's
    ``align_corners=True`` (the JAX package's ``_align_corners_matrix``,
    models/unet.py:329-342 there), built once per size and device; never
    an inference tensor (an eval step may build it, a train step reuse it)."""
    with torch.inference_mode(False):
        if n_in == 1:
            return torch.ones((n_out, 1), device=device)
        src = torch.arange(n_out, dtype=torch.float64) * (n_in - 1) / (n_out - 1)
        i0 = src.floor().long()
        i1 = torch.clamp(i0 + 1, max=n_in - 1)
        frac = (src - i0).float()
        mat = torch.zeros((n_out, n_in))
        rows = torch.arange(n_out)
        mat.index_put_((rows, i0), 1.0 - frac, accumulate=True)
        mat.index_put_((rows, i1), frac, accumulate=True)
        return mat.to(device)


def _upsample2x_rows(x: torch.Tensor, align_corners: bool, group, layout: RowLayout,
                     level: int) -> torch.Tensor:
    """``Up``'s upsample and pad-to-match of the height for a height-sharded
    x, its block at level + 1 of ``layout``: the rows of the whole image's
    ``_pad_to_match(_upsample2x(x), skip)`` in this block's range at
    ``level`` (the skip's), in height; the width is left to
    ``_pad_to_match``.

    One row of each neighbour's block is joined (``halo.join_rows``); none
    at the image edge, where the interpolation clamps as the whole image's
    does. Half-pixel: output row j reads source rows ``floor(j/2 - 1/4)``
    and the one after it, so the extended block's upsample equals the whole
    image's on this block's rows, which start ``start - 2 * lo`` rows into it
    (``lo``: the extended block's first source row; a block that starts on
    an odd row keeps one more output row of the joined row there). ``align_corners=True``: the
    source coordinate ``o * (n - 1) / (2n - 1)`` depends on the whole level's
    height n: the rows of the whole image's interpolation matrix that belong
    to this block, over the extended block's columns, then the same along W,
    in f32 and rounded once to x's dtype, as ``F.interpolate`` computes the
    whole image. Pad-to-match puts ``diff // 2`` zero rows on top of the
    image (0: a level is at most one row taller than twice the next) and the
    rest at its bottom, in the last block.
    """
    s, n = halo.position(group)
    lo = _own_block(x, layout, level + 1, s)[0] - int(s > 0)
    start, stop = layout.blocks[level][s]
    src, height = layout.heights[level + 1], layout.heights[level]
    ext = halo.join_rows(x, group)
    pad = (height - 2 * src) // 2  # the whole image's zero rows on top
    first, last = (min(max(r - pad, 0), 2 * src) for r in (start, stop))
    w = x.shape[3]
    if not align_corners:
        out = F.interpolate(ext, size=(2 * ext.shape[2], 2 * w), mode="bilinear",
                            align_corners=False)[:, :, first - 2 * lo:last - 2 * lo]
    else:
        mh = _align_corners_matrix(src, 2 * src, x.device)[first:last, lo:lo + ext.shape[2]]
        out = torch.einsum("oh,bchw->bcow", mh, ext.float())
        out = torch.einsum("pw,bcow->bcop", _align_corners_matrix(w, 2 * w, x.device), out)
        out = out.to(x.dtype).contiguous(memory_format=torch.channels_last)
    above, below = first - (start - pad), (stop - pad) - last
    if above or below:
        out = F.pad(out, (0, 0, above, below))
    return out


def _pad_to_match(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Zero-pad x1 spatially to x2's size, ``diff // 2`` at the top/left
    (reference unet.py:57-63)."""
    diff_h = x2.shape[2] - x1.shape[2]
    diff_w = x2.shape[3] - x1.shape[3]
    if diff_h == 0 and diff_w == 0:
        return x1
    return F.pad(
        x1, (diff_w // 2, diff_w - diff_w // 2, diff_h // 2, diff_h - diff_h // 2)
    )


class Up(nn.Module):
    """Bilinear upsample, pad-to-match, skip-concat ``[skip, up]``,
    DoubleConv (reference unet.py:35-67)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        mid_channels: int | None = None,
        align_corners: bool = False,
        conv_impl: str = "xla",
        fused_bn: bool = True,
    ):
        super().__init__()
        self.align_corners = align_corners
        self.double_conv = DoubleConv(
            in_channels, out_channels, mid_channels, conv_impl=conv_impl, fused_bn=fused_bn
        )

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, layout: RowLayout | None = None,
                level: int = 0, group=None) -> torch.Tensor:
        """x1 one level below x2; with a ``layout`` both are this rank's
        blocks of it within the decoder's space ``group``, x2's at ``level``."""
        if layout is None:
            up = _upsample2x(x1, self.align_corners)
        else:
            up = _upsample2x_rows(x1, self.align_corners, group, layout, level)
        return self.double_conv(torch.cat([x2, _pad_to_match(up, x2)], dim=1))


class UNetEncoder(nn.Module):
    """inc + 4 downs -> 5-level feature pyramid (reference unet.py:134-159)."""

    def __init__(self, in_channels: int, base_feat_channels: int = 64,
                 conv_impl: str = "xla", fused_bn: bool = True):
        super().__init__()
        bfc = base_feat_channels
        self.inc = DoubleConv(in_channels, bfc, conv_impl=conv_impl, fused_bn=fused_bn)
        self.down1 = Down(bfc, bfc * 2, conv_impl, fused_bn)
        self.down2 = Down(bfc * 2, bfc * 4, conv_impl, fused_bn)
        self.down3 = Down(bfc * 4, bfc * 8, conv_impl, fused_bn)
        self.down4 = Down(bfc * 8, bfc * 8, conv_impl, fused_bn)  # (bfc*16)//2, bilinear
        self.space_group = None  # set_space_group

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        group = self.space_group
        layout = _row_layout(x, group)
        x1 = self.inc(x)
        x2 = self.down1(x1, layout, 0, group)
        x3 = self.down2(x2, layout, 1, group)
        x4 = self.down3(x3, layout, 2, group)
        x5 = self.down4(x4, layout, 3, group)
        return [x1, x2, x3, x4, x5]


class UNetDecoder(nn.Module):
    """4 ups + 1x1 out conv with bias (reference unet.py:162-201)."""

    def __init__(self, n_classes: int, base_feat_channels: int = 64,
                 align_corners: bool = False, conv_impl: str = "xla", fused_bn: bool = True):
        super().__init__()
        bfc = base_feat_channels
        kw = dict(align_corners=align_corners, conv_impl=conv_impl, fused_bn=fused_bn)
        # Bilinear variant: each Up halves channels; mid = in_channels // 2
        # (reference DoubleConv(in, out, in//2), unet.py:46).
        self.up1 = Up(bfc * 16, bfc * 4, mid_channels=bfc * 8, **kw)
        self.up2 = Up(bfc * 8, bfc * 2, mid_channels=bfc * 4, **kw)
        self.up3 = Up(bfc * 4, bfc, mid_channels=bfc * 2, **kw)
        self.up4 = Up(bfc * 2, bfc, **kw)
        self.outc = nn.Conv2d(bfc, n_classes, 1)
        self.space_group = None  # set_space_group

    def forward(self, feats: list[torch.Tensor]) -> torch.Tensor:
        x1, x2, x3, x4, x5 = feats
        group = self.space_group
        layout = _row_layout(x1, group)
        x = self.up1(x5, x4, layout, 3, group)
        x = self.up2(x, x3, layout, 2, group)
        x = self.up3(x, x2, layout, 1, group)
        x = self.up4(x, x1, layout, 0, group)
        return _conv(x, self.outc).float()


class UNet(nn.Module):
    """Full UNet: encoder + decoder (reference unet.py:80-131).

    ``forward`` takes [B, C, H, W] in any float dtype and returns f32 logits
    [B, n_classes, H, W] (channels_last); the body runs in ``dtype``.
    """

    def __init__(
        self,
        in_channels: int,
        n_classes: int,
        base_feat_channels: int = 64,
        dtype: torch.dtype = torch.float32,
        align_corners: bool = False,
        conv_impl: str = "xla",
        fused_bn: bool = True,
    ):
        super().__init__()
        self.dtype = dtype
        self.encoder = UNetEncoder(in_channels, base_feat_channels, conv_impl, fused_bn)
        self.decoder = UNetDecoder(
            n_classes, base_feat_channels, align_corners, conv_impl, fused_bn
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        return self.decoder(self.encoder(x))
