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
- ``conv_impl='pallas_fused'`` (the JAX config's name, kept so experiment
  configs load unchanged) runs every DoubleConv's middle BN -> ReLU -> conv
  boundary as one hand-written CUDA kernel (ops/conv_fused.py) on all nine
  DoubleConvs. The JAX gate ``recommended()`` (C1 >= 256) was measured on a
  TPU and is not carried over. ``'xla'`` runs the unfused chain (cuDNN).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.optim.optimizer import register_optimizer_step_post_hook

from floodplanet_code_tpu_torch.ops.batchnorm import batch_stats, bn_relu_train
from floodplanet_code_tpu_torch.ops.conv_fused import pack, relu_affine_conv3x3

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


class DoubleConv(nn.Module):
    """(conv3x3 => BN => ReLU) * 2 (reference unet.py:6-20).

    ``fused_pair``: BN_0's apply + ReLU and conv1 run as the fused op, under
    ``conv_impl="pallas_fused"`` with ``fused_bn`` (JAX models/unet.py:137).
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
        ``.data`` are not seen."""
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
        y = _conv(x, self.conv0)
        if self.fused_pair:
            # BN_0's apply + ReLU run inside Conv_1's kernel.
            a, b, packed = self._fused_operands(y)
            y = relu_affine_conv3x3(y, a, b, self.conv1.weight, packed)
        else:
            y = _conv(self.bn0(y), self.conv1)
        return self.bn1(y)


class Down(nn.Module):
    """maxpool(2) then DoubleConv (reference unet.py:23-32). The 2x2/2 pool
    floors odd sizes, as flax's VALID pool does."""

    def __init__(self, in_channels: int, out_channels: int, conv_impl: str = "xla",
                 fused_bn: bool = True):
        super().__init__()
        self.double_conv = DoubleConv(in_channels, out_channels, conv_impl=conv_impl,
                                      fused_bn=fused_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.double_conv(F.max_pool2d(x, 2))


def _upsample2x(x: torch.Tensor, align_corners: bool = False) -> torch.Tensor:
    """Bilinear 2x upsample (reference nn.Upsample(bilinear), unet.py:43-45).

    ``align_corners=False`` is the half-pixel convention with clamped edges,
    which is what the JAX package's dilated-conv form computes;
    ``align_corners=True`` serves checkpoints imported from the reference.
    """
    h, w = x.shape[-2:]
    return F.interpolate(
        x, size=(2 * h, 2 * w), mode="bilinear", align_corners=align_corners
    )


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

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        x1 = _pad_to_match(_upsample2x(x1, self.align_corners), x2)
        return self.double_conv(torch.cat([x2, x1], dim=1))


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

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
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

    def forward(self, feats: list[torch.Tensor]) -> torch.Tensor:
        x1, x2, x3, x4, x5 = feats
        x = self.up1(x5, x4)
        x = self.up2(x, x3)
        x = self.up3(x, x2)
        x = self.up4(x, x1)
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
