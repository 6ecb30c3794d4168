"""Segmentation task models over the UNet backbone (port of
``floodplanet_code_tpu/models/water_seg.py``).

- ``WaterSegModel``    <- WaterSegmentationModel: plain UNet on
  ``batch['image']``.
- ``EarlyFusionModel`` <- ef_model.py:6-47: auxiliary rasters concatenated
  as extra input channels before a shared UNet.
- ``LateFusionModel``  <- lf_model.py:9-92: one UNetEncoder per modality,
  level-wise feature concatenation fused by per-level 1x1 convs
  (feat_fusion='concat_conv'), one shared UNetDecoder.

Batches are dicts of NCHW tensors: ``image`` plus optional aux features in
``AUX_FEATURE_KEYS`` order. ``build_model`` returns a model in eval mode;
``.train()`` switches it to batch-statistics BatchNorm for training
(``train/fit.py::make_train_step``).
"""

from __future__ import annotations

import torch
from torch import nn

from floodplanet_code_tpu_torch.device import resolve_device
from floodplanet_code_tpu_torch.models.unet import (
    UNet,
    UNetDecoder,
    UNetEncoder,
    _conv,
    set_bn_group,
    set_space_group,
)

# Fixed aux-feature ordering (reference ef_model.py:28-44 checks in this order).
AUX_FEATURE_KEYS = ("dem", "slope", "preflood", "pre_post_difference", "hand")


class WaterSegModel(nn.Module):
    """Plain UNet on the multispectral image (ms_model)."""

    def __init__(self, in_channels: int, n_classes: int, **unet_kwargs):
        super().__init__()
        self.unet = UNet(in_channels, n_classes, **unet_kwargs)

    def forward(self, batch: dict) -> torch.Tensor:
        return self.unet(batch["image"])


class EarlyFusionModel(nn.Module):
    """Channel-concat fusion of image + aux rasters, shared UNet (ef_model)."""

    def __init__(self, in_channels: int, n_classes: int, **unet_kwargs):
        super().__init__()
        self.unet = UNet(in_channels, n_classes, **unet_kwargs)

    def forward(self, batch: dict) -> torch.Tensor:
        parts = [batch["image"]]
        for key in AUX_FEATURE_KEYS:
            if batch.get(key) is not None:
                parts.append(batch[key])
        x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
        return self.unet(x)


class LateFusionModel(nn.Module):
    """Per-modality encoders, level-wise concat + 1x1 fuse, one decoder.

    ``in_channels`` (modality name -> channel count) fixes the encoder set,
    in its order, like the reference's ModuleDict (lf_model.py:31-45); the
    level-wise concatenation follows that order. Each modality is cast to
    the compute dtype and laid out ``channels_last`` before its encoder, as
    ``UNet.forward`` does for a single input. The 1x1 fusing convs carry a
    bias and run in the compute dtype on f32 params (flax
    ``nn.Conv(dtype=...)``); they stay plain convolutions, as the JAX
    package computes them outside any Pallas kernel.
    """

    def __init__(
        self,
        in_channels: dict,
        n_classes: int,
        feat_fusion: str = "concat_conv",
        base_feat_channels: int = 64,
        dtype: torch.dtype = torch.float32,
        align_corners: bool = False,
        conv_impl: str = "xla",
        fused_bn: bool = True,
    ):
        super().__init__()
        if feat_fusion != "concat_conv":
            raise NotImplementedError(
                f'No fusion method "{feat_fusion}" (reference supports '
                "concat_conv only, lf_model.py:88)"
            )
        self.dtype = dtype
        self.encoders = nn.ModuleDict({
            name: UNetEncoder(c, base_feat_channels, conv_impl, fused_bn)
            for name, c in in_channels.items()
        })
        bfc = base_feat_channels
        n = len(in_channels)
        self.concat_convs = nn.ModuleList(
            nn.Conv2d(c * n, c, 1) for c in (bfc, bfc * 2, bfc * 4, bfc * 8, bfc * 8)
        )
        self.decoder = UNetDecoder(n_classes, base_feat_channels, align_corners, conv_impl,
                                   fused_bn)

    def forward(self, batch: dict) -> torch.Tensor:
        modality_input = {"ms_image": batch["image"]}
        for key in AUX_FEATURE_KEYS:
            if batch.get(key) is not None:
                modality_input[key] = batch[key]
        pyramids = []
        for name, encoder in self.encoders.items():
            if name not in modality_input:
                raise KeyError(
                    f'Late-fusion modality "{name}" missing from batch '
                    f"(has: {sorted(modality_input)})"
                )
            x = modality_input[name].to(self.dtype)
            pyramids.append(encoder(x.contiguous(memory_format=torch.channels_last)))
        fused = [
            _conv(torch.cat([p[level] for p in pyramids], dim=1), conv)
            for level, conv in enumerate(self.concat_convs)
        ]
        return self.decoder(fused)


MODELS = {
    "ms_model": WaterSegModel,
    "ef_model": EarlyFusionModel,
    "lf_model": LateFusionModel,
}

# JAX-package model options that compute the same function in every setting
# (numerically identical alternatives there, one implementation here).
_SAME_FUNCTION_KWARGS = ("pool_impl", "upsample_impl")


def resolve_conv_impl(cfg) -> str:
    """The DoubleConv implementation from config: ``tpu.conv_impl``, forced
    to ``xla`` by ``tpu.use_pallas: false`` (the JAX package's contract).

    ``pallas_fused`` stays on under more than one device. The JAX package
    forces ``xla`` there (its ``resolve_conv_impl``) because GSPMD has no
    partitioning rule for a ``pallas_call`` and would all-gather the
    activation around it. Under ``torch.distributed`` nothing is
    partitioned: each rank runs the whole forward on its own rows, and the
    function per sample is the one the fused kernel computes on one
    device. Under spatial partitioning the kernel runs on each rank's block
    of rows extended by its neighbours' edge rows (``models/unet.py::
    DoubleConv``)."""
    if not cfg.select("tpu.use_pallas", True):
        return "xla"
    return cfg.select("tpu.conv_impl", "xla")


def resolve_compute_dtype(cfg) -> torch.dtype:
    """The model's compute dtype from ``tpu.compute_dtype`` (bf16 default)."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        cfg.select("tpu.compute_dtype", "bfloat16")]


def build_model(
    model_name: str,
    in_channels: dict,
    n_classes: int,
    dtype: torch.dtype = torch.float32,
    device="cuda",
    bn_group=None,
    space_group=None,
    **model_kwargs,
) -> nn.Module:
    """Model factory: an eval-mode model with f32 params on ``device``.

    ``in_channels`` is the dataset's modality -> channel-count dict: the
    early-fusion model takes their sum, the late-fusion model one encoder
    per entry, the plain model ``ms_image``. ``fused_bn=False`` builds
    flax's BatchNorm rounding with the fused conv pair off
    (``models/unet.py::FlaxBatchNormReLU``). ``optimizer_name`` and the
    JAX-only implementation choices ``pool_impl``/``upsample_impl`` are
    accepted and ignored. ``bn_group`` (the JAX ``bn_axis_name``): a
    ``torch.distributed`` group over which train-mode BatchNorm takes its
    statistics (SyncBN, ``set_bn_group``). ``space_group``: spatial
    partitioning, the group whose ranks hold the blocks of rows of the same
    examples (``set_space_group``). Raises without a card unless
    ``device="cpu"``.
    """
    device = resolve_device(device)
    model_kwargs = dict(model_kwargs)
    model_kwargs.pop("optimizer_name", None)
    for key in _SAME_FUNCTION_KWARGS:
        model_kwargs.pop(key, None)
    try:
        model_cls = MODELS[model_name]
    except KeyError:
        raise KeyError(
            f'Model "{model_name}" not found. Available: {sorted(MODELS)}'
        )
    if model_cls is LateFusionModel:
        n_in = dict(in_channels)
    elif model_cls is EarlyFusionModel:
        n_in = sum(in_channels.values())
    else:
        n_in = in_channels["ms_image"]
    model = set_bn_group(model_cls(n_in, n_classes, dtype=dtype, **model_kwargs), bn_group)
    set_space_group(model, space_group)
    return model.to(device=device, memory_format=torch.channels_last).eval()
