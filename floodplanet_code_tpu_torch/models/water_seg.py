"""Segmentation task models over the UNet backbone (port of
``floodplanet_code_tpu/models/water_seg.py``).

- ``WaterSegModel``    <- WaterSegmentationModel: plain UNet on
  ``batch['image']``.
- ``EarlyFusionModel`` <- ef_model.py:6-47: auxiliary rasters concatenated
  as extra input channels before a shared UNet.

``LateFusionModel`` is not ported yet (ROADMAP.md Queue 1).

Batches are dicts of NCHW tensors: ``image`` plus optional aux features in
``AUX_FEATURE_KEYS`` order. ``build_model`` returns a model in eval mode;
``.train()`` switches it to batch-statistics BatchNorm for training
(``train/fit.py::make_train_step``).
"""

from __future__ import annotations

import torch
from torch import nn

from floodplanet_code_tpu_torch.device import resolve_device
from floodplanet_code_tpu_torch.models.unet import UNet

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


MODELS = {
    "ms_model": WaterSegModel,
    "ef_model": EarlyFusionModel,
}

# JAX-package model options that compute the same function in every setting
# (numerically identical alternatives there, one implementation here).
_SAME_FUNCTION_KWARGS = ("pool_impl", "upsample_impl")


def resolve_conv_impl(cfg) -> str:
    """The DoubleConv implementation from config: ``tpu.conv_impl``, forced
    to ``xla`` by ``tpu.use_pallas: false`` (the JAX package's contract)."""
    if not cfg.select("tpu.use_pallas", True):
        return "xla"
    return cfg.select("tpu.conv_impl", "xla")


def build_model(
    model_name: str,
    in_channels: dict,
    n_classes: int,
    dtype: torch.dtype = torch.float32,
    device="cuda",
    **model_kwargs,
) -> nn.Module:
    """Model factory: an eval-mode model with f32 params on ``device``.

    ``in_channels`` is the dataset's modality -> channel-count dict; the
    early-fusion model takes their sum. ``optimizer_name`` and the
    JAX-only implementation choices ``pool_impl``/``upsample_impl`` are
    accepted and ignored. Raises without a card unless ``device="cpu"``.
    """
    device = resolve_device(device)
    model_kwargs = dict(model_kwargs)
    model_kwargs.pop("optimizer_name", None)
    for key in _SAME_FUNCTION_KWARGS:
        model_kwargs.pop(key, None)
    if not model_kwargs.pop("fused_bn", True):
        raise NotImplementedError(
            "fused_bn=false (flax nn.BatchNorm rounding) is not ported"
        )
    try:
        model_cls = MODELS[model_name]
    except KeyError:
        raise KeyError(
            f'Model "{model_name}" not ported. Available: {sorted(MODELS)} '
            "(lf_model: ROADMAP.md Queue 1)"
        )
    n_in = (
        sum(in_channels.values())
        if model_cls is EarlyFusionModel
        else in_channels["ms_image"]
    )
    model = model_cls(n_in, n_classes, dtype=dtype, **model_kwargs)
    return model.to(device=device, memory_format=torch.channels_last).eval()
