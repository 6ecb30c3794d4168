from floodplanet_code_tpu_torch.models.unet import (
    BatchNormReLU,
    DoubleConv,
    Down,
    UNet,
    UNetDecoder,
    UNetEncoder,
    Up,
)
from floodplanet_code_tpu_torch.models.water_seg import (
    AUX_FEATURE_KEYS,
    MODELS,
    EarlyFusionModel,
    LateFusionModel,
    WaterSegModel,
    build_model,
    resolve_compute_dtype,
    resolve_conv_impl,
)

__all__ = [
    "BatchNormReLU",
    "DoubleConv",
    "Down",
    "UNet",
    "UNetDecoder",
    "UNetEncoder",
    "Up",
    "AUX_FEATURE_KEYS",
    "MODELS",
    "EarlyFusionModel",
    "LateFusionModel",
    "WaterSegModel",
    "build_model",
    "resolve_compute_dtype",
    "resolve_conv_impl",
]
