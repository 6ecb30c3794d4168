from floodplanet_code_tpu_torch.data.dataset import (
    DATASETS,
    FloodPlanetDataset,
    build_dataset,
)
from floodplanet_code_tpu_torch.data.loader import BatchLoader, device_prefetch
from floodplanet_code_tpu_torch.data.tiling import (
    CropParams,
    ImageSlice,
    crop_params_for_scene,
    generate_image_slice_object,
    get_crop_slices,
)

__all__ = [
    "DATASETS",
    "FloodPlanetDataset",
    "build_dataset",
    "BatchLoader",
    "device_prefetch",
    "CropParams",
    "ImageSlice",
    "crop_params_for_scene",
    "generate_image_slice_object",
    "get_crop_slices",
]
