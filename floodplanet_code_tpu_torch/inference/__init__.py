from floodplanet_code_tpu_torch.inference.sliding import (
    make_predict_step,
    resolve_inference_batch_size,
    sliding_window_predict,
)
from floodplanet_code_tpu_torch.inference.stitcher import (
    DeviceStitcher,
    finalize_canvas,
    make_tile_valid_mask,
    stitch_batch,
)

__all__ = [
    "make_predict_step",
    "resolve_inference_batch_size",
    "sliding_window_predict",
    "DeviceStitcher",
    "finalize_canvas",
    "make_tile_valid_mask",
    "stitch_batch",
]
