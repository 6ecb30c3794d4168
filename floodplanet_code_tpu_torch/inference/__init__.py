"""Serving and evaluation.

The entry points are modules with a ``main`` and a function of the same
name: ``infer``, ``predict``, ``serve`` (with ``InferenceService`` and
``make_handler``) and ``batch_infer``. Import them as submodules
(``from floodplanet_code_tpu_torch.inference import predict``, then
``predict.predict(...)``); this package does not import them itself, so
``python -m floodplanet_code_tpu_torch.inference.<entry>`` runs each as
``__main__`` without a second copy, and no function shadows its module.
"""

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
