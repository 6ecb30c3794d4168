"""floodplanet_code_tpu_torch — the PyTorch/CUDA port of floodplanet_code_tpu.

The JAX package beside it stays the reference; this package imports none of
it and no JAX. It runs the serving path (sliding-window inference of the
early-fusion UNet with on-device overlap stitching and georeferenced mask
export) on an NVIDIA H100, with the fused BN-apply + ReLU + 3x3 conv of
``floodplanet_code_tpu/ops/conv_fused.py`` as a hand-written ``sm_90a``
CUDA kernel (``ops/csrc/conv_fused.cu``). Entry points (``build_model``,
``sliding_window_predict``, ``infer``) run on the card unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"
