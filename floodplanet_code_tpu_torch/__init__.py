"""floodplanet_code_tpu_torch — the PyTorch/CUDA port of floodplanet_code_tpu.

The JAX package beside it stays the reference; this package imports none of
it and no JAX. On one NVIDIA H100 it serves, evaluates, trains and
cross-validates the early- and late-fusion UNet, exports the predict step,
and runs the offline data tools, with both of the JAX package's Pallas
kernels as hand-written ``sm_90a`` CUDA kernels: the fused BN-apply + ReLU
+ 3x3 conv (``ops/csrc/conv_fused.cu``) and the row shear of the rotation
(``ops/csrc/rotate.cu``). Entry points (``build_model``,
``sliding_window_predict``, ``infer``, ``fit_model``, the CLIs) run on the
card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
