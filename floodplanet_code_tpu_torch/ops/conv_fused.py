"""Fused BN-apply + ReLU + 3x3 conv: ``conv3x3_SAME(relu(y*a + b), w)``.

The port of ``floodplanet_code_tpu/ops/conv_fused.py``. Inside a UNet
DoubleConv the first conv's BatchNorm is folded into a per-channel affine
``(a, b)`` and, instead of materializing ``z = relu(y*a + b)`` in device
memory, the second conv's kernel applies it to each input tile as it loads
it (``csrc/conv_fused.cu``, a hand-written CUDA kernel for ``sm_90a``).
SAME padding applies to ``z``: taps outside the image add 0, not relu(b).

- ``relu_affine_conv3x3``: the op, registered as the custom op
  ``floodplanet::relu_affine_conv3x3`` with a fake implementation, so that
  ``torch.export`` traces it. On a CUDA tensor it launches the kernel (a
  build or launch error raises); on a CPU tensor it runs
  ``relu_affine_conv3x3_plain``. Its backward recomputes ``z`` and
  differentiates the plain version, as the JAX package's custom VJP does.
- ``relu_affine_conv3x3_plain``: the same function in plain PyTorch, in
  y's dtype: the CPU path, and the oracle the kernel is held to.
- ``pack``: the kernel's padded layout of (a, b, w): for bf16 the weight
  stages as their shared-memory image; ``unpack`` inverts it (tests).
- ``build``: compiles the kernel with ``nvcc`` into ``_build/`` (once per
  source version, ``ops/cuda_build.py``) and returns the library path.

Tensors are PyTorch's NCHW with ``channels_last`` memory, so the kernel
reads NHWC. ``w`` is a conv weight in PyTorch's OIHW layout.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from floodplanet_code_tpu_torch.ops import LAUNCHES, cuda_build

KERNEL = "relu_affine_conv3x3"
_NAME = "conv_fused"  # csrc/conv_fused.cu; its C functions carry the prefix fp_
# The bf16 kernel walks input channels _K_CHUNK at a time (one 128-byte
# shared-memory row); the f32 kernel _K_CHUNK_F32 at a time, in output blocks
# of _N_BLOCK_F32 channels. pack() zero-pads a, b and w to these multiples.
_K_CHUNK = 64
_K_CHUNK_F32 = 32
_N_BLOCK_F32 = 64
_SWIZZLE = 8  # 16-byte groups per 128-byte row of a weight stage


def tile_config(c2: int) -> tuple[int, int]:
    """The bf16 kernel's tile for C2 output channels: (BN, MT) = (channels
    per tile, m64 tiles per warpgroup); the tile holds 8*MT x 16 pixels.
    ``FP_BF16_CONFIGS`` in conv_fused.cu lists the instantiated ones."""
    if c2 <= 64:
        return 64, 4
    if c2 <= 128:
        return 128, 2
    return 256, 1


def build() -> tuple[str, str]:
    """Compile ``conv_fused.cu`` (``ops/cuda_build.py``); returns (library
    path, ``ptxas -v`` report, empty when it was built already)."""
    return cuda_build.build(_NAME)


def _declare(lib: ctypes.CDLL) -> None:
    lib.fp_prepare.restype = ctypes.c_int
    lib.fp_relu_affine_conv3x3.restype = ctypes.c_int
    lib.fp_relu_affine_conv3x3.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int
    ] * 12 + [ctypes.c_void_p]


def _load(device: torch.device) -> ctypes.CDLL:
    """The kernel library, built and loaded once, prepared for ``device``
    (``fp_prepare`` sets the shared-memory attribute there)."""
    return cuda_build.load(_NAME, "fp", _declare, device, prepare=True)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def relu_affine_conv3x3_plain(y, a, b, w):
    """``conv3x3_SAME(relu(y*a + b), w)`` in y's dtype, unfused.

    As ``floodplanet_code_tpu/ops/conv_fused.py::xla_reference``: a, b and
    w are cast to y's dtype first, and the affine runs as two tensor ops.
    """
    dt = y.dtype
    z = F.relu(y * a.to(dt).view(1, -1, 1, 1) + b.to(dt).view(1, -1, 1, 1))
    return F.conv2d(z, w.to(dt), padding=1)


def _check(y, a, b, w) -> None:
    if y.dim() != 4 or w.dim() != 4 or tuple(w.shape[1:]) != (y.shape[1], 3, 3):
        raise ValueError(
            f"want y [B,C1,H,W] and w [C2,C1,3,3]; got {tuple(y.shape)}, "
            f"{tuple(w.shape)}"
        )
    if a.shape != (y.shape[1],) or b.shape != (y.shape[1],):
        raise ValueError(f"a and b must be [C1={y.shape[1]}]")
    if any(t.device != y.device for t in (a, b, w)):
        raise ValueError("y, a, b and w must be on one device")


def _swizzle(st: torch.Tensor) -> torch.Tensor:
    """Weight stages [..., BN, 64] in the 128-byte swizzle: row n's 16-byte
    group at position g holds group g ^ (n % 8). Its own inverse."""
    bn, kch = st.shape[-2:]
    groups = st.reshape(*st.shape[:-1], _SWIZZLE, kch // _SWIZZLE)
    n = torch.arange(bn, device=st.device)[:, None]
    idx = (torch.arange(_SWIZZLE, device=st.device)[None, :] ^ (n % _SWIZZLE))[:, :, None]
    return torch.take_along_dim(groups, idx.expand(bn, _SWIZZLE, kch // _SWIZZLE).expand_as(groups),
                                dim=-2).reshape(st.shape)


def pack(a, b, w, dtype):
    """The kernel's operands ``(ap, bp, wp)`` from the op's ``(a, b, w)``.

    a, b and w are cast to ``dtype`` (y's; the JAX package's
    conv_fused.py:188-190) and zero-padded past C1 and C2. ap, bp [C1p].
    bf16: wp [C2p/BN, C1p/64, 9, BN, 64], each [BN, 64] slice the exact
    shared-memory image of one (output tile, channel chunk, tap) stage:
    w[n, k] at row n, the 16-byte groups of a row swizzled (``_swizzle``),
    so one bulk copy fills a stage. f32: wp [9, C1p, C2p], tap-major. They
    depend only on the parameters, so a model packs them once
    (``models/unet.py``).
    """
    c2, c1 = w.shape[:2]
    bf = dtype == torch.bfloat16
    c1p = _round_up(c1, _K_CHUNK if bf else _K_CHUNK_F32)
    bn = tile_config(c2)[0] if bf else _N_BLOCK_F32
    c2p = _round_up(c2, bn)
    ap = torch.zeros(c1p, dtype=dtype, device=w.device)
    ap[:c1] = a.to(dtype)
    bp = torch.zeros(c1p, dtype=dtype, device=w.device)
    bp[:c1] = b.to(dtype)
    taps = torch.zeros(9, c1p, c2p, dtype=dtype, device=w.device)
    taps[:, :c1, :c2] = w.to(dtype).permute(2, 3, 1, 0).reshape(9, c1, c2)
    if not bf:
        return ap, bp, taps
    # [tap, kc, k, nt, n] -> [nt, kc, tap, n, k], then swizzle each row.
    st = taps.view(9, c1p // _K_CHUNK, _K_CHUNK, c2p // bn, bn).permute(3, 1, 0, 4, 2)
    return ap, bp, _swizzle(st).contiguous()


def unpack(ap, bp, wp, c1, c2):
    """``pack``'s inverse, for the tests: (a, b, w [C2, C1, 3, 3]) in the
    packed dtype, and the padding (every packed element past C1 or C2) as
    one flat tensor, which must be zero."""
    if wp.dim() == 3:  # f32: [9, C1p, C2p]
        taps = wp
    else:
        nt, nk, _, bn, kch = wp.shape
        taps = _swizzle(wp).permute(2, 1, 4, 0, 3).reshape(9, nk * kch, nt * bn)
    w = taps[:, :c1, :c2].reshape(3, 3, c1, c2).permute(3, 2, 0, 1)
    pad = torch.cat([taps[:, c1:].flatten(), taps[:, :c1, c2:].flatten(), ap[c1:], bp[c1:]])
    return ap[:c1], bp[:c1], w, pad


def relu_affine_conv3x3_cuda(y, a, b, w, packed=None):
    """Launch the CUDA kernel. y: [B,C1,H,W] f32 or bf16 on a card; a, b:
    [C1]; w: [C2,C1,3,3]; ``packed``: ``pack(a, b, w, y.dtype)`` made
    earlier, else it is made here. Returns [B,C2,H,W] channels_last in y's
    dtype."""
    _check(y, a, b, w)
    if not y.is_cuda:
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got {y.device}")
    if y.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel supports float32 and bfloat16, not {y.dtype}")
    bsz, c1, h, wid = y.shape
    c2 = w.shape[0]
    dt, dev = y.dtype, y.device
    y = y.contiguous(memory_format=torch.channels_last)
    ap, bp, wp = pack(a, b, w, dt) if packed is None else packed
    bf = dt == torch.bfloat16
    bn, mt = tile_config(c2) if bf else (_N_BLOCK_F32, 0)
    c1p = _round_up(c1, _K_CHUNK if bf else _K_CHUNK_F32)
    c2p = _round_up(c2, bn)
    want = (c2p // bn, c1p // _K_CHUNK, 9, bn, _K_CHUNK) if bf else (9, c1p, c2p)
    if tuple(wp.shape) != want or ap.shape != (c1p,) or any(
        t.dtype != dt or t.device != dev or not t.is_contiguous() for t in (ap, bp, wp)
    ):
        raise ValueError(f"packed operands do not fit y {tuple(y.shape)} {dt}, C2={c2}")
    out = torch.empty(
        (bsz, c2, h, wid), dtype=dt, device=dev, memory_format=torch.channels_last
    )
    if out.numel() == 0:
        return out
    lib = _load(dev)
    vec = int(c1 % 8 == 0 and y.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        err = lib.fp_relu_affine_conv3x3(
            y.data_ptr(), ap.data_ptr(), bp.data_ptr(), wp.data_ptr(),
            out.data_ptr(), bsz, h, wid, c1, c2, c1p, c2p, int(bf), vec, bn, mt,
            cuda_build.sm_count(dev), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{KERNEL} launch failed: {cuda_build.error_string(lib, 'fp', err)} "
            f"(y {tuple(y.shape)} {dt}, C2={c2})"
        )
    LAUNCHES[KERNEL] += 1
    return out


# The op as a torch.library custom op, so that torch.export can carry it
# into a program (tools/export_model.py): the kernel's ctypes launch cannot
# be traced, the fake implementation below stands in for it. ``ap``, ``bp``
# and ``wp`` are ``pack``'s operands, all three or none.
@torch.library.custom_op(
    f"floodplanet::{KERNEL}", mutates_args=(), device_types="cuda",
    schema="(Tensor y, Tensor a, Tensor b, Tensor w, Tensor? ap=None, Tensor? bp=None, "
           "Tensor? wp=None) -> Tensor",
)
def _op(y, a, b, w, ap=None, bp=None, wp=None):
    return relu_affine_conv3x3_cuda(y, a, b, w, None if ap is None else (ap, bp, wp))


@_op.register_kernel("cpu")
def _op_cpu(y, a, b, w, ap=None, bp=None, wp=None):
    # channels_last, as the kernel and the fake return it; a no-op for the
    # model's activations, which are channels_last already.
    return relu_affine_conv3x3_plain(y, a, b, w).contiguous(memory_format=torch.channels_last)


@_op.register_fake
def _op_fake(y, a, b, w, ap=None, bp=None, wp=None):
    _check(y, a, b, w)
    return y.new_empty((y.shape[0], w.shape[0], *y.shape[2:])).contiguous(
        memory_format=torch.channels_last)


def _op_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:4])


def _op_backward(ctx, grad):
    # Recompute z and differentiate the unfused chain (the JAX package's
    # _bwd, conv_fused.py:228-234): the same expression the kernel
    # evaluates, so gradients equal the unfused path's. The packed operands
    # get none.
    saved = ctx.saved_tensors
    inputs = [t.detach().requires_grad_(need) for t, need in zip(saved, ctx.needs_input_grad)]
    wanted = [t for t in inputs if t.requires_grad]
    grads = iter(())
    if wanted:
        with torch.enable_grad():
            out = relu_affine_conv3x3_plain(*inputs)
            grads = iter(torch.autograd.grad(out, wanted, grad.to(saved[0].dtype)))
    return (*(next(grads) if t.requires_grad else None for t in inputs),
            *(None,) * (len(ctx.needs_input_grad) - len(inputs)))


_op.register_autograd(_op_backward, setup_context=_op_setup)


def relu_affine_conv3x3(y, a, b, w, packed=None):
    """``conv3x3_SAME(relu(y*a + b), w)`` with z never in device memory.

    y: [B,C1,H,W] in the compute dtype; a, b: [C1] (the folded BN apply,
    f32); w: [C2,C1,3,3] f32 params; ``packed``: the kernel's operands from
    ``pack`` (made per call when None). Returns [B,C2,H,W] channels_last in
    y's dtype. A CUDA tensor runs the kernel, a CPU tensor the plain
    version; the op is ``torch.ops.floodplanet.relu_affine_conv3x3``.
    """
    return _op(y, a, b, w, *(packed if packed is not None else (None, None, None)))
