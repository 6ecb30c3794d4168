"""The work of a forward and of a training step, from shapes alone, and the
least time the card could take for it.

A configuration's reference module lists its operations (``work(config,
batch, height, width)``), each an ``Op``: its kind (``conv``, or any other
name a later metric reads), and the operations and bytes of each pass it
runs, ``fwd``, ``dgrad`` (the input's gradient) and ``wgrad`` (the
weight's). A pass that a training step does not run, such as the first
layer's input gradient, is absent. The counts are the algorithm's, so they
are the same whichever implementation runs an operation; bytes are each
input read once and each output written once.

Extended from the repository's ``bench_torch.py::conv_flops`` (which reads
the same shapes from a model's forward).
"""

from __future__ import annotations

from dataclasses import dataclass

# Published dense peaks of one NVIDIA H100 SXM (data sheet, 700 W, no
# sparsity): FLOP/s by compute dtype, and HBM3 bytes/s.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}
PASSES = ("fwd", "dgrad", "wgrad")


@dataclass(frozen=True)
class Op:
    name: str
    kind: str
    flops: dict  # pass -> operations
    bytes: dict  # pass -> bytes read and written


def conv(name: str, n: int, h: int, w: int, c_in: int, c_out: int, k: int, size: int,
         dgrad: bool = True) -> Op:
    """A k x k convolution (stride 1, "same" size) at ``size`` bytes a value:
    2·N·H·W·C_in·C_out·k² operations in each pass; forward x, w -> y; dgrad
    dy, w -> dx; wgrad x, dy -> dw. ``dgrad=False``: its input needs no
    gradient."""
    flops = 2.0 * n * h * w * c_in * c_out * k * k
    x = n * h * w * c_in * size
    y = n * h * w * c_out * size
    wt = c_in * c_out * k * k * size
    moved = {"fwd": x + wt + y, "dgrad": y + wt + x, "wgrad": x + y + wt}
    if not dgrad:
        del moved["dgrad"]
    return Op(name, "conv", {p: flops for p in moved}, moved)


def forward_flops(ops: list[Op]) -> float:
    return sum(op.flops["fwd"] for op in ops)


def train_flops(ops: list[Op]) -> float:
    """Every pass of every operation."""
    return sum(op.flops[p] for op in ops for p in PASSES if p in op.flops)


def by_kind(ops: list[Op], dtype: str, train: bool) -> dict:
    """{kind: {"flops", "bytes", "bound_s"}} of a forward (with ``train``, a
    training step): the operations and bytes of each kind's passes, and the
    least time the card could take for them: per operation and pass the
    larger of operations over the dtype's peak and bytes over the
    bandwidth, summed."""
    peak, passes = PEAK_FLOPS[dtype], PASSES if train else ("fwd",)
    out: dict = {}
    for op in ops:
        total = out.setdefault(op.kind, {"flops": 0.0, "bytes": 0, "bound_s": 0.0})
        for p in passes:
            if p in op.flops:
                total["flops"] += op.flops[p]
                total["bytes"] += op.bytes[p]
                total["bound_s"] += max(op.flops[p] / peak, op.bytes[p] / PEAK_BYTES)
    return out

