"""Conv kernels in training: the least time the card could take for every
conv of the traced steps (forward, dgrad, wgrad; ``portbench/counts.py``,
the algorithm's operations and bytes, whatever runs the conv) over the
device time of the conv kernels in the profiler's trace, in percent."""

# A conv's kernels, by name: the hand-written fused conv, and what cuDNN or
# cuBLAS launch for a convolution (its implicit GEMMs and layout
# transposes). PyTorch's own kernels (at::native) are never a conv's.
CONV = ("conv_bf16_wgmma", "conv_f32_kernel", "xmma", "cudnn", "cutlass", "implicit",
        "fprop", "dgrad", "wgrad", "gemm", "convolve")


def conv_seconds(trace) -> float:
    return sum(d for name, _, d in trace["kernels"]
               if "at::native" not in name and any(p in name.lower() for p in CONV)) / 1e6


def read(ctx):
    trace = ctx.get("trace")
    if not trace:
        return None
    spent = conv_seconds(trace)
    if spent <= 0:
        return None
    return 100.0 * ctx["conv_bound_s_per_step"] * ctx["trace_steps"] / spent
