"""Device idle share: 100 less the share of the traced window in which a
kernel ran (the union of the kernels' intervals in the profiler's trace,
from the trace's first event to its last kernel's end), in percent."""


def read(ctx):
    trace = ctx.get("trace")
    if not trace or trace["window_us"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_us"] / trace["window_us"])
