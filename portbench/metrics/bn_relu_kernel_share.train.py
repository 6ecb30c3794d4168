"""Train step: the share, in percent, of the train-mode BatchNorm-ReLU calls
(forwards and backwards) that ran the hand-written kernels, from the port's
``bn_relu.kernel`` and ``bn_relu.plain`` counters over everything the
process did. None where the program has neither counter."""

from portbench import program_trace


def read(ctx):
    trace = program_trace.tracer()
    if trace is None:
        return None
    counts = trace.counters()
    kernel, plain = counts.get("bn_relu.kernel", 0), counts.get("bn_relu.plain", 0)
    if kernel + plain == 0:
        return None
    return 100.0 * kernel / (kernel + plain)
