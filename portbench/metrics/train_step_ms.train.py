"""Train step: device milliseconds per step of ``make_train_step`` (forward,
loss, confusion, autograd, fused Adam), CUDA events around the call in
every step of the traced run's window, mean."""


def read(ctx):
    values = (ctx.get("events") or {}).get("step")
    return sum(values) / len(values) if values else None
