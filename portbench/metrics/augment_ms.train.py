"""Augment: device milliseconds per batch of ``make_augment_step`` (flips
and the three-shear rotation, ``data/augment.py`` -> ``ops/rotate.py``),
CUDA events around the call in every step of the traced run's window, mean."""


def read(ctx):
    values = (ctx.get("events") or {}).get("augment")
    return sum(values) / len(values) if values else None
