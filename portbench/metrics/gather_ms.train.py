"""Scene cache: device milliseconds per batch of the HBM scene cache's gather
(``data/device_cache.py::make_batch_builder`` through ``cache_batches``'s
index rows), CUDA events around the call in every step of the traced run's
window, mean over the steps."""


def read(ctx):
    values = (ctx.get("events") or {}).get("gather")
    return sum(values) / len(values) if values else None
