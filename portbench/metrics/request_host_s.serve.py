"""Request path: seconds per request that are not the forward's device
time (``InferenceService.infer_root``'s wall time less the sum of its
batches' forward events: dataset build, cache push, stitch, mask write and
waiting), mean over the traced run's window."""


def read(ctx):
    rows = [r for r in (ctx.get("requests") or []) if r["forward_s"] is not None]
    if not rows:
        return None
    return sum(r["wall_s"] - r["forward_s"] for r in rows) / len(rows)
