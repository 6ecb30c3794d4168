"""The whole forward's share of the card's peak in serving: the
operations of every model forward of the traced run's window (batches,
times eight under TTA; the reference module's ``work``,
``portbench/counts.py``) over the window's host seconds times the dense
peak of the compute dtype, in percent."""


def read(ctx):
    w = ctx["window"]
    if not w["model_forwards"] or w["seconds"] <= 0:
        return None
    return 100.0 * ctx["forward_flops_per_batch"] * w["model_forwards"] / (
        w["seconds"] * ctx["peak_flops"])
