"""The whole training step's share of the card's peak: the operations of
every step of the traced run's window (the reference module's ``work``,
every pass of every operation, ``portbench/counts.py``; for the UNet its
convs, 3 x forward less the first conv's dgrad) over the window's host
seconds times the dense peak of the compute dtype, in percent."""


def read(ctx):
    w = ctx["window"]
    if not w["steps"] or w["seconds"] <= 0:
        return None
    return 100.0 * ctx["train_flops_per_step"] * w["steps"] / (w["seconds"] * ctx["peak_flops"])
