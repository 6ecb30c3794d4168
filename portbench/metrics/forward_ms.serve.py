"""Forward: device milliseconds per batch of the sliding-window forward
(``sliding.make_predict_step``: the model and the softmax, eight times under
TTA), from the ``forward_events`` that ``sliding_window_predict`` records
in the traced run's window, mean over the batches."""


def read(ctx):
    values = ctx.get("forward_ms")
    return sum(values) / len(values) if values else None
