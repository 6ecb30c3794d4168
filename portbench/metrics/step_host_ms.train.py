"""Train step: host milliseconds to launch one ``make_train_step`` call
(the ``train.step`` span: forward, backward, optimizer and metrics launched,
the device running behind), mean over every step the process took: the
set-up's checked steps, the window's and the traced ones
(``program_trace``). Against ``train_step_ms.train``, the device's time
of a step, it says how far the host is from holding the device back."""

from portbench import program_trace


def read(ctx):
    recs = program_trace.records()
    steps = [r.end_ns - r.start_ns for r in recs or [] if r.name == "train.step"]
    return sum(steps) / len(steps) / 1e6 if steps else None
