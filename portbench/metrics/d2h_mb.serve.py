"""Request path: megabytes (1e6 bytes) a request copies from the device to
the host (the port's ``d2h_bytes`` counter: each scene's f32 probability
canvas), mean over every request the process served (``program_trace``)."""

from portbench import program_trace


def read(ctx):
    n = program_trace.per_root_count("serve.request", "d2h_bytes")
    return None if n is None else n / 1e6
