"""Scene cache: megabytes (1e6 bytes) a request copies from the host to the
device (the port's ``h2d_bytes`` counter: the scene stacks, the gathers'
index rows, the stitcher's validity masks and tile selections), mean over
every request the process served (``program_trace``)."""

from portbench import program_trace


def read(ctx):
    n = program_trace.per_root_count("serve.request", "h2d_bytes")
    return None if n is None else n / 1e6
