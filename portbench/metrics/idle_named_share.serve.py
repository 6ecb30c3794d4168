"""Device: the share of the traced requests' device-idle time (the
device-only profiler trace, ``ctx["trace"]``) during which the host was
inside a program span, in percent; a root's own time outside its children
counts as unnamed (``program_trace.idle_named_share``)."""

from portbench import program_trace


def read(ctx):
    return program_trace.idle_named_share(ctx)
