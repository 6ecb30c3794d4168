"""Request path: milliseconds per request of finishing each scene's canvas
and copying it to the host (``stitch.fetch``: ``DeviceStitcher.pop_combined``,
the wait for the queued work included), summed within a request, mean over
every request the process served (``program_trace``)."""

from portbench import program_trace


def read(ctx):
    return program_trace.per_root_ms("serve.request", "stitch.fetch")
