"""Request path: milliseconds per request of the host's per-batch stitch
(``stitch.add`` in ``inference/sliding.py``: grouping by scene, the tiles'
validity masks, ``index_select``, ``DeviceStitcher.add_batch``), summed
within a request, mean over every request the process served
(``program_trace``)."""

from portbench import program_trace


def read(ctx):
    return program_trace.per_root_ms("serve.request", "stitch.add")
