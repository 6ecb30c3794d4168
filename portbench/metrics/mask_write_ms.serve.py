"""Request path: milliseconds per request of the masks' argmax, clip and
GeoTIFF write (``mask.write`` in ``inference/infer.py::infer``), summed
within a request, mean over every request the process served
(``program_trace``)."""

from portbench import program_trace


def read(ctx):
    return program_trace.per_root_ms("serve.request", "mask.write")
