"""Scene cache: milliseconds per request of the host's copies of the image
and label stacks to the device (``scene_cache.copy`` in
``data/device_cache.py::_load_stacks``), summed within a request, mean over
every request the process served (``program_trace``)."""

from portbench import program_trace


def read(ctx):
    return program_trace.per_root_ms("serve.request", "scene_cache.copy")
