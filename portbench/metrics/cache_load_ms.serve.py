"""Scene cache: milliseconds per request that the request thread waits for
the scene reader threads (decode and normalize; ``scene_cache.load`` in
``data/device_cache.py::_load_stacks``), summed within a request, mean over
every request the process served: the set-up's 2, the window's and the
traced ones (``program_trace``)."""

from portbench import program_trace


def read(ctx):
    return program_trace.per_root_ms("serve.request", "scene_cache.load")
