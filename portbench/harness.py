"""What every run shares: the manifest and a cell's files, found by name;
the guards; the card's description; the profiler trace's reduction; the
per-layer metric readers; the result line.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``, whose ``kind`` names its driver,
``drivers/<kind>.py``); its correctness limits are ``limits/<cell>.json``;
a per-layer metric's reader is ``metrics/<metric>.py``. A metric named
``<base>.<variant>`` with no value or reader of its own is a variant of
``<base>``: the same quantity for the cells it lists, under a bound of its
own (so a cell whose runs spread more than the others' takes a wider bound
as entries alone). A configuration names its model's plain reference
(``"reference": "<module>"``, ``reference/<module>.py``: its tensors,
weights, training steps, served probabilities, batch statistics and
operation counts; the interface is in ``reference/__init__.py``), and
``"overrides"``: the port's configuration keys that its cells set beyond
the harness's own. The drivers, the judge and the counts name no model.

So a configuration of a model the benchmark has, a traffic mix of a kind
it has, a cell, its limits or a per-layer metric is new files and entries
in ``BENCHMARK.json``; a model it does not have is also a new reference
module. No edit here or in the drivers. The port itself has to build the
model by the configuration's ``model`` name.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# Top-level module names the process must never hold: JAX and the JAX
# package. Compared whole, so the port (floodplanet_code_tpu_torch) passes.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "orbax", "floodplanet_code_tpu")

# Classes of device kernels by name (scripts/torch_determinism.py's rule),
# for the breakdown; the first match wins.
KERNEL_CLASSES = [
    ("fused conv kernel", ("conv_bf16_wgmma_kernel", "conv_f32_kernel")),
    ("shear kernel", ("shear_kernel", "shear_h_kernel")),
    ("cuDNN conv", ("conv", "xmma", "gemm", "cudnn", "cutlass", "wgrad", "dgrad")),
    ("optimizer", ("adam",)),
    ("reductions", ("reduce",)),
    ("BatchNorm-ReLU kernels", ("bnrelu",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "where", "copy", "fill")),
]


def forbidden_modules(modules=None) -> list[str]:
    """The names in ``modules`` (default ``sys.modules``) whose top-level
    name is one of ``FORBIDDEN_MODULES``."""
    modules = sys.modules if modules is None else modules
    return sorted(name for name in modules if name.split(".")[0] in FORBIDDEN_MODULES)


def sizes(entries: list) -> list:
    """A traffic file's scene sizes: [h, w] once, or [h, w, count]."""
    out = []
    for e in entries:
        out += [(int(e[0]), int(e[1]))] * (int(e[2]) if len(e) > 2 else 1)
    return out


def load_json(path: str) -> dict:
    with open(path) as handle:
        return json.load(handle)


def manifest(root: str) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell_files(bench: dict, name: str) -> dict:
    """The cell ``name`` with its configuration, traffic mix and limits
    loaded; raises KeyError for an unknown cell and FileNotFoundError for a
    missing file."""
    cells = {w["name"]: w for w in bench["workloads"]}
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]
    config = load_json(os.path.join(os.path.dirname(HERE), entry["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))
    limits = load_json(os.path.join(HERE, "limits", name + ".json"))
    return {"cell": cell, "config": config, "traffic": traffic, "limits": limits}


def metrics_for(bench: dict, cell: str, section: str) -> list[dict]:
    """The ``section`` ("end_to_end" or "per_layer") metrics this cell
    reports: those without a ``workloads`` key, and those that list it."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def variant_value(values: dict, name: str):
    """``values[name]``; for a variant ``<base>.<variant>`` that ``values``
    does not hold, its base's value; None where neither is there."""
    while name not in values and "." in name:
        name = name.rsplit(".", 1)[0]
    return values.get(name)


def reader(name: str):
    """``metrics/<name>.py``'s ``read(ctx) -> float | None``; a variant
    ``<base>.<variant>`` without a file of its own reads with its base's."""
    path = os.path.join(HERE, "metrics", name + ".py")
    if not os.path.exists(path) and "." in name:
        return reader(name.rsplit(".", 1)[0])
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(kind: str):
    return importlib.import_module(f"portbench.drivers.{kind}")


def reference(config: dict):
    """The reference module that ``config`` names."""
    return importlib.import_module(f"portbench.reference.{config['reference']}")


def pin_caches(root: str) -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths, and every library from loading JAX; deterministic cuBLAS (the
    fit's deterministic algorithms need it before the first cuBLAS call)."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "portbench_cache", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "build", "portbench_cache",
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def work_dir(cell: str) -> str:
    """This cell's scratch directory under ``TMPDIR``, at a fixed path."""
    base = os.environ.get("TMPDIR") or os.path.join(os.path.expanduser("~"), ".cache")
    return os.path.join(base, "portbench", cell)


def card() -> dict:
    """The card's name, its count and its power limit (nvidia-smi)."""
    import torch

    limit = None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True)
        limit = float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return {"name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
            "power_limit_w": limit}


# -- the profiler's trace -------------------------------------------------------


def kernel_class(name: str) -> str:
    low = name.lower()
    return next((c for c, subs in KERNEL_CLASSES if any(x in low for x in subs)), "other")


def reduce_trace(path: str) -> dict:
    """A torch.profiler chrome trace reduced to what the readers use: its
    kernels as (name, start us, duration us); the device-busy time as the
    union of their intervals over the traced window (from the first event to
    the last kernel's end); the idle gaps between kernels, each labelled by
    the harness span (``portbench.*`` annotation) the host was in when the
    gap began."""
    with open(path) as handle:
        events = [e for e in json.load(handle)["traceEvents"] if e.get("ph") == "X"]
    kernels = sorted((e["ts"], e["dur"], e["name"]) for e in events if e.get("cat") == "kernel")
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation" and e["name"].startswith("portbench."))
    busy, end, gaps = 0.0, -math.inf, []
    for start, dur, _ in kernels:
        if end > -math.inf and start > end:
            gaps.append((end, start - end))
        if start + dur > end:
            busy += start + dur - max(start, end)
            end = start + dur
    first = min(e["ts"] for e in events) if events else 0.0
    window = (end - first) if kernels else 0.0

    def label(t):
        inside = [s for s in spans if s[0] <= t < s[1]]
        return min(inside, key=lambda s: s[1] - s[0])[2] if inside else "outside the spans"

    gaps.sort(key=lambda g: -g[1])
    return {"kernels": [(n, s, d) for s, d, n in kernels], "busy_us": busy,
            "window_us": window,
            "gaps": [(label(t), d) for t, d in gaps[:10]]}


def breakdown(trace: dict) -> dict:
    """The ``--trace 1`` line's breakdown: device seconds by kernel class,
    then by kernel name (ten entries together), and the ten longest idle
    gaps named by what the host was doing."""
    by_class, by_name = {}, {}
    for name, _, dur in trace["kernels"]:
        c = kernel_class(name)
        by_class[c] = by_class.get(c, 0.0) + dur / 1e6
        by_name[name] = by_name.get(name, 0.0) + dur / 1e6
    classes = sorted(by_class.items(), key=lambda kv: -kv[1])
    names = sorted(by_name.items(), key=lambda kv: -kv[1])
    ops = [[f"class: {c}", s] for c, s in classes][:5]
    ops += [[n[:160], s] for n, s in names][:10 - len(ops)]
    return {"device_ops": ops, "idle_gaps": [[n, d / 1e6] for n, d in trace["gaps"]]}


def profile(fn, trace_path: str, host: bool = False) -> dict:
    """Run ``fn`` under torch.profiler, export the chrome trace to
    ``trace_path``, reduce it, delete the file. Device activity only by
    default: recording every host operation as well (``host``) slows the
    host enough to idle the device, so such a trace serves only to name
    what the host was doing in each gap."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with torch_profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(trace_path)
    try:
        return reduce_trace(trace_path)
    finally:
        os.remove(trace_path)


def traced(device_fn, host_fn, trace_path: str) -> dict:
    """The device-only trace of ``device_fn`` with the idle gaps of a
    host-and-device trace of ``host_fn`` (their labels need the host's
    spans)."""
    out = profile(device_fn, trace_path)
    out["gaps"] = profile(host_fn, trace_path, host=True)["gaps"]
    return out


# -- the result -----------------------------------------------------------------


def checks_text(checks: dict) -> list[str]:
    return [f"check {name}: {c['value']!r} limit {c['limit']!r}" for name, c in checks.items()]


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown_: dict | None = None) -> str:
    """The last line of standard output; the checks come last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown_ is not None:
        out["breakdown"] = breakdown_
    out["checks"] = checks
    return json.dumps(out)
