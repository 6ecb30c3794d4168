#!/usr/bin/env python3
"""The benchmark of the PyTorch port (``floodplanet_code_tpu_torch``) on one
NVIDIA card. One run of one cell of ``BENCHMARK.json``:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It sets the system up from the seed, measures
for ``--seconds`` seconds, checks what the timed path produced against the
plain reference (``portbench/reference/``), prints each compared number
beside its limit as the last lines of standard error and, as the last line
of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics; with ``--trace 1``
its per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last. It refuses to run without a card, or with fewer cards than
the cell asks for, and fails if JAX or the JAX package was ever imported.
"""

import time

T0 = time.perf_counter()  # set-up is timed from the start of the process

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402


def measure(bench: dict, name: str, seed: int, seconds: float, trace: bool, device,
            t0: float) -> tuple[str, list[str]]:
    """One run of cell ``name`` on ``device``: (the result line, the check
    lines for standard error)."""
    import torch

    spec = harness.cell_files(bench, name)
    harness.pin_caches(ROOT)
    workdir = harness.work_dir(name)
    os.makedirs(workdir, exist_ok=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out = harness.driver(spec["traffic"]["kind"]).run(
        spec, seed, seconds, trace, device, t0, workdir)
    gc.collect()

    metrics = {}
    if not trace:
        values = dict(out["e2e"], setup_s=out["setup_s"])
        for m in harness.metrics_for(bench, name, "end_to_end"):
            value = harness.variant_value(values, m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in harness.metrics_for(bench, name, "per_layer"):
            value = harness.reader(m["name"])(out["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    breakdown = None
    trace_out = out["ctx"].get("trace")
    if trace and trace_out is not None:
        device_info["busy_s"] = trace_out["busy_us"] / 1e6
        device_info["window_s"] = trace_out["window_us"] / 1e6
        breakdown = harness.breakdown(trace_out)
    from portbench.reference import judge

    correct = judge.passes(out["checks"])
    line = harness.result_line(correct, out["attempted"], out["failed"], metrics, device_info,
                               out["checks"], breakdown)
    numbers = {k: v for k, v in out["numbers"].items() if k not in out["checks"]}
    return line, [f"not compared: {numbers}"] + harness.checks_text(out["checks"])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    found = harness.forbidden_modules()
    if found:
        print(f"refused: JAX or the JAX package is loaded: {found}", file=sys.stderr)
        return 4
    bench = harness.manifest(ROOT)
    cell = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if cell is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"refused: the cell needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
              file=sys.stderr)
        return 3
    card = harness.card()
    print(f"card: {card['name']}, {card['count']} present, power limit "
          f"{card['power_limit_w']} W", file=sys.stderr, flush=True)
    line, check_lines = measure(bench, args.workload, args.seed, args.seconds,
                                bool(args.trace), torch.device("cuda:0"), T0)
    found = harness.forbidden_modules()
    if found:
        print(f"refused: JAX or the JAX package was loaded during the run: {found}",
              file=sys.stderr)
        return 4
    print(line, flush=True)
    for text in check_lines:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
