#!/usr/bin/env python3
"""The readings that the correctness limits of ``limits/<cell>.json`` are
set from, on the card at the cell's own size, in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 ... \\
        [--seconds 2] [--control-seeds 1 2 3]

- ``--seeds``: the system's own runs (the cell's driver with a short
  window), one JSON line per seed with the numbers it compares: the lower
  readings.
- ``--control-seeds``: the control, the plain reference computed in fp8 (e4m3
  with one scale per tensor, every convolution's input and weight) put in
  the system's place, against the float32 reference on the same inputs;
  for a training cell also the planted fault "half of the batch left out,
  the mean taken over the rest". The upper readings. Beside them, the
  witness: the reference rounded to bfloat16 where the system rounds,
  which should read as the system does.
- ``--float32``: the system's runs in float32 (TF32 off), a second witness
  that should meet the reference to rounding.

A state left unchanged reads 1 on ``change`` by the measure itself and
needs no run. The benchmark's own runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import harness, system  # noqa: E402
from portbench.drivers import serve_requests, train_loop  # noqa: E402
from portbench.reference import common  # noqa: E402
from portbench.reference import data as rdata  # noqa: E402
from portbench.reference import judge  # noqa: E402


def train_upper(spec: dict, seed: int, device) -> dict:
    """The control and the half-batch fault of a training cell, each
    against the float32 reference, on the run's first steps."""
    config, traffic = spec["config"], spec["traffic"]
    scenes = system.scene_list(config, harness.sizes(traffic["scenes"]))
    n = sum(len(rdata.crop_slices(h, w, config["crop"], config["stride"]))
            for _, _, _, (h, w) in scenes)
    b = int(config["batch_size"])
    order = np.random.default_rng((seed, 0)).permutation(n)
    steps = [order[k * b:(k + 1) * b] for k in range(int(traffic["check_steps"]))]
    g = train_loop.epoch_generator(seed, 0, device)
    draws = [torch.rand(4, b, generator=g, device=device) for _ in steps]
    weights = harness.reference(config).weights(config, seed, device)
    ignore = train_loop._resolved_ignore(config)
    args = (config, seed, weights, scenes, steps, draws, config["transforms"], ignore, device)
    ref = judge.train_reference(*args)
    return {name: judge.train_numbers(judge.train_reference(*args, **kw), ref, weights)
            for name, kw in (("control", {"quant": common.fp8_quant}),
                             ("half_batch", {"keep_rows": b // 2}),
                             ("witness_bf16", {"quant": common.bf16_round}))}


def serve_upper(spec: dict, seed: int, device) -> dict:
    """The control of a serving cell: on the roots a run would sample (the
    largest and others drawn from the seed), the gap of the mask the fp8
    reference serves against the float32 reference's probabilities."""
    config, traffic = spec["config"], spec["traffic"]
    tile, batch, tta = int(traffic["tile"]), int(traffic["batch"]), bool(traffic["tta"])
    roots = serve_requests.pool(config, traffic)
    weights = serve_requests.eval_weights(config, traffic, roots, seed, device)
    done = [{"root": r} for r in range(len(roots))]
    numbers, witness = [], []
    for d in serve_requests.sample(done, roots, tile, int(traffic["check_requests"]), seed):
        held = judge.Scenes(config, seed, device)
        for index, _, _, hw in roots[d["root"]][1]:
            image, _ = held.get(index, hw)
            ref = judge.scene_probabilities(config, weights, image, tile, batch, tta, device)
            low = judge.scene_probabilities(config, weights, image, tile, batch, tta, device,
                                            quant=common.fp8_quant)
            numbers.append(judge.mask_numbers(np.argmax(low, axis=-1) > 0, ref))
            bf16 = judge.scene_probabilities(config, weights, image, tile, batch, tta, device,
                                             quant=common.bf16_round)
            witness.append(judge.mask_numbers(np.argmax(bf16, axis=-1) > 0, ref))
    return {"control": judge.worst(numbers), "witness_bf16": judge.worst(witness)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--float32", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("refused: no CUDA card", file=sys.stderr)
        return 3
    bench = harness.manifest(ROOT)
    spec = harness.cell_files(bench, args.workload)
    harness.pin_caches(ROOT)
    device = torch.device("cuda:0")
    workdir = harness.work_dir(args.workload)
    os.makedirs(workdir, exist_ok=True)
    kind = spec["traffic"]["kind"]
    if args.float32:
        spec["config"]["compute_dtype"] = "float32"
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = harness.driver(kind).run(spec, seed, args.seconds, False, device, t0, workdir)
        print(json.dumps({"workload": args.workload, "seed": seed, "float32": args.float32,
                          "program": out["numbers"],
            "setup_s": out["setup_s"], "e2e": out["e2e"]}), flush=True)
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        upper = (train_upper if kind == "train_loop" else serve_upper)(spec, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed, **upper}), flush=True)
        torch.cuda.empty_cache()
    print(f"calibrate: {time.perf_counter() - T0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
