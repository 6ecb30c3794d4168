"""Driver of the serving cells: a closed loop with one client in the
process, calling ``InferenceService.infer_root`` (the daemon's request: a
root's dataset, the HBM scene cache, the sliding-window forward, the
on-device stitch, the georeferenced mask written) on a warm model.

Set-up: the traffic's pool of roots written from the seed (each a root of
one or more scenes, the sizes fixed by the traffic file, the pixels by the
seed), an experiment directory with the port's config and one checkpoint
of the benchmark's weights, the service, and one request on the largest and
one on the smallest root (every shape the window meets, and the largest
allocation), then a flush of what the set-up wrote. The window sends the
pool's roots in a seeded order, a new permutation each round, until
``--seconds`` have passed; it ends when its last request returns. Each
root's masks go to a directory of that root, overwritten by its next
request, as the daemon's default save directory is; the check reads the
last request of each sampled root.

``--trace 1`` wraps the port's calls in spans (dataset build, cache push,
forward, stitch, mask write) and passes ``forward_events`` to
``sliding_window_predict``, and runs ``trace_requests`` more requests under
torch.profiler.
"""

from __future__ import annotations

import contextlib
import gc
import math
import os
import sys
import time

import numpy as np
import torch

from portbench import counts, harness, inputs, system
from portbench.reference import common, judge


def pool(config: dict, traffic: dict) -> list:
    """[(root name, [(index, region, name, (h, w))])]: indices run over
    the whole pool, so every scene has its own data."""
    roots, first = [], 0
    for r, entries in enumerate(traffic["roots"]):
        sizes = harness.sizes(entries)
        region = None if config["dataset"] == "floodplanet" else system.S1F11_EVENTS[
            r % len(system.S1F11_EVENTS)]
        scenes = [(first + i, reg, name, hw)
                  for i, reg, name, hw in system.scene_list(config, sizes, region)]
        roots.append((f"root{r:03d}", scenes))
        first += len(sizes)
    return roots


def tiles_of(scenes: list, tile: int) -> int:
    return sum(math.ceil(h / tile) * math.ceil(w / tile) for _, _, _, (h, w) in scenes)


@contextlib.contextmanager
def traced_calls(forward_events: list):
    """Spans around the port's calls inside a request, and the forward
    events of ``sliding_window_predict``; everything restored on exit."""
    from floodplanet_code_tpu_torch.geo import tiff
    from floodplanet_code_tpu_torch.inference import infer as infer_mod
    from floodplanet_code_tpu_torch.inference import serve, sliding
    from floodplanet_code_tpu_torch.inference.stitcher import DeviceStitcher

    def span(name, fn):
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(f"portbench.{name}"):
                return fn(*args, **kwargs)
        return wrapped

    def predict_step_factory(original):
        def make(*args, **kwargs):
            return span("forward", original(*args, **kwargs))
        return make

    def sliding_with_events(original):
        def predict(*args, **kwargs):
            kwargs["forward_events"] = forward_events
            return original(*args, **kwargs)
        return predict

    saved = [(serve, "build_infer_dataset"), (sliding, "build_device_cache"),
             (sliding, "make_predict_step"), (infer_mod, "sliding_window_predict"),
             (DeviceStitcher, "add_batch"), (DeviceStitcher, "pop_combined"),
             (tiff, "imwrite")]
    originals = [(obj, name, getattr(obj, name)) for obj, name in saved]
    serve.build_infer_dataset = span("dataset_build", serve.build_infer_dataset)
    sliding.build_device_cache = span("cache_push", sliding.build_device_cache)
    sliding.make_predict_step = predict_step_factory(sliding.make_predict_step)
    infer_mod.sliding_window_predict = sliding_with_events(infer_mod.sliding_window_predict)
    DeviceStitcher.add_batch = span("stitch", DeviceStitcher.add_batch)
    DeviceStitcher.pop_combined = span("stitch", DeviceStitcher.pop_combined)
    tiff.imwrite = span("mask_write", tiff.imwrite)
    try:
        yield
    finally:
        for obj, name, value in originals:
            setattr(obj, name, value)


def eval_weights(config: dict, traffic: dict, roots: list, seed: int, device) -> dict:
    """The benchmark's weights for serving: the reference's ``weights`` with
    running statistics (where the model has any) set to the batch
    statistics of four tiles of the pool's first scene, so that the eval
    forward normalizes as training would."""
    from portbench.reference import data as rdata

    ref = harness.reference(config)
    weights = ref.weights(config, seed, device)
    index, _, _, hw = roots[0][1][0]
    image, label = inputs.scene(config, seed, index, hw, device)
    image = rdata.normalize(image, config["sensor"])
    tile = int(traffic["tile"])
    windows = rdata.crop_slices(hw[0], hw[1], tile, tile)[:4]
    x = np.stack([rdata.crop(image, label, w, tile, 0)[0] for w in windows])
    x = torch.from_numpy(x).to(device).permute(0, 3, 1, 2).contiguous()
    with common.no_tf32():
        weights.update(ref.batch_statistics(config, weights, x))
    return weights


def _checkpoint(cfg, config: dict, weights: dict, device, exp: str) -> str:
    """An experiment directory with ``cfg`` and one checkpoint of
    ``weights``, as the port writes them."""
    from floodplanet_code_tpu_torch.config import save_config
    from floodplanet_code_tpu_torch.train import checkpoint as ckpt
    from floodplanet_code_tpu_torch.train.state import create_train_state

    save_config(cfg, exp)
    model = system.model(cfg, config, device, weights)
    manager = ckpt.CheckpointManager(exp, save_top_k=1)
    entry = manager.save(create_train_state(model, None, cfg.lr), 0, {ckpt.MONITOR_KEY: 0.5})
    manager.wait_until_finished()
    return entry


def _request(service, root: str, out: str) -> float:
    """One request; its seconds from the call to the written masks."""
    start = time.perf_counter()
    service.infer_root(root, save_dir=out)
    return time.perf_counter() - start


def run(spec: dict, seed: int, seconds: float, trace: bool, device, t0: float,
        workdir: str) -> dict:
    from floodplanet_code_tpu_torch.inference.serve import InferenceService

    config, traffic = spec["config"], spec["traffic"]
    tile, batch, tta = int(traffic["tile"]), int(traffic["batch"]), bool(traffic["tta"])
    cfg = system.program_config(config, tile=tile, batch=batch)
    roots = pool(config, traffic)
    data = system.fresh_dir(f"{workdir}/roots")
    for name, scenes in roots:
        system.write_scenes(config, f"{data}/{name}", scenes, seed, device)
    exp = system.fresh_dir(f"{workdir}/exp")
    entry = _checkpoint(cfg, config, eval_weights(config, traffic, roots, seed, device), device,
                        exp)
    service = InferenceService(checkpoint_path=entry, tta=tta, device=device)
    sizes = [tiles_of(scenes, tile) for _, scenes in roots]
    out = system.fresh_dir(f"{workdir}/masks")
    for r in (int(np.argmax(sizes)), int(np.argmin(sizes))):
        _request(service, f"{data}/{roots[r][0]}", f"{out}/warm")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    os.sync()  # the set-up's writes leave the page cache before the window
    setup_s = time.perf_counter() - t0

    rng = np.random.default_rng((int(seed), 7))
    forward_events: list = []
    done, failed = [], 0
    tracing = traced_calls(forward_events) if trace and device.type == "cuda" else (
        contextlib.nullcontext())
    with tracing:
        start = time.perf_counter()
        k = 0
        while time.perf_counter() - start < seconds:
            for r in rng.permutation(len(roots)):
                n_events = len(forward_events)
                try:
                    wall = _request(service, f"{data}/{roots[r][0]}", f"{out}/{roots[r][0]}")
                except Exception as error:  # a failed request counts; the run goes on
                    print(f"request {k} on {roots[r][0]} failed: {error!r}", file=sys.stderr,
                          flush=True)
                    failed += 1
                    wall = None
                done.append({"root": int(r), "wall": wall, "dir": f"{out}/{roots[r][0]}",
                             "events": forward_events[n_events:]})
                k += 1
                if time.perf_counter() - start >= seconds:
                    break
        elapsed = time.perf_counter() - start
        trace_out, order = None, []
        if trace and device.type == "cuda":
            n = int(traffic["trace_requests"])
            order = rng.permutation(len(roots))[:n]
            trace_out = harness.traced(
                lambda: [_request(service, f"{data}/{roots[r][0]}", f"{out}/trace") for r in order],
                lambda: _request(service, f"{data}/{roots[order[0]][0]}", f"{out}/trace"),
                f"{workdir}/trace.json")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del service
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ok = [d for d in done if d["wall"] is not None]
    tiles = sum(sizes[d["root"]] for d in ok)
    numbers = check(spec, seed, roots, done, device)
    checks = judge.within(numbers, spec["limits"])

    ops = harness.reference(config).work(config, batch, tile, tile)
    work = counts.by_kind(ops, config["compute_dtype"], False)
    walls = [d["wall"] for d in ok]
    e2e = {"infer_tiles_per_s": tiles / elapsed}
    if walls:
        e2e["infer_request_s_p90"] = float(np.percentile(walls, 90))
    if len(walls) < 100:
        print(f"only {len(walls)} requests completed: a 90th percentile wants 100",
              file=sys.stderr, flush=True)
    requests = []
    for d in ok:
        forward = sum(a.elapsed_time(b) for a, b in d["events"]) / 1e3 if d["events"] else None
        requests.append({"wall_s": d["wall"], "forward_s": forward})
    passes = 8 if tta else 1
    ctx = {"trace": trace_out,
           "window": {"seconds": elapsed, "requests": len(ok), "tiles": tiles,
                      "model_forwards": passes * sum(math.ceil(sizes[d["root"]] / batch)
                                                     for d in ok)},
           "trace_forwards": passes * sum(math.ceil(sizes[r] / batch) for r in order),
           "requests": requests if trace else None,
           "forward_ms": [a.elapsed_time(b) for d in ok for a, b in d["events"]] or None,
           "peak_flops": counts.PEAK_FLOPS[config["compute_dtype"]],
           "forward_flops_per_batch": counts.forward_flops(ops),
           "conv_bound_s_per_batch": work.get("conv", {}).get("bound_s"),
           "work_by_kind": work}
    return {"attempted": len(done), "failed": failed, "setup_s": setup_s,
            "memory_peak_bytes": peak, "e2e": e2e, "ctx": ctx, "checks": checks,
            "numbers": numbers}


def sample(done: list, roots: list, tile: int, n: int, seed: int) -> list:
    """``n`` requests of the window drawn from the seed, each the last on
    its root (the one whose masks are on disk), the root with the most
    tiles among them."""
    last = {d["root"]: d for d in done}
    done = [last[r] for r in sorted(last)]
    if not done:
        return []
    sizes = [tiles_of(roots[d["root"]][1], tile) for d in done]
    largest = int(np.argmax(sizes))
    rest = [i for i in range(len(done)) if i != largest]
    rng = np.random.default_rng((int(seed), 11))
    picked = rng.choice(rest, size=min(n - 1, len(rest)), replace=False).tolist() if rest else []
    return [done[i] for i in [largest, *picked]]


def read_mask(path: str) -> np.ndarray | None:
    """A written mask as booleans (water), or None when it cannot be read."""
    from PIL import Image

    try:
        with Image.open(path) as image:
            return np.asarray(image) > 0
    except (OSError, ValueError):
        return None


def check(spec: dict, seed: int, roots: list, done: list, device) -> dict:
    """The sampled requests' masks against the reference
    (``judge.mask_numbers``, the largest of each over the scenes)."""
    config, traffic = spec["config"], spec["traffic"]
    tile = int(traffic["tile"])
    weights = eval_weights(config, traffic, roots, seed, device)
    numbers = []
    for d in sample(done, roots, tile, int(traffic["check_requests"]), seed):
        held = judge.Scenes(config, seed, device)
        for index, region, name, hw in roots[d["root"]][1]:
            image, _ = held.get(index, hw)
            probs = judge.scene_probabilities(config, weights, image, tile,
                                              int(traffic["batch"]), bool(traffic["tta"]),
                                              device)
            path = os.path.join(d["dir"], f"{region}_pred", _image_name(config, region, name))
            mask = read_mask(path) if d["wall"] is not None else None  # a failed request
            numbers.append(judge.mask_numbers(mask, probs))
    return judge.worst(numbers) or judge.mask_numbers(None, np.zeros((1, 1, 1)))


def _image_name(config: dict, region: str, name: str) -> str:
    if config["dataset"] == "sen1floods11":
        return f"{region}_{name}_S1Hand.tif"
    return f"{name}.tif"
