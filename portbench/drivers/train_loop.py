"""Driver of the training cells: the step loop as ``fit_model`` runs it.

Set-up: the traffic's scenes (or chips) written from the seed, the port's
dataset over them and its HBM scene cache (``data/device_cache.py``), the
port's model with the benchmark's weights, ``create_train_state``,
``make_augment_step`` (the config's transforms in the compute dtype) and
``make_train_step`` (augmentation outside the step, as the fit has it).
Every step is the fit's: one cache gather of a batch of the seeded epoch
order, the augment step on the epoch's generator, the train step, all under
``deterministic_algorithms()``. The first ``check_steps`` steps run in the
set-up through that same call and feed, on rows that all differ; the
optimizer's moments after the first and the state after the last are kept
for the check. The scene files are deleted once the cache holds them (the
loop never reads them again), so the set-up leaves nothing to write back
to the disk during the window. Then the window steps on, from the same
objects, for ``--seconds``; it ends in a synchronize.

``--trace 1`` times the three calls of every step with CUDA events, and
runs ``trace_steps`` more steps under torch.profiler with a span around
each call.
"""

from __future__ import annotations

import dataclasses
import gc
import shutil
import time

import numpy as np
import torch

from portbench import counts, harness, system
from portbench.reference import judge


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The augmentation generator of one epoch, from (seed, epoch)."""
    state = np.random.SeedSequence((int(seed), int(epoch))).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


class Loop:
    """The fit's loop over the cache, epoch after epoch."""

    def __init__(self, spec: dict, seed: int, device, workdir: str):
        from floodplanet_code_tpu_torch.data.augment import TransformParams
        from floodplanet_code_tpu_torch.data.device_cache import (
            build_device_cache, make_batch_builder)
        from floodplanet_code_tpu_torch.train.fit import (
            make_augment_step, make_train_step, resolve_ignore_index)
        from floodplanet_code_tpu_torch.train.state import create_train_state

        config, traffic = spec["config"], spec["traffic"]
        self.seed, self.device = seed, device
        self.cfg = cfg = system.program_config(config)
        scenes = system.scene_list(config, harness.sizes(traffic["scenes"]))
        root = system.fresh_dir(f"{workdir}/data")
        system.write_scenes(config, root, scenes, seed, device)
        self.dataset = system.dataset(cfg, root, [s[1] for s in scenes], config["crop"],
                                      config["stride"])
        self.cache = build_device_cache(self.dataset, traffic["cache_bytes"], device,
                                        cfg.n_workers)
        if self.cache is None:
            raise RuntimeError("the scenes do not fit the scene cache's budget")
        shutil.rmtree(root)  # held by the cache; unwritten pages are dropped, not flushed
        self.build = make_batch_builder(self.cache)
        self.batch_size = int(config["batch_size"])
        self.model = system.model(cfg, config, device,
                                  harness.reference(config).weights(config, seed, device))
        self.state = create_train_state(self.model, None, lr=cfg.lr,
                                        optimizer_name=cfg.model.model_kwargs.optimizer_name)
        self.ignore_index = resolve_ignore_index(cfg.ignore_index, config["n_classes"])
        off = TransformParams(False, 0, False, 0, False, 0)
        self.train_step = make_train_step(self.model, self.ignore_index, off,
                                          loss_cfg=cfg.select("loss"), fuse_augmentation=False)
        transforms = dataclasses.replace(TransformParams.from_config(cfg.transforms),
                                         dtype=cfg.tpu.compute_dtype)
        self.augment_step = make_augment_step(transforms, self.ignore_index)
        self.epoch, self.position, self.order, self.generator = -1, 0, None, None

    def next_rows(self) -> np.ndarray:
        """The next batch's dataset indices (drop_last; a new epoch's order
        and generator when one runs out)."""
        if self.order is None or self.position + self.batch_size > len(self.order):
            self.epoch += 1
            self.order = np.random.default_rng((self.seed, self.epoch)).permutation(
                len(self.dataset))
            self.generator = epoch_generator(self.seed, self.epoch, self.device)
            self.position = 0
        idx = self.order[self.position:self.position + self.batch_size]
        self.position += self.batch_size
        return idx

    def gather(self, idx):
        return self.build(self.cache.index_rows(self.dataset, idx))

    def step(self, events=None, spans=False, capture=None):
        """One step of the fit: gather, augment, train. ``events``: a list
        that gets each call's pair of CUDA events; ``spans``: a profiler
        span around each call; ``capture``: a list that gets (indices, the
        generator's state before the draws, the step's logs)."""
        idx = self.next_rows()
        before = self.generator.get_state() if capture is not None else None
        batch = self._timed("gather", lambda: self.gather(idx), events, spans)
        batch = self._timed("augment", lambda: self.augment_step(self.generator, batch),
                            events, spans)
        _, logs = self._timed("step", lambda: self.train_step(self.state, batch), events, spans)
        if capture is not None:
            capture.append((idx, before, logs))

    @staticmethod
    def _timed(name, fn, events, spans):
        if events is not None:
            pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            pair[0].record()
        if spans:
            with torch.profiler.record_function(f"portbench.{name}"):
                out = fn()
        else:
            out = fn()
        if events is not None:
            pair[1].record()
            events.append((name, pair))
        return out


def run(spec: dict, seed: int, seconds: float, trace: bool, device, t0: float,
        workdir: str) -> dict:
    from floodplanet_code_tpu_torch.train.fit import deterministic_algorithms

    config, traffic = spec["config"], spec["traffic"]
    loop = Loop(spec, seed, device, workdir)
    captured = []
    with deterministic_algorithms():
        for k in range(int(traffic["check_steps"])):
            loop.step(capture=captured)
            if k == 0:  # the first gradient, as Adam's first moment holds it
                opt = loop.state.optimizer
                first_grads = {n: (opt.state[p]["exp_avg"] / 0.1).detach().clone()
                               if p in opt.state else torch.zeros_like(p)
                               for n, p in loop.model.named_parameters()}
        after = {n: t.detach().clone() for n, t in loop.model.state_dict().items()}
        _sync(device)
        setup_s = time.perf_counter() - t0

        events = [] if trace and device.type == "cuda" else None
        start = time.perf_counter()
        steps = 0
        while True:
            loop.step(events)
            steps += 1
            if time.perf_counter() - start >= seconds:
                break
        _sync(device)
        elapsed = time.perf_counter() - start

        trace_out = None
        if trace and device.type == "cuda":
            k = int(traffic["trace_steps"])
            trace_out = harness.traced(lambda: [loop.step() for _ in range(k)],
                                       lambda: [loop.step(spans=True) for _ in range(2)],
                                       f"{workdir}/trace.json")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    program = {"losses": [float(logs["loss"]) for _, _, logs in captured],
               "first_grads": first_grads, "after": after}
    del loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    draws = []
    for _, state, _ in captured:
        g = torch.Generator(device=device)
        g.set_state(state)
        draws.append(torch.rand(4, int(config["batch_size"]), generator=g, device=device))
    weights = harness.reference(config).weights(config, seed, device)
    reference = judge.train_reference(
        config, seed, weights, system.scene_list(config, harness.sizes(traffic["scenes"])),
        [idx for idx, _, _ in captured], draws, config["transforms"],
        _resolved_ignore(config), device)
    numbers = judge.train_numbers(program, reference, weights)
    checks = judge.within(numbers, spec["limits"])

    ops = harness.reference(config).work(config, int(config["batch_size"]), config["crop"],
                                         config["crop"])
    work = counts.by_kind(ops, config["compute_dtype"], True)
    tiles = steps * int(config["batch_size"])
    ctx = {"trace": trace_out, "trace_steps": int(traffic["trace_steps"]),
           "events": _event_ms(events),
           "window": {"seconds": elapsed, "steps": steps, "tiles": tiles},
           "peak_flops": counts.PEAK_FLOPS[config["compute_dtype"]],
           "train_flops_per_step": counts.train_flops(ops),
           "conv_bound_s_per_step": work.get("conv", {}).get("bound_s"),
           "work_by_kind": work}
    return {"attempted": steps, "failed": 0, "setup_s": setup_s, "memory_peak_bytes": peak,
            "e2e": {"train_tiles_per_s": tiles / elapsed}, "ctx": ctx, "checks": checks,
            "numbers": numbers}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _resolved_ignore(config: dict) -> int:
    """The train step's ignore class: -1 stands for the last class."""
    ii = int(config["ignore_index"])
    return config["n_classes"] - 1 if ii == -1 else ii


def _event_ms(events) -> dict | None:
    if events is None:
        return None
    out: dict = {}
    for name, (a, b) in events:
        out.setdefault(name, []).append(a.elapsed_time(b))
    return out
