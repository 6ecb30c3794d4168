"""One call, one process per device: the entry the JAX ``fit_model`` has
for free (one process drives every local chip there).

``spawn(fn, args, devices=...)`` starts one rank per entry of ``devices``
with ``torch.multiprocessing`` (start method ``spawn``), joins them into a
group through a FileStore in a fresh temporary directory, and in rank r
calls ``fn(*args, **kwargs, device=devices[r])``. It returns every rank's
return value, in rank order (each rank pickles its own to a file, so launch
counters, losses and paths come back from every rank).

- The backend is NCCL when every rank has a card of its own, else gloo
  (the CPU, or ranks that share a card: NCCL refuses two ranks on one
  device). The choice is made from ``devices``, printed, and never
  changed: a failed NCCL init raises and is not retried on gloo.
- Every collective has the group's timeout (``timeout_s``), and the parent
  waits for the ranks with a deadline (``join_timeout_s``, None: none). A
  rank that raises, dies or outlives the deadline fails the call: the
  other ranks are terminated and the error names the rank, with its
  traceback.
- The CUDA kernels are built in the parent before the ranks start, so the
  ranks do not each pay (or race for) the build.
- ``pods`` lays the ranks out as that many nodes (``LOCAL_WORLD_SIZE`` and
  ``GROUP_RANK`` as torchrun sets them), which ``mesh.detect_n_pods``
  reads: two ranks on one machine can stand for two nodes.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from floodplanet_code_tpu_torch.parallel.multihost import DEFAULT_TIMEOUT_S


def backend_for(devices) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    devices = [torch.device(d) for d in devices]
    cards = [d for d in devices if d.type == "cuda"]
    if len(cards) == len(devices) and len({d.index or 0 for d in cards}) == len(cards):
        return "nccl"
    return "gloo"


def _build_kernels(devices) -> None:
    if any(torch.device(d).type == "cuda" for d in devices):
        from floodplanet_code_tpu_torch.ops import conv_fused, rotate

        conv_fused.build()
        rotate.build()


def _rank_main(rank, fn, args, kwargs, devices, backend, workdir, pods, timeout_s):
    world = len(devices)
    local_world = world // pods
    os.environ.update({
        "RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank % local_world),
        "LOCAL_WORLD_SIZE": str(local_world), "GROUP_RANK": str(rank // local_world),
    })
    device = torch.device(devices[rank])
    err = os.path.join(workdir, f"rank{rank}.err")
    try:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:
            # Ranks that share the host's cores: one intra-op thread each,
            # so that n ranks do not each start a thread per core.
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(workdir, 'store')}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s),
            device_id=device if backend == "nccl" else None,
        )
        try:
            result = fn(*args, **kwargs, device=device)
        except BaseException:
            # Written before the group goes down: the other ranks' errors
            # follow from this one, and the parent reports the first.
            with open(err, "w") as handle:
                handle.write(traceback.format_exc())
            raise
        finally:
            dist.destroy_process_group()
        torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
    except BaseException:
        if not os.path.exists(err):
            with open(err, "w") as handle:
                handle.write(traceback.format_exc())
        raise SystemExit(1)


def _stop(procs) -> None:
    procs = [p for p in procs if p.pid is not None]  # the started ones
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join()


def spawn(fn, args=(), kwargs=None, devices=("cpu", "cpu"), backend: str | None = None,
          pods: int = 1, timeout_s: float = DEFAULT_TIMEOUT_S,
          join_timeout_s: float | None = None) -> list:
    """Run ``fn`` on one rank per device (module docstring); returns the
    ranks' return values in rank order."""
    devices = [str(d) for d in devices]
    world = len(devices)
    if world < 1 or world % pods:
        raise ValueError(f"{world} ranks cannot form {pods} pods")
    backend = backend or backend_for(devices)
    print(f"[launch] {world} ranks on {devices}, backend {backend}"
          + (f", {pods} pods" if pods > 1 else ""), flush=True)
    _build_kernels(devices)
    workdir = tempfile.mkdtemp(prefix="fp_launch_")
    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(target=_rank_main, args=(r, fn, tuple(args), dict(kwargs or {}), devices,
                                             backend, workdir, pods, timeout_s))
        for r in range(world)
    ]
    deadline = None if join_timeout_s is None else time.monotonic() + join_timeout_s
    try:
        for p in procs:
            p.start()
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed:
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {join_timeout_s} s: "
                                   f"{[r for r, p in enumerate(procs) if p.is_alive()]}")
            time.sleep(0.05)
        _stop(procs)
        # The rank that raised first (its traceback written first) in the
        # report: the others may have failed only because it left.
        errs = {r: os.path.join(workdir, f"rank{r}.err") for r, p in enumerate(procs)
                if p.exitcode != 0}
        if errs:
            r = min(errs, key=lambda k: (not os.path.exists(errs[k]),
                                         os.path.exists(errs[k]) and os.stat(errs[k]).st_mtime_ns))
            detail = open(errs[r]).read() if os.path.exists(errs[r]) else "(no traceback)"
            raise RuntimeError(f"rank {r} of {world} failed (exit code {procs[r].exitcode}):\n"
                               f"{detail}")
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        _stop(procs)
        shutil.rmtree(workdir, ignore_errors=True)
