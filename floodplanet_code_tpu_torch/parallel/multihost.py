"""More than one process: the port of ``floodplanet_code_tpu/parallel/multihost.py``.

The JAX package runs one process per host, each driving that host's chips.
Here one process drives one device, so a process is a rank and "hosts" are
ranks throughout: each rank loads only its batch shard's rows of every
global batch (``BatchLoader(process_shard=process_shard(mesh))``: its
rank and the world, or under spatial partitioning its data row, whose
ranks load the same rows; the loader partitions the same seeded epoch
order on every rank, so batch counts and example placement agree with no
coordination traffic), and only rank 0 writes the experiment directory,
checkpoints and TensorBoard.

A process joins a group from, in order:
- the config's ``tpu.multihost`` block: ``coordinator_address``
  (``host:port`` of rank 0), ``num_processes``, ``process_id`` (all three);
- the environment a launcher such as ``torchrun`` sets: ``MASTER_ADDR``,
  ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` (and ``LOCAL_RANK``, the card);
- ``parallel/launch.py``, which spawns the ranks and joins them itself.

The backend is NCCL when the rank runs on a card and gloo on the CPU.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from floodplanet_code_tpu_torch.parallel import collectives
from floodplanet_code_tpu_torch.parallel.mesh import batch_shard

# How long a collective may wait for the other ranks before it raises:
# a rank that died or diverged fails the others instead of hanging them.
DEFAULT_TIMEOUT_S = 600


def rank_device(device="cuda") -> torch.device:
    """This rank's device: a card without an index becomes
    ``cuda:LOCAL_RANK`` (else ``cuda:rank % cards``) in a group; anything
    else is returned as it is."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None or not collectives.active():
        return device
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else dist.get_rank() % torch.cuda.device_count()
    return torch.device("cuda", index)


def _backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_from_env_or_config(cfg=None, device="cuda",
                                  timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join a ``torch.distributed`` group when a ``tpu.multihost`` block or
    a launcher's environment asks for one (module docstring). Returns True
    when this call joined one; False when already in a group or when
    nothing asks (one process)."""
    if collectives.active():
        return False
    block = cfg.select("tpu.multihost") if cfg is not None else None
    timeout = datetime.timedelta(seconds=timeout_s)
    if block:
        coord = block.get("coordinator_address")
        nproc = block.get("num_processes")
        pid = block.get("process_id")
        if coord and nproc is not None and pid is not None:
            dist.init_process_group(_backend(device), init_method=f"tcp://{coord}",
                                    world_size=int(nproc), rank=int(pid), timeout=timeout)
            return True
    env = os.environ
    if env.get("MASTER_ADDR") and env.get("WORLD_SIZE") and env.get("RANK"):
        dist.init_process_group(_backend(device), init_method="env://", timeout=timeout)
        return True
    return False


def process_index() -> int:
    return dist.get_rank() if collectives.active() else 0


def process_count() -> int:
    return dist.get_world_size() if collectives.active() else 1


def is_coordinator() -> bool:
    """True on the process allowed to write checkpoints, TensorBoard and
    the experiment directory."""
    return process_index() == 0


def process_shard(mesh) -> tuple[int, int] | None:
    """(this process's batch shard, the number of batch shards) of
    ``mesh`` for ``BatchLoader``, or None for one shard: the ``sp`` ranks
    of one data row load the same rows (``mesh.batch_shard``)."""
    index, n = batch_shard(mesh)
    return None if n <= 1 else (index, n)


def sync(name: str = "sync") -> None:
    """Barrier across all processes (a no-op for one). ``fit_model`` calls
    it at every epoch end, so no rank reads the checkpoint index before
    rank 0 has written it, or exits before rank 0's last write. ``name``
    labels the call site, as the JAX ``sync_global_devices`` name does."""
    del name
    collectives.barrier()


def local_batch_size(global_batch_size: int) -> int:
    """This process's share of the global batch (must divide evenly)."""
    n = process_count()
    if global_batch_size % n != 0:
        raise ValueError(
            f"global batch size {global_batch_size} not divisible by {n} processes"
        )
    return global_batch_size // n
