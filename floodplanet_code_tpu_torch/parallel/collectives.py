"""The collectives the data-parallel steps use, over a process group.

``all_reduce`` (sum), ``broadcast`` and ``barrier``: the three that gloo
carries on CUDA tensors as well as NCCL does, so two ranks can share one
card. Each is a no-op in a process that joined no group, so the
single-device path runs the same code. ``group=None`` is the whole world.

``global_with_local_grad`` is how a loss becomes global: its value is the
sum over the group, and only this rank's share is on the autograd graph.
The step all-reduces the gradients once afterwards. The autograd-aware
``torch.distributed.nn.functional.all_reduce`` would all-reduce again in
its backward, and with the step's all-reduce every gradient would come out
multiplied by the world size (the trap ``parallel/shard_step.py:14-21`` of
the JAX package describes for ``check_vma=False``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def active() -> bool:
    """True in a process that joined a ``torch.distributed`` group."""
    return dist.is_available() and dist.is_initialized()


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` in place over ``group``; returns ``t``."""
    if active():
        dist.all_reduce(t, group=group)
    return t


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Overwrite ``t`` in place with global rank ``src``'s; returns ``t``."""
    if active():
        dist.broadcast(t, src, group=group)
    return t


def barrier(group=None) -> None:
    if active():
        dist.barrier(group=group)


def global_with_local_grad(local: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``local`` over ``group`` as a value, with the gradient of
    ``local`` alone: ``total + (local - local.detach())``. The value is the
    all-reduced sum exactly (the added term is 0), and the backward reaches
    only this rank's ``local``."""
    if not active():
        return local
    total = all_reduce(local.detach().clone(), group)
    return total + (local - local.detach())
