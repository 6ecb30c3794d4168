"""The device mesh as a process-group layout: the port of
``floodplanet_code_tpu/parallel/mesh.py``.

In the JAX package a mesh is a grid of devices with named axes, and
``NamedSharding(mesh, P(batch_axes))`` gives device k of the row-major grid
the k-th block of a global batch. Here each device is one rank, ranks are
laid out row-major over the axes (rank = pod * data + d on the hybrid
mesh), and ``local_rows(mesh, batch)`` is rank k's block: the same
example -> device assignment. A ``Mesh`` holds one process group per axis
(``dist.new_group``, made once per layout) and the group of every batch
axis together, over which gradients, BatchNorm statistics, losses and
confusion matrices are summed.

``make_mesh(n)`` raises when fewer (or more) than ``n`` ranks are in the
world, where ``jax.devices()[:n]`` would quietly take what there is. A
process that joined no group is a world of one rank.

``make_mesh_2d`` builds the data x space layout; the steps raise for a
``space`` axis above 1: spatial partitioning is not ported yet (ROADMAP.md
Queue 1, PR 9).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from floodplanet_code_tpu_torch.parallel import collectives

# (axis names, axis sizes) -> {axis or "batch": group}: dist.new_group must
# be called by every rank in the same order, so each layout makes its
# groups once.
_GROUPS: dict = {}


@dataclass
class Mesh:
    """Named axes over the ranks, row-major; ``rank`` is this process's.

    ``groups`` maps each axis to the group of the ranks that differ only
    along it, and ``"batch"`` to the group of every batch axis (all but
    ``space``). A group that spans the whole world is the default group
    (``dist.group.WORLD``); every group is None in a process that joined
    none (one rank), and the ops then sum nothing.
    """

    axis_names: tuple
    sizes: tuple
    rank: int = 0
    groups: dict = field(default_factory=dict)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def coords(self) -> dict:
        """This rank's index along each axis."""
        out, rest = {}, self.rank
        for name, n in reversed(list(zip(self.axis_names, self.sizes))):
            out[name] = rest % n
            rest //= n
        return {name: out[name] for name in self.axis_names}


def world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) outside a group."""
    if collectives.active():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _ranks_along(axis_names, sizes, free: tuple) -> list[list[int]]:
    """The rank lists that vary along the axes in ``free`` with the other
    coordinates fixed, for every setting of those, in rank order."""
    lines: dict = {}
    for rank in range(math.prod(sizes)):
        m = Mesh(tuple(axis_names), tuple(sizes), rank)
        key = tuple(v for k, v in m.coords.items() if k not in free)
        lines.setdefault(key, []).append(rank)
    return list(lines.values())


def _build(axis_names: tuple, sizes: tuple) -> Mesh:
    rank, size = world()
    if math.prod(sizes) != size:
        raise ValueError(
            f"a mesh {dict(zip(axis_names, sizes))} needs {math.prod(sizes)} devices, one "
            f"per rank; {size} rank(s) are in this process group"
        )
    key = (axis_names, sizes, id(dist.GroupMember.WORLD))  # a new world, new groups
    if key not in _GROUPS:
        groups = {}
        batch = tuple(a for a in axis_names if a != "space")
        for name, free in [(a, (a,)) for a in axis_names] + [("batch", batch)]:
            lines = _ranks_along(axis_names, sizes, free)
            if not collectives.active():
                groups[name] = None  # one rank: nothing to sum over
                continue
            if len(lines) == 1:
                groups[name] = dist.group.WORLD
                continue
            # Every rank creates every group, in the same order.
            made = [dist.new_group(line) for line in lines]
            groups[name] = next(g for g, line in zip(made, lines) if rank in line)
        _GROUPS[key] = groups
    return Mesh(axis_names, sizes, rank, _GROUPS[key])


def make_mesh(n_devices: int | None = None, axis_name: str = "data") -> Mesh:
    """1-D data mesh over the ranks of the world (``n_devices`` None: all
    of them). Raises unless the world has exactly ``n_devices`` ranks."""
    _, size = world()
    return _build((axis_name,), (size if n_devices is None else int(n_devices),))


def make_mesh_2d(dp: int, sp: int, axis_names: tuple = ("data", "space")) -> Mesh:
    """data x space layout (the JAX ``make_mesh_2d``). The steps refuse a
    ``space`` axis above 1 (``check_data_mesh``)."""
    return _build(tuple(axis_names), (int(dp), int(sp)))


def make_hybrid_mesh(n_pods: int, dp_per_pod: int, axis_names: tuple = ("pod", "data")) -> Mesh:
    """pod x data mesh: the slow axis across nodes, the fast one within a
    node. The batch shards over both, as on the flat mesh, so per-rank
    loading does not change; the pod group serves the pod-sharded scene
    cache (data/device_cache.py)."""
    return _build(tuple(axis_names), (int(n_pods), int(dp_per_pod)))


def detect_n_pods() -> int:
    """Number of nodes: the world size over the ranks per node
    (``LOCAL_WORLD_SIZE``, which torchrun and ``parallel/launch.py`` set);
    1 when it is not set."""
    _, size = world()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", size) or size)
    return max(1, size // max(1, local))


def batch_axes(mesh: Mesh) -> tuple:
    """Every mesh axis the batch dimension shards over (all but 'space')."""
    return tuple(a for a in mesh.axis_names if a != "space")


def n_batch_shards(mesh: Mesh) -> int:
    """Number of ways the global batch is split (product of batch axes)."""
    return math.prod(mesh.shape[a] for a in batch_axes(mesh))


def batch_group(mesh: Mesh):
    """The group over every batch axis: gradients, BatchNorm statistics,
    losses and confusion matrices are summed over it."""
    return mesh.groups.get("batch")


def check_data_mesh(mesh: Mesh) -> None:
    """Raise for a mesh the data-parallel steps cannot run."""
    if mesh.shape.get("space", 1) > 1:
        raise NotImplementedError(
            f"a mesh with space={mesh.shape['space']}: spatial partitioning is not ported "
            "yet (ROADMAP.md Queue 1, PR 9)"
        )


def local_rows(mesh: Mesh, global_batch: int) -> slice:
    """The rows of a global batch this rank holds: the block of its index
    over the batch axes, row-major (the JAX ``batch_sharding``'s
    assignment)."""
    n = n_batch_shards(mesh)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} batch shards")
    coords = mesh.coords
    index = 0
    for a in batch_axes(mesh):
        index = index * mesh.shape[a] + coords[a]
    per = global_batch // n
    return slice(index * per, (index + 1) * per)


def _state_tensors(state) -> list[torch.Tensor]:
    """What defines a train state's function and its next update: the
    model's parameters and buffers, the EMA, and the optimizer's tensors
    on the model's device, in a fixed order."""
    model = state.model
    device = next(model.parameters()).device
    out = [p.data for p in model.parameters()] + list(model.buffers())
    if state.ema_params is not None:
        out += [state.ema_params[n] for n in sorted(state.ema_params)]
    for p in model.parameters():
        for key in sorted(state.optimizer.state.get(p, {})):
            value = state.optimizer.state[p][key]
            if isinstance(value, torch.Tensor) and value.device == device:
                out.append(value)
    return out


def replicate_state(state, mesh: Mesh):
    """Give every rank rank 0's train state (in place), one broadcast per
    dtype over the batch group; returns ``state``. The JAX
    ``replicate_state`` places one pytree on every device; here every rank
    built its own, and this makes them the same."""
    if mesh.size == 1 or not collectives.active():
        return state
    by_dtype: dict = {}
    for t in _state_tensors(state):
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for tensors in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in tensors])
            collectives.broadcast(flat, 0, batch_group(mesh))
            offset = 0
            for t in tensors:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
    return state


def device_list(n: int, device) -> list[torch.device]:
    """``n`` devices of ``device``'s type for one process's replicas or a
    launcher's ranks: ``cuda:0`` .. ``cuda:n-1`` (raises when fewer cards
    are present), or ``n`` times the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n
    present = torch.cuda.device_count()
    if n > present:
        raise ValueError(f"{n} CUDA devices requested, {present} present")
    return [torch.device("cuda", i) for i in range(n)]
