"""The device mesh as a process-group layout: the port of
``floodplanet_code_tpu/parallel/mesh.py``.

In the JAX package a mesh is a grid of devices with named axes, and
``NamedSharding(mesh, P(batch_axes))`` gives device k of the row-major grid
the k-th block of a global batch. Here each device is one rank, ranks are
laid out row-major over the axes (rank = pod * data + d on the hybrid
mesh), and ``local_rows(mesh, batch)`` is rank k's block: the same
example -> device assignment. A ``Mesh`` holds one process group per axis
(``dist.new_group``, made once per layout), the group of every batch axis
together and the group of every axis: gradients, BatchNorm statistics,
losses and confusion matrices are summed over the last (``all_group``),
which is the batch group on a mesh without a ``space`` axis.

``make_mesh(n)`` raises when fewer (or more) than ``n`` ranks are in the
world, where ``jax.devices()[:n]`` would quietly take what there is. A
process that joined no group is a world of one rank.

``make_mesh_2d`` builds the data x space layout of spatial partitioning
(``tpu.spatial_shards``): rank (d, s) holds the rows of batch shard d and
the block of image rows s (``local_height``: the JAX batch sharding's
block; below it the blocks of ``parallel/rows.py``); the ranks of one data
row exchange their edge rows (``parallel/halo.py``, over ``space_group``).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from floodplanet_code_tpu_torch.parallel import collectives
from floodplanet_code_tpu_torch.parallel.rows import row_layout

# (axis names, axis sizes) -> {axis or "batch": group}: dist.new_group must
# be called by every rank in the same order, so each layout makes its
# groups once.
_GROUPS: dict = {}


@dataclass
class Mesh:
    """Named axes over the ranks, row-major; ``rank`` is this process's.

    ``groups`` maps each axis to the group of the ranks that differ only
    along it, ``"batch"`` to the group of every batch axis (all but
    ``space``) and ``"all"`` to the group of every axis. A group that
    spans the whole world is the default group (``dist.group.WORLD``);
    every group is None in a process that joined none (one rank), and the
    ops then sum nothing.
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
        for name, free in ([(a, (a,)) for a in axis_names]
                           + [("batch", batch), ("all", tuple(axis_names))]):
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
    """data x space layout (the JAX ``make_mesh_2d``): ``dp`` batch shards,
    each split over ``sp`` ranks by image rows (``local_height``)."""
    return _build(tuple(axis_names), (int(dp), int(sp)))


def make_hybrid_mesh(n_pods: int, dp_per_pod: int, axis_names: tuple = ("pod", "data"),
                     sp: int = 1) -> Mesh:
    """pod x data mesh: the slow axis across nodes, the fast one within a
    node. The batch shards over both, as on the flat mesh, so per-rank
    loading does not change; the pod group serves the pod-sharded scene
    cache (data/device_cache.py). ``sp`` > 1 adds a ``space`` axis last
    (pod x data x space): the blocks of one example's rows on one node."""
    if sp > 1:
        return _build(tuple(axis_names) + ("space",), (int(n_pods), int(dp_per_pod), int(sp)))
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
    """The group over every batch axis: the ranks that hold the same
    image rows of different examples."""
    return mesh.groups.get("batch")


def all_group(mesh: Mesh):
    """The group over every axis: gradients, BatchNorm statistics, losses,
    confusion matrices and NaN flags are summed over it. Without a
    ``space`` axis it is the batch group."""
    return mesh.groups.get("all")


def n_space_shards(mesh: Mesh) -> int:
    """Number of blocks the image rows split into (1: no spatial
    partitioning)."""
    return mesh.shape.get("space", 1)


def space_group(mesh: Mesh):
    """The group of the ranks that hold one batch shard's blocks of rows,
    in row order (``parallel/halo.py`` exchanges edge rows over it); None
    without spatial partitioning."""
    return mesh.groups.get("space") if n_space_shards(mesh) > 1 else None


def batch_shard(mesh: Mesh) -> tuple[int, int]:
    """(this rank's batch-shard index, the number of batch shards): its
    index over the batch axes, row-major. The ``sp`` ranks of one data row
    share it."""
    coords = mesh.coords
    index = 0
    for a in batch_axes(mesh):
        index = index * mesh.shape[a] + coords[a]
    return index, n_batch_shards(mesh)


def local_rows(mesh: Mesh, global_batch: int) -> slice:
    """The rows of a global batch this rank holds: the block of its batch
    shard (the JAX ``batch_sharding``'s assignment)."""
    index, n = batch_shard(mesh)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} batch shards")
    per = global_batch // n
    return slice(index * per, (index + 1) * per)


def local_height(mesh: Mesh, height: int) -> slice:
    """This rank's block of ``height`` image rows: the JAX batch sharding's,
    ``height // sp`` rows from ``space_index * height // sp`` (all of them
    without a ``space`` axis). Raises ``ValueError`` for a layout that
    ``rows.row_layout`` refuses: a height that sp does not divide, or a
    block empty at some UNet level."""
    sp = n_space_shards(mesh)
    if sp == 1:
        return slice(0, height)
    return row_layout(height, sp).block(0, mesh.coords["space"])


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
    dtype over the whole world (the data and the space ranks); returns
    ``state``. The JAX
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
            collectives.broadcast(flat, 0)
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
