"""The halo exchange of spatial partitioning (``tpu.spatial_shards > 1``).

The JAX package leaves it to GSPMD, which derives it from the convolutions
of an activation whose height is sharded over the mesh's ``space`` axis
(``floodplanet_code_tpu/parallel/mesh.py:27-46``). Here it is written out:
each rank of a space group holds one block of image rows of an NCHW
activation, in row order (the group's rank is the block's index), and a 3x3
conv or a 2x bilinear upsample of its rows reads one row of each
neighbour's block.

``exchange_rows(x, group, k)`` returns ``(top, bottom)``: the ``k`` rows
above this block (the last rows of the block before it) and the ``k`` rows
below it (the first rows of the block after it), or None where the block
meets the image edge. It is differentiable: the backward sends the
gradient of the received rows back to their owners, which add it into
their edge rows.

Both directions are ONE all-reduce (sum) over the group of a zeroed
``[sp, 2, B, k, W, C]`` buffer in which each rank fills its own slot; a
rank reads its neighbours' slots. It sends O(sp) rows where point-to-point
sends would send O(1), but it is the one collective that gloo carries on
CUDA tensors (two ranks sharing a card), gloo on the CPU and NCCL between
cards alike (``parallel/collectives.py``).

``apply_on_rows(fn, x, group)`` runs a SAME-padded 3x3 op on a block: the
exchanged rows are joined above and below it, ``fn`` runs on the extended
block (its zero padding then applies only at the image edge, where no row
was joined), and the output rows of the joined rows are dropped.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from floodplanet_code_tpu_torch.parallel import collectives


def position(group) -> tuple[int, int]:
    """(this rank's block index, the number of blocks) in ``group``."""
    return dist.get_rank(group), dist.get_world_size(group)


class _ExchangeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, k):
        s, n = position(group)
        ctx.group, ctx.k, ctx.shape = group, k, x.shape
        # NHWC slots: a slot's rows are channels_last views of the buffer.
        buf = x.new_zeros((n, 2, x.shape[0], k, x.shape[3], x.shape[1]))
        buf[s, 0] = x[:, :, :k].permute(0, 2, 3, 1)
        buf[s, 1] = x[:, :, -k:].permute(0, 2, 3, 1)
        collectives.all_reduce(buf, group)
        # At an image edge the slot read is a stand-in that exchange_rows drops.
        top, bottom = buf[max(s - 1, 0), 1], buf[min(s + 1, n - 1), 0]
        return top.permute(0, 3, 1, 2), bottom.permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, dtop, dbottom):
        group, k = ctx.group, ctx.k
        s, n = position(group)
        b, c, _, w = dtop.shape
        buf = dtop.new_zeros((n, 2, b, k, w, c))
        if s > 0:
            buf[s - 1, 1] = dtop.permute(0, 2, 3, 1)
        if s < n - 1:
            buf[s + 1, 0] = dbottom.permute(0, 2, 3, 1)
        collectives.all_reduce(buf, group)
        # The neighbours' gradients of this block's edge rows (both land on
        # one row of a one-row block).
        dx = torch.zeros(ctx.shape, dtype=dtop.dtype, device=dtop.device).contiguous(
            memory_format=torch.channels_last)
        dx[:, :, :k] += buf[s, 0].permute(0, 3, 1, 2)
        dx[:, :, -k:] += buf[s, 1].permute(0, 3, 1, 2)
        return dx, None, None


def exchange_rows(x: torch.Tensor, group, k: int = 1):
    """``(top, bottom)``: the ``k`` rows of the blocks above and below
    ``x``'s in ``group`` (None at the image's top or bottom edge),
    channels_last [B, C, k, W]. Differentiable (module docstring)."""
    if x.shape[2] < k:
        raise ValueError(f"a block of {x.shape[2]} rows cannot lend {k} rows")
    s, n = position(group)
    top, bottom = _ExchangeRows.apply(x, group, k)
    return (top if s > 0 else None), (bottom if s < n - 1 else None)


def apply_on_rows(fn, x: torch.Tensor, group) -> torch.Tensor:
    """``fn`` (a 3x3 op with SAME padding) on this rank's block of a
    height-sharded ``x``: the output rows of the whole image's ``fn`` that
    belong to this block. ``group`` None: ``fn(x)``."""
    if group is None:
        return fn(x)
    top, bottom = exchange_rows(x, group)
    ext = torch.cat([t for t in (top, x, bottom) if t is not None], dim=2)
    out = fn(ext.contiguous(memory_format=torch.channels_last))
    return out[:, :, int(top is not None):out.shape[2] - int(bottom is not None)]
