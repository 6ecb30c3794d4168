"""The row layout of spatial partitioning: each rank's global image rows at
every UNet level (``tpu.spatial_shards`` = sp > 1).

Level 0 is the JAX batch sharding's: sp blocks of H / sp rows each
(``devices_indices_map`` of ``P(batch_axes, "space")``), so each rank keeps
the rows the JAX device at the same place of the mesh holds. A height that
sp does not divide raises, as the JAX package's batch placement does.

Each 2x2 max pool (floor) makes output row i from input rows 2i and 2i + 1,
and the rank that holds row 2i owns row i: a block [a, b) at level l gives
[ceil(a / 2), ceil(b / 2)) at level l + 1, cut to the level's height
floor(H_l / 2). A block with an odd end borrows the first row of the block
below it (``Down`` joins it with ``halo.join_rows``); a block with an
odd start skips its first row, whose window the rank above owns; the last
row of an odd level belongs to no window. The 2x upsample and pad-to-match
of the way up produce each rank's rows of the same ranges, so every skip
concatenation meets a block of its own height (``models/unet.py``).

GSPMD pads uneven levels instead and so runs any layout. A block that would
be empty at some level cannot lend the row that a neighbour's conv, pool or
upsample reads, so ``row_layout`` refuses such a layout (``ValueError``
naming the level and the rank): the one height the JAX package takes that
the port does not.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

LEVELS = 5  # the UNet's levels: the input's and four pools'


@dataclass(frozen=True)
class RowLayout:
    """``heights[l]``: the whole image's rows at level l; ``blocks[l][s]``:
    block s's global rows [start, stop) there, in row order."""

    heights: tuple
    blocks: tuple

    def block(self, level: int, s: int) -> slice:
        start, stop = self.blocks[level][s]
        return slice(start, stop)

    def borrows_below(self, level: int, s: int) -> bool:
        """Whether block s's pool out of ``level`` reads the first row of
        the block below it (a window split between the two)."""
        return 2 * self.blocks[level + 1][s][1] > self.blocks[level][s][1]


@functools.lru_cache(maxsize=64)
def row_layout(height: int, sp: int) -> RowLayout:
    """Every block's global rows at every level for ``sp`` blocks of
    ``height`` rows (module docstring). Raises ``ValueError`` when sp does
    not divide the height, or when a block would be empty at some level."""
    height, sp = int(height), int(sp)
    if height % sp:
        raise ValueError(
            f"a height of {height} rows does not split into {sp} equal blocks "
            f"(height % spatial_shards = {height % sp}): the JAX package's batch "
            "sharding refuses it as well")
    per = height // sp
    heights = [height]
    blocks = [tuple((s * per, (s + 1) * per) for s in range(sp))]
    for _ in range(1, LEVELS):
        h = heights[-1] // 2
        blocks.append(tuple((min(-(-a // 2), h), min(-(-b // 2), h)) for a, b in blocks[-1]))
        heights.append(h)
    for level, row in enumerate(blocks):
        for s, (a, b) in enumerate(row):
            if b <= a:
                raise ValueError(
                    f"spatial partitioning of {height} rows over {sp} blocks leaves block "
                    f"{s} without a row at UNet level {level} (level heights {heights}, "
                    f"blocks {[b_ - a_ for a_, b_ in row]}): a block must lend its "
                    "neighbours one row at every level")
    return RowLayout(tuple(heights), tuple(blocks))
