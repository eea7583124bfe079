"""The contributor table of the fused tile blend (the port's copy of
``mdu_tpu.ops.pallas.fused_blend.build_contributor_table``): for each canvas
block of ``block_h`` x ``block_w``, in row-major block order, the indices of
the tiles that overlap it, in bbox order, and each tile's origin relative to
the block's origin; padded with -1."""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .bbox import BBox


def build_contributor_table(h: int, w: int, bboxes: Sequence[BBox], block_h: int,
                            block_w: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """(idx [nblocks, k_max] int32, offs [nblocks, k_max, 2] int32 (dy, dx),
    k_max) for an h x w canvas."""
    nby = -(-h // block_h)
    nbx = -(-w // block_w)
    table = []
    for by in range(nby):
        for bx in range(nbx):
            y0, x0 = by * block_h, bx * block_w
            y1, x1 = min(y0 + block_h, h), min(x0 + block_w, w)
            entries = []
            for t, b in enumerate(bboxes):
                if b.x < x1 and b.x + b.w > x0 and b.y < y1 and b.y + b.h > y0:
                    entries.append((t, b.y - y0, b.x - x0))
            table.append(entries)
    k_max = max(len(e) for e in table)
    idx = np.full((len(table), k_max), -1, np.int32)
    offs = np.zeros((len(table), k_max, 2), np.int32)
    for i, entries in enumerate(table):
        for k, (t, dy, dx) in enumerate(entries):
            idx[i, k] = t
            offs[i, k] = (dy, dx)
    return idx, offs, k_max
