"""Overlapped tile grids (ref tile_utils/utils.py:151-177).

Pure Python and numpy: the grid depends only on the canvas and tile sizes.
"""
from __future__ import annotations

import math
from typing import List, Tuple, Union

import numpy as np

from .bbox import BBox


def clamp_overlap(tile_w: int, tile_h: int, overlap: int) -> int:
    """Overlap must leave a positive stride (ref abstractdiffusion.py:178)."""
    return max(0, min(overlap, min(tile_w, tile_h) - 4))


def grid_dims(w: int, h: int, tile_w: int, tile_h: int, overlap: int) -> Tuple[int, int]:
    """Number of (cols, rows) of the overlapped grid."""
    cols = math.ceil((w - overlap) / (tile_w - overlap))
    rows = math.ceil((h - overlap) / (tile_h - overlap))
    return max(cols, 1), max(rows, 1)


def splitable(w: int, h: int, tile_w: int, tile_h: int, overlap: int = 16) -> bool:
    """True when tiling is worthwhile; sizes are latent sizes."""
    overlap = min(overlap, min(tile_w, tile_h) - 4)
    cols, rows = grid_dims(w, h, tile_w, tile_h, overlap)
    return cols > 1 or rows > 1


def split_grid(w: int, h: int, tile_w: int, tile_h: int, overlap: int = 16) -> List[BBox]:
    """Uniform overlapped grid with even fractional stride, edge-clamped.

    Origins are ``min(int(col * dx), w - tile_w)``; the last row and column
    are pinned to the canvas edge so float truncation never leaves the final
    pixel row or column unpainted.
    """
    tile_w = min(tile_w, w)
    tile_h = min(tile_h, h)
    cols, rows = grid_dims(w, h, tile_w, tile_h, overlap)
    dx = (w - tile_w) / (cols - 1) if cols > 1 else 0.0
    dy = (h - tile_h) / (rows - 1) if rows > 1 else 0.0

    bboxes: List[BBox] = []
    for row in range(rows):
        y = min(int(row * dy), h - tile_h)
        if row == rows - 1:
            y = h - tile_h
        for col in range(cols):
            x = min(int(col * dx), w - tile_w)
            if col == cols - 1:
                x = w - tile_w
            bboxes.append(BBox(x, y, tile_w, tile_h))
    return bboxes


def paint_count(w: int, h: int, bboxes: List[BBox],
                init_weight: Union[np.ndarray, float] = 1.0) -> np.ndarray:
    """Per-pixel accumulated weight canvas [1, 1, H, W] (float32, numpy)."""
    weight = np.zeros((1, 1, h, w), dtype=np.float32)
    for b in bboxes:
        weight[:, :, b.y:b.y + b.h, b.x:b.x + b.w] += init_weight
    return weight


def batch_bboxes(bboxes: List[BBox], tile_bs: int) -> List[List[BBox]]:
    """Split bboxes into near-equal batches: ``nb = ceil(n/bs); bs' = ceil(n/nb)``."""
    n = len(bboxes)
    if n == 0:
        return []
    num_batches = math.ceil(n / tile_bs)
    bs = math.ceil(n / num_batches)
    return [bboxes[i * bs:(i + 1) * bs] for i in range(num_batches)]
