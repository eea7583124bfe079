"""Tile gather / scatter-accumulate fusion (counterpart of
``mdu_tpu/ops/fusion.py``). Accumulation follows the bbox order, so the
fused canvas is deterministic."""
from __future__ import annotations

from typing import Sequence

import torch

from ..utils.bbox import BBox


def gather_tiles(x, bboxes: Sequence[BBox]):
    """Same-size tiles of an NCHW canvas -> [T, B, C, th, tw]."""
    return torch.stack([x[:, :, b.y:b.y + b.h, b.x:b.x + b.w] for b in bboxes])


def scatter_add_tiles(canvas, tiles, bboxes: Sequence[BBox]):
    """Add stacked tiles [T, B, C, th, tw] into a copy of an NCHW canvas."""
    canvas = canvas.clone()
    for t, b in zip(tiles, bboxes):
        canvas[:, :, b.y:b.y + b.h, b.x:b.x + b.w] += t
    return canvas


def weighted_average(canvas, weights):
    """MultiDiffusion normalise: ``where(w > 1, buf / w, buf)``."""
    return torch.where(weights > 1, canvas / weights, canvas)
