"""Per-tile conditioning (counterpart of ``tile_cond`` / ``concat_conds`` in
``mdu_tpu/tiling/conds.py``).

A cond is a dict of tensors. For a batch of K tiles (tile-major), a leaf
whose spatial size is the latent canvas is cut to each bbox, one at the
pixel canvas is cut to bbox * 8, and any other leaf is repeated K times.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..utils.bbox import BBox

Cond = Dict[str, torch.Tensor]
LATENT_TO_PIXEL = 8


def _slice_leaf(leaf, bboxes: Sequence[BBox], latent_hw: Tuple[int, int]):
    h, w = latent_hw
    if leaf.dim() == 4 and tuple(leaf.shape[2:]) == (h, w):
        return torch.cat([leaf[:, :, b.y:b.y + b.h, b.x:b.x + b.w] for b in bboxes])
    f = LATENT_TO_PIXEL
    if leaf.dim() == 4 and tuple(leaf.shape[2:]) == (h * f, w * f):
        return torch.cat([leaf[:, :, b.y * f:(b.y + b.h) * f, b.x * f:(b.x + b.w) * f]
                          for b in bboxes])
    return torch.cat([leaf] * len(bboxes))


def tile_cond(cond: Optional[Cond], bboxes: Sequence[BBox],
              latent_hw: Tuple[int, int]) -> Optional[Cond]:
    """The cond dict of a tile batch (tile-major on the batch axis)."""
    if cond is None:
        return None
    return {k: _slice_leaf(v, bboxes, latent_hw) for k, v in cond.items()}


def concat_conds(a: Cond, b: Cond) -> Cond:
    return {k: torch.cat([a[k], b[k]]) for k in a}
