"""Conditioning dicts and per-tile cond slicing (counterpart of
``mdu_tpu/tiling/conds.py``).

A cond is a dict whose leaves are tensors, except ``control``, a list of
ControlNet hint tensors:

  cond = {
    'crossattn': [B, L, D]        text embeddings
    'concat':    [B, C, h, w]     image conditioning
    'vector':    [B, D]           SDXL pooled + size vector
    'time_ids':  [B, 6]           SDXL size micro-conditions (default ones)
    'control':   [[B, C, H, W]]   ControlNet hints, pixel space
    'guidance':  [B, 4, h, w]     StableSR guidance latent
    'adm':       [B, D]           unCLIP image embedding
  }

For a batch of K tiles (tile-major), a leaf whose spatial size is the latent
canvas is cut to each bbox, one at the pixel canvas is cut to bbox * 8, and
any other leaf is repeated K times; a list of leaves is cut leaf by leaf, as
``jax.tree.map`` walks it in the JAX package.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..ops.resize import resize_nchw
from ..utils.bbox import BBox

Cond = Dict[str, Any]
LATENT_TO_PIXEL = 8


def map_leaves(fn, *conds):
    """``fn`` over the leaves of one or more conds of the same structure,
    into the lists of hints too."""
    first = conds[0]
    if isinstance(first, (list, tuple)):
        return [map_leaves(fn, *parts) for parts in zip(*conds)]
    if isinstance(first, dict):
        return {k: map_leaves(fn, *(c[k] for c in conds)) for k in first}
    return fn(*conds)


def quantize_control_hints(cond: Optional[Cond],
                           min_pixels: Optional[int] = None) -> Optional[Cond]:
    """Store large ControlNet hint canvases as uint8 on the device: hints
    come from uint8 images, so a uint8 canvas in [0, 1] * 255 is lossless at
    a quarter of fp32's bytes, and each tile dequantises its cut
    (``dequantize_hint``). Applies to 'control' leaves whose pixel area is
    at least ``min_pixels`` (default 2048^2; ``MDU_HINT_UINT8=1`` quantises
    every hint, ``=0`` none); values are clipped to [0, 1]."""
    if cond is None:
        return None
    mode = os.environ.get("MDU_HINT_UINT8", "auto")
    if mode == "0":
        return cond
    if min_pixels is None:
        min_pixels = 0 if mode == "1" else 2048 * 2048

    def q(h):
        if h.dtype == torch.uint8 or h.shape[-2] * h.shape[-1] < min_pixels:
            return h
        return torch.round(torch.clamp(h.float(), 0.0, 1.0) * 255.0).to(torch.uint8)

    if isinstance(cond, dict) and cond.get("control"):
        return {**cond, "control": [q(h) for h in cond["control"]]}
    return cond


def dequantize_hint(h: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Undo ``quantize_control_hints`` where the hint is consumed."""
    if h.dtype == torch.uint8:
        return h.to(dtype) / 255.0
    return h.to(dtype)


def fit_cond_canvases(cond: Optional[Cond], latent_hw: Tuple[int, int]) -> Optional[Cond]:
    """Resize 'control' hints to the pixel canvas (h * 8, w * 8) and a
    'guidance' latent to the latent canvas (h, w), bilinearly; a leaf
    already at its canvas size passes untouched. Without this a hint of
    another size would be repeated per tile instead of cut."""
    if cond is None:
        return None
    h, w = latent_hw
    f = LATENT_TO_PIXEL

    def fit(leaf, target):
        if leaf.dim() != 4 or tuple(leaf.shape[2:]) == target:
            return leaf
        x = dequantize_hint(leaf) if leaf.dtype == torch.uint8 else leaf
        return resize_nchw(x, target, "linear")

    out = cond
    if cond.get("control"):
        out = {**out, "control": [fit(x, (h * f, w * f)) for x in cond["control"]]}
    if cond.get("guidance") is not None:
        out = {**out, "guidance": fit(cond["guidance"], (h, w))}
    return out


def _slice_leaf(leaf, bboxes: Sequence[BBox], latent_hw: Tuple[int, int]):
    h, w = latent_hw
    if leaf.dim() == 4 and tuple(leaf.shape[2:]) == (h, w):
        return torch.cat([leaf[:, :, b.y:b.y + b.h, b.x:b.x + b.w] for b in bboxes])
    f = LATENT_TO_PIXEL
    if leaf.dim() == 4 and tuple(leaf.shape[2:]) == (h * f, w * f):
        return torch.cat([leaf[:, :, b.y * f:(b.y + b.h) * f, b.x * f:(b.x + b.w) * f]
                          for b in bboxes])
    return torch.cat([leaf] * len(bboxes))


def is_and(cond) -> bool:
    """An AND cond: ``{"__and__": [cond, ...], "__weights__": (w, ...)}``."""
    return isinstance(cond, dict) and "__and__" in cond


def tile_cond(cond: Optional[Cond], bboxes: Sequence[BBox],
              latent_hw: Tuple[int, int]) -> Optional[Cond]:
    """The cond dict of a tile batch (tile-major on the batch axis); an AND
    cond branch by branch, its weights kept."""
    if cond is None:
        return None
    if is_and(cond):
        return {"__and__": [tile_cond(p, bboxes, latent_hw) for p in cond["__and__"]],
                "__weights__": cond["__weights__"]}
    return map_leaves(lambda leaf: _slice_leaf(leaf, bboxes, latent_hw), cond)


def concat_conds(a: Cond, b: Cond) -> Cond:
    """Two conds batched; a ``guidance`` leaf must be on both or on neither
    (the JAX package's ``tree.map`` needs the same leaves on both sides)."""
    if ("guidance" in a) != ("guidance" in b):
        raise ValueError("a 'guidance' leaf on only one of the conds batched together: "
                         "StableSR guidance needs it on the cond and the uncond")
    return map_leaves(lambda x, y: torch.cat([x, y]), a, b)
