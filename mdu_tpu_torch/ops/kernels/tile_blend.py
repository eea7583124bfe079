"""Fused tile blend: the CUDA kernel ``csrc/tile_blend.cu`` and its plain
PyTorch version.

``fused_tile_blend`` replaces ``mdu_tpu.ops.pallas.fused_blend.fused_tile_blend``:
MultiDiffusion's fusion of T tile outputs [T, C, th, tw] into a canvas
[C, h, w] as a gather. For each canvas block the contributor table
(``BlendTable``, built once per plan on the host) lists the tiles that
overlap it in bbox order; each canvas element is the fp32 sum of their
elements that cover it, in that order, divided where the paint count is > 1
when ``normalize``, cast to the tiles' dtype. The wrapper launches the kernel
for a CUDA tensor and raises on anything it does not take; it runs the plain
version only for a CPU tensor. Each launch adds one to
``LAUNCHES["fused_tile_blend"]``.

``tile_blend_floor`` launches an empty kernel on #5's grid through the same
checks and launch path (counted under ``LAUNCHES["fused_tile_blend_floor"]``):
its device time is the launch floor that #5's own is read against.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import torch

from ...utils.bbox import BBox
from ...utils.blend_table import build_contributor_table
from .launch import launch, ptr, refuse_grad

__all__ = ["BlendTable", "fused_tile_blend", "fused_tile_blend_plain",
           "tile_blend_floor"]

BLOCK_H, BLOCK_W = 16, 32      # canvas block of a table row


class BlendTable:
    """The contributor table of one plan: numpy on the host, copied to a
    device once, at its first use there. ``n_tiles``: the fewest tiles a
    call must give (the largest tile id + 1)."""

    def __init__(self, h: int, w: int, bboxes: Sequence[BBox],
                 block_h: int = BLOCK_H, block_w: int = BLOCK_W):
        self.h, self.w = h, w
        self.block_h, self.block_w = block_h, block_w
        self.nbx = -(-w // block_w)
        self.idx, self.offs, self.k_max = build_contributor_table(
            h, w, bboxes, block_h, block_w)
        self.n_tiles = int(self.idx.max()) + 1
        self._on: Dict[torch.device, tuple] = {}

    def on(self, device: torch.device):
        """(idx, offs) as int32 tensors on ``device``."""
        got = self._on.get(device)
        if got is None:
            got = (torch.as_tensor(self.idx, device=device),
                   torch.as_tensor(self.offs, device=device))
            self._on[device] = got
        return got


def fused_tile_blend_plain(tiles, weights, h: int, w: int, bboxes: Sequence[BBox],
                           normalize: bool = True, table: Optional[BlendTable] = None):
    """The kernel's gather on the CPU: per canvas block, the covering window
    of each contributor tile added in table order, in fp32."""
    table = table if table is not None else BlendTable(h, w, bboxes)
    T, C, th, tw = tiles.shape
    tf = tiles.float()
    out = torch.zeros(C, h, w, dtype=torch.float32, device=tiles.device)
    bh, bw = table.block_h, table.block_w
    for blk in range(table.idx.shape[0]):
        by, bx = divmod(blk, table.nbx)
        y0, x0 = by * bh, bx * bw
        y1, x1 = min(y0 + bh, h), min(x0 + bw, w)
        for t, (dy, dx) in zip(table.idx[blk], table.offs[blk]):
            if t < 0:
                break
            oy, ox = y0 + int(dy), x0 + int(dx)          # the tile's origin
            ya, yb = max(y0, oy), min(y1, oy + th)
            xa, xb = max(x0, ox), min(x1, ox + tw)
            out[:, ya:yb, xa:xb] += tf[int(t), :, ya - oy:yb - oy, xa - ox:xb - ox]
    if normalize:
        wf = weights.float()
        out = torch.where(wf > 1, out / wf, out)
    return out.to(tiles.dtype)


def _launch(name: str, fn_name: str, tiles, weights, h: int, w: int,
            bboxes: Sequence[BBox], normalize: bool, table: Optional[BlendTable]):
    """The wrapper's checks, then ``fn_name`` of the tile blend library on
    (tiles, table, weights, out); counts under ``name``."""
    if (tiles.device.type != "cuda" or tiles.dim() != 4
            or tiles.dtype not in (torch.bfloat16, torch.float32)):
        raise ValueError(f"{name}: needs a CUDA [T, C, th, tw] bf16 or fp32 tensor, "
                         f"got {tiles.dtype} {tuple(tiles.shape)} on {tiles.device}")
    if not tiles.is_contiguous():
        raise ValueError(f"{name}: tiles must be contiguous")
    if (weights.device != tiles.device or weights.dtype != torch.float32
            or tuple(weights.shape) != (h, w) or not weights.is_contiguous()):
        raise ValueError(f"{name}: weights must be contiguous fp32 [{h}, {w}] on "
                         f"{tiles.device}, got {weights.dtype} {tuple(weights.shape)}")
    table = table if table is not None else BlendTable(h, w, bboxes)
    if (table.h, table.w) != (h, w) or table.n_tiles > tiles.shape[0]:
        raise ValueError(f"{name}: the table (a {table.h} x {table.w} canvas, "
                         f"{table.n_tiles} tiles) does not fit {h} x {w} and "
                         f"{tiles.shape[0]} tiles")
    T, C, th, tw = tiles.shape
    idx, offs = table.on(tiles.device)
    out = torch.empty(C, h, w, dtype=tiles.dtype, device=tiles.device)
    launch(name, "tile_blend", fn_name, tiles.device,
           ptr(tiles), ptr(idx), ptr(offs), ptr(weights), ptr(out),
           *(ctypes.c_int(v) for v in (C, h, w, th, tw, table.block_h, table.block_w,
                                       table.nbx, table.k_max, int(bool(normalize)),
                                       int(tiles.dtype == torch.bfloat16))))
    return out


def fused_tile_blend(tiles, weights, h: int, w: int, bboxes: Sequence[BBox],
                     normalize: bool = True, table: Optional[BlendTable] = None):
    """Tile fusion in one gather: tiles [T, C, th, tw], paint counts
    ``weights`` [h, w] -> canvas [C, h, w]. ``normalize=False`` keeps the raw
    sum (the caller divides). ``table``: the plan's ``BlendTable`` (built from
    ``bboxes`` when not given)."""
    if tiles.device.type == "cpu":
        return fused_tile_blend_plain(tiles, weights, h, w, bboxes, normalize, table)
    refuse_grad("fused_tile_blend", "the tile blend runs at inference only; set "
                "MDU_FUSED_BLEND off to differentiate the grid", tiles, weights)
    return _launch("fused_tile_blend", "mdu_tile_blend", tiles, weights, h, w, bboxes,
                   normalize, table)


def tile_blend_floor(tiles, weights, h: int, w: int, bboxes: Sequence[BBox],
                     normalize: bool = True, table: Optional[BlendTable] = None):
    """``fused_tile_blend``'s checks and launch with an empty kernel on its
    grid (a CUDA tensor only); returns the canvas unwritten."""
    return _launch("fused_tile_blend_floor", "mdu_tile_blend_floor", tiles, weights, h, w,
                   bboxes, normalize, table)
