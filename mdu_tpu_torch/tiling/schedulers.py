"""MultiDiffusion tile scheduler (counterpart of the MultiDiffusion grid of
``mdu_tpu/tiling/schedulers.py``).

A tile scheduler is a combinator: it takes a per-tile denoiser and returns a
``denoised_fn(x, sigma, step)`` for the samplers. Tile outputs are added into
the canvas in bbox order and divided by the paint counts,
``where(w > 1, buf / w, buf)`` (ref multidiffusion.py:208). Under
``MDU_FUSED_BLEND`` the sum is one fused gather over all tiles
(``ops/kernels/tile_blend.py``), as in ``mdu_tpu/tiling/schedulers.py:343-367``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import flags
from ..config import Method
from ..ops.fusion import gather_tiles, weighted_average
from ..ops.kernels import BlendTable, fused_tile_blend
from ..utils.bbox import BBox
from ..utils.grid import batch_bboxes, clamp_overlap, paint_count, split_grid

# tile_denoise(x_tiles [K*B, C, th, tw], sigma, step, bboxes, batch_idx)
TileDenoiseFn = Callable[[torch.Tensor, torch.Tensor, int, Sequence[BBox], int],
                         torch.Tensor]


@dataclass(frozen=True)
class DiffusionTilePlan:
    """Static latent-canvas tiling plan."""

    method: str
    h: int
    w: int
    tile_h: int
    tile_w: int
    overlap: int
    tile_bs: int
    bboxes: Tuple[BBox, ...] = ()
    batched: Tuple[Tuple[BBox, ...], ...] = ()
    weights: Optional[np.ndarray] = None          # [1, 1, h, w] paint counts
    # pad every tile batch to exactly tile_bs
    uniform_batches: bool = False

    @property
    def num_batches(self) -> int:
        return len(self.batched)


def plan_tiled_diffusion(method: str, latent_h: int, latent_w: int,
                         tile_h: int = 96, tile_w: int = 96, overlap: int = 48,
                         tile_bs: int = 4, uniform_batches: bool = False
                         ) -> DiffusionTilePlan:
    """The MultiDiffusion plan (ref abstractdiffusion.py:172-229)."""
    if method != Method.MULTI_DIFF:
        raise NotImplementedError(
            f"{method} waits for ROADMAP queue 1, item 12 (Mixture of "
            "Diffusers) or item 19 (DemoFusion)")
    tile_h = min(tile_h, latent_h)
    tile_w = min(tile_w, latent_w)
    overlap = clamp_overlap(tile_w, tile_h, overlap)
    grid = split_grid(latent_w, latent_h, tile_w, tile_h, overlap)
    return DiffusionTilePlan(
        method=method, h=latent_h, w=latent_w, tile_h=tile_h, tile_w=tile_w,
        overlap=overlap, tile_bs=tile_bs, bboxes=tuple(grid),
        batched=tuple(tuple(b) for b in batch_bboxes(grid, tile_bs)),
        weights=paint_count(latent_w, latent_h, grid, 1.0),
        uniform_batches=uniform_batches)


def make_tiled_denoiser(plan: DiffusionTilePlan, tile_denoise: TileDenoiseFn):
    """``denoised_fn(x, sigma, step)`` that denoises the plan's tile batches
    and fuses them (ref multidiffusion.py:131-218)."""
    weights = None
    table = None                       # the fused blend's contributor table

    def denoised_fn(x, sigma, step):
        nonlocal weights, table
        B, C, H, W = x.shape
        if (H, W) != (plan.h, plan.w):
            raise ValueError(f"input {H}x{W} does not match tile plan "
                             f"{plan.h}x{plan.w}")
        if weights is None or weights.device != x.device:
            weights = torch.as_tensor(plan.weights, device=x.device)
        fused = flags.fused_blend()
        outs = []
        buf = None if fused else torch.zeros_like(x)
        for batch_i, bboxes in enumerate(plan.batched):
            tiles = gather_tiles(x, bboxes)                  # [K, B, C, th, tw]
            K = tiles.shape[0]
            Kp = plan.tile_bs if plan.uniform_batches else K
            call_bboxes = tuple(bboxes)
            if Kp > K:
                # pad the short batch by repeating its last tile, so every
                # UNet call has the same shape
                tiles = torch.cat([tiles, tiles[-1:].expand(Kp - K, *tiles.shape[1:])])
                call_bboxes = call_bboxes + (bboxes[-1],) * (Kp - K)
            flat = tiles.reshape(Kp * B, C, plan.tile_h, plan.tile_w)
            out = tile_denoise(flat, sigma, step, call_bboxes, batch_i)
            out = out.reshape(Kp, B, C, plan.tile_h, plan.tile_w)[:K]
            if fused:
                outs.append(out)
                continue
            for k, b in enumerate(bboxes):
                buf[:, :, b.y:b.y + b.h, b.x:b.x + b.w] += out[k]
        if fused:
            if table is None:
                table = BlendTable(plan.h, plan.w, plan.bboxes)
            stacked = torch.cat(outs)                          # [T, B, C, th, tw]
            folded = stacked.reshape(-1, B * C, plan.tile_h, plan.tile_w)
            # the raw sum only; the divide follows, as in the JAX package
            buf = fused_tile_blend(folded, weights[0, 0], plan.h, plan.w, plan.bboxes,
                                   normalize=False, table=table).reshape(B, C, H, W)
        return weighted_average(buf, weights)

    return denoised_fn
