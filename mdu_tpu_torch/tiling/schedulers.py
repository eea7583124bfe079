"""MultiDiffusion and Mixture of Diffusers tile schedulers, with regional
prompt control (counterpart of the unrolled grid of
``mdu_tpu/tiling/schedulers.py``).

A tile scheduler is a combinator: it takes a per-tile denoiser (and a
per-region one) and returns a ``denoised_fn(x, sigma, step)`` for the
samplers. Tile outputs are added into the canvas in bbox order:

* MultiDiffusion: then divided by the paint counts,
  ``where(w > 1, buf / w, buf)`` (ref multidiffusion.py:208); a BACKGROUND
  region adds its output and +1 weight (:44-46);
* Mixture of Diffusers: each tile weighted by its gaussian times the
  precomputed ``1 / sum(weights)`` over its bbox, with no divide at the end
  (ref mixtureofdiffusers.py:29-36, 125-126); a BACKGROUND region carries a
  gaussian of its own size (:45-55).

Each region runs at its full size through ``region_denoise`` after the grid;
FOREGROUND regions are feather-blended over the result (ref
multidiffusion.py:189-216). Under ``MDU_FUSED_BLEND`` the grid's sum is one
fused gather over all tiles (``ops/kernels/tile_blend.py``), as in
``mdu_tpu/tiling/schedulers.py:343-367``, and the region adds follow it.
The JAX package rolls 8 or more tile batches into a ``lax.scan``; that is a
compile-time measure with the same arithmetic, and the port stays unrolled.

A tile denoiser that keeps DeepCache state (``stateful=True``: one cache a
tile batch, kept by the pipeline's denoiser) never takes the fused blend, as
the JAX package's stateful grid never does
(``mdu_tpu/tiling/schedulers.py:303-305``); the scatter-add sums the grid.
"""
from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import flags
from ..config import Method
from ..ops.fusion import feather_blend, gather_tiles, weighted_average
from ..ops.kernels import BlendTable, fused_tile_blend
from ..utils.bbox import BBox, BlendMode, RegionBBox, RegionSpec
from ..utils.grid import batch_bboxes, clamp_overlap, paint_count, split_grid
from ..utils.weights import feather_mask, gaussian_weights

# tile_denoise(x_tiles [K*B, C, th, tw], sigma, step, bboxes, batch_idx)
TileDenoiseFn = Callable[[torch.Tensor, torch.Tensor, int, Sequence[BBox], int],
                         torch.Tensor]
# region_denoise(x_region [B, C, rh, rw], sigma, step, region_idx)
RegionDenoiseFn = Callable[[torch.Tensor, torch.Tensor, int, int], torch.Tensor]


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
    draw_background: bool = True
    bboxes: Tuple[BBox, ...] = ()
    batched: Tuple[Tuple[BBox, ...], ...] = ()
    regions: Tuple[RegionBBox, ...] = ()
    weights: Optional[np.ndarray] = None          # [1, 1, h, w] paint weights
    tile_weights: Optional[np.ndarray] = None     # [th, tw] gaussian (MoD)
    region_weights: Tuple[Optional[np.ndarray], ...] = ()   # MoD BACKGROUND gaussians
    # pad every tile batch to exactly tile_bs
    uniform_batches: bool = False

    @property
    def num_batches(self) -> int:
        return len(self.batched)


def plan_tiled_diffusion(method: str, latent_h: int, latent_w: int,
                         tile_h: int = 96, tile_w: int = 96, overlap: int = 48,
                         tile_bs: int = 4, uniform_batches: bool = False,
                         regions: Sequence[RegionSpec] = (),
                         draw_background: bool = True) -> DiffusionTilePlan:
    """The MultiDiffusion or Mixture of Diffusers plan (ref
    abstractdiffusion.py:172-229): the grid (unless ``draw_background`` is
    off, which only regions can ask for) paints each tile's gaussian under
    MoD, a 1 under MD; the valid regions, at most ``MDU_MAX_REGIONS`` (16;
    ref --md_max_regions), resolve to latent bboxes and a BACKGROUND region
    paints a gaussian of its size under MoD, a 1 under MD."""
    if method not in (Method.MULTI_DIFF, Method.MIX_DIFF):
        # the JAX planner runs any other name as MultiDiffusion; DemoFusion
        # has its own entry point
        raise NotImplementedError(
            f"the tile planner takes {Method.MULTI_DIFF!r} and {Method.MIX_DIFF!r}; "
            f"for {method!r} call DiffusionPipeline.demofusion")
    tile_h = min(tile_h, latent_h)
    tile_w = min(tile_w, latent_w)
    overlap = clamp_overlap(tile_w, tile_h, overlap)
    is_mod = method == Method.MIX_DIFF

    max_regions = int(os.environ.get("MDU_MAX_REGIONS", "16"))
    valid = [r for r in regions if r.validate()]
    if len(valid) > max_regions:
        print(f"[Tiled Diffusion] warning: {len(valid)} regions exceeds "
              f"MDU_MAX_REGIONS={max_regions}; extra regions dropped "
              "(ref --md_max_regions)", file=sys.stderr)
        valid = valid[:max_regions]
    region_bboxes = tuple(r.to_bbox(latent_w, latent_h) for r in valid)
    for i, r in enumerate(region_bboxes):
        if r.w * r.h > 0.25 * latent_w * latent_h:
            print(f"[Tiled Diffusion] warning: region {i + 1} covers "
                  f"{100 * r.w * r.h / (latent_w * latent_h):.0f}% of the canvas"
                  " — expect high memory use (ref bboxHint.js VRAM warning)",
                  file=sys.stderr)
    if not region_bboxes:
        draw_background = True                     # nothing else to paint

    grid: List[BBox] = []
    tile_weights = None
    weights = np.zeros((1, 1, latent_h, latent_w), np.float32)
    if draw_background:
        grid = split_grid(latent_w, latent_h, tile_w, tile_h, overlap)
        tile_weights = gaussian_weights(tile_w, tile_h) if is_mod else None
        weights += paint_count(latent_w, latent_h, grid,
                               1.0 if tile_weights is None else tile_weights)
    region_weights: List[Optional[np.ndarray]] = []
    for r in region_bboxes:
        gw = None
        if r.blend_mode == BlendMode.BACKGROUND:
            gw = gaussian_weights(r.w, r.h) if is_mod else None
            weights[:, :, r.y:r.y + r.h, r.x:r.x + r.w] += 1.0 if gw is None else gw
        region_weights.append(gw)
    return DiffusionTilePlan(
        method=method, h=latent_h, w=latent_w, tile_h=tile_h, tile_w=tile_w,
        overlap=overlap, tile_bs=tile_bs, draw_background=draw_background,
        bboxes=tuple(grid), batched=tuple(tuple(b) for b in batch_bboxes(grid, tile_bs)),
        regions=region_bboxes, weights=weights, tile_weights=tile_weights,
        region_weights=tuple(region_weights), uniform_batches=uniform_batches)


def _mod_rescale(plan: DiffusionTilePlan) -> np.ndarray:
    """The exact reciprocal of the summed weights, 0 where nothing paints
    (ref mixtureofdiffusers.py:32)."""
    w = plan.weights[0, 0]
    return np.where(w > 0, 1.0 / np.where(w > 0, w, 1.0), 0.0)


def mod_tile_weights(plan: DiffusionTilePlan) -> np.ndarray:
    """[T, th, tw] MoD scatter weights: each tile's gaussian times the
    rescale over its bbox."""
    rescale = _mod_rescale(plan)
    return np.stack([plan.tile_weights * rescale[b.y:b.y + b.h, b.x:b.x + b.w]
                     for b in plan.bboxes]).astype(np.float32)


def _region_maps(plan: DiffusionTilePlan) -> List[Optional[np.ndarray]]:
    """Each region's [rh, rw] map: a FOREGROUND region's feather mask; under
    MoD a BACKGROUND region's scatter weights (its gaussian times the
    rescale over its bbox); None for a BACKGROUND region under MD."""
    rescale = _mod_rescale(plan) if plan.method == Method.MIX_DIFF else None
    maps: List[Optional[np.ndarray]] = []
    for r, gw in zip(plan.regions, plan.region_weights):
        if r.blend_mode == BlendMode.FOREGROUND:
            maps.append(feather_mask(r.w, r.h, r.feather_ratio))
        else:
            maps.append(None if gw is None else gw * rescale[r.y:r.y + r.h, r.x:r.x + r.w])
    return maps


def make_tiled_denoiser(plan: DiffusionTilePlan, tile_denoise: TileDenoiseFn,
                        region_denoise: Optional[RegionDenoiseFn] = None,
                        stateful: bool = False):
    """``denoised_fn(x, sigma, step)`` that denoises the plan's tile batches
    and regions and fuses them (ref multidiffusion.py:131-218,
    mixtureofdiffusers.py:61-179). ``stateful``: ``tile_denoise`` keeps
    DeepCache state by ``batch_idx``, and the grid is summed without the
    fused blend."""
    is_mod = plan.method == Method.MIX_DIFF
    if plan.regions and region_denoise is None:
        raise ValueError("a plan with regions needs a region_denoise")
    ptw_np = mod_tile_weights(plan) if is_mod and plan.bboxes else None
    maps_np = _region_maps(plan)
    weights = ptw = maps = None
    table = None                       # the fused blend's contributor table

    def denoised_fn(x, sigma, step):
        nonlocal weights, ptw, maps, table
        B, C, H, W = x.shape
        if (H, W) != (plan.h, plan.w):
            raise ValueError(f"input {H}x{W} does not match tile plan "
                             f"{plan.h}x{plan.w}")
        if weights is None or weights.device != x.device:
            weights = torch.as_tensor(plan.weights, device=x.device)
            ptw = None if ptw_np is None else torch.as_tensor(ptw_np, device=x.device)
            maps = [None if m is None else torch.as_tensor(m, device=x.device)
                    for m in maps_np]
        fused = flags.fused_blend() and bool(plan.bboxes) and not stateful
        tidx = 0
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
                t = out[k] * ptw[tidx + k] if is_mod else out[k]
                buf[:, :, b.y:b.y + b.h, b.x:b.x + b.w] += t
            tidx += K
        if fused:
            if table is None:
                table = BlendTable(plan.h, plan.w, plan.bboxes)
            stacked = torch.cat(outs)                          # [T, B, C, th, tw]
            if is_mod:
                stacked = stacked * ptw[:, None, None]         # gaussian x 1/sum(w)
            folded = stacked.reshape(-1, B * C, plan.tile_h, plan.tile_w)
            # the raw sum only; MD's divide follows, as in the JAX package
            buf = fused_tile_blend(folded, weights[0, 0], plan.h, plan.w, plan.bboxes,
                                   normalize=False, table=table).reshape(B, C, H, W)
        fbuf = fmask = fcount = None
        for i, r in enumerate(plan.regions):
            win = (slice(None), slice(None), slice(r.y, r.y + r.h), slice(r.x, r.x + r.w))
            out = region_denoise(x[win], sigma, step, i)
            if r.blend_mode == BlendMode.BACKGROUND:
                buf[win] += out if maps[i] is None else out * maps[i]
                continue
            if fbuf is None:
                fbuf = torch.zeros_like(buf)
                fmask = torch.zeros((1, 1, H, W), dtype=torch.float32, device=x.device)
                fcount = torch.zeros((1, 1, H, W), dtype=torch.float32, device=x.device)
            fbuf[win] += out
            fmask[win] += maps[i]
            fcount[win] += 1.0
        x_out = buf if is_mod else weighted_average(buf, weights)
        return x_out if fbuf is None else feather_blend(x_out, fbuf, fmask, fcount)

    return denoised_fn
