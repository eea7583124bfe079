"""TileContext: GroupNorm statistics pooled across lockstep-batched tiles
(counterpart of ``mdu_tpu/ops/tile_context.py``).

When the tiles are split over a mesh's shards (``parallel/sharded.py``),
``axis`` is this shard's place on the mesh (``parallel.mesh.ShardAxis``):
the pooled sums then also add over the shards (``axis.psum``, the
counterpart of ``jax.lax.psum`` over ``TileContext.axis_name``).

``masks`` holds each tile's owned region at the base resolution;
``mask_for`` derives it at any integer up- or down-sampled resolution, which
keeps the owned regions a partition of the canvas at every level.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .. import flags
from .groupnorm import (apply_group_norm, group_norm, group_norm_chanreduce, group_norm_fold,
                        group_stats)


@dataclass(frozen=True)
class TileContext:
    num_tiles: int
    base_hw: tuple
    masks: Optional[torch.Tensor] = None   # [T, 1, h, w] 0/1 owned regions
    reference_pooling: bool = False        # average per-tile biased vars
    axis: Optional[object] = None          # the shard's ShardAxis on a mesh

    def mask_for(self, h: int, w: int) -> Optional[torch.Tensor]:
        if self.masks is None:
            return None
        bh, bw = self.base_hw
        if (h, w) == (bh, bw):
            return self.masks
        if bh % h == 0 and bw % w == 0:
            sh, sw = bh // h, bw // w
            return self.masks[:, :, ::sh, ::sw]
        if h % bh == 0 and w % bw == 0:
            fh, fw = h // bh, w // bw
            return self.masks.repeat_interleave(fh, dim=2).repeat_interleave(fw, dim=3)
        raise ValueError(f"mask resolution {(h, w)} incompatible with base {self.base_hw}")


def tile_group_norm(x, num_groups: int, weight, bias,
                    ctx: Optional[TileContext], eps: float = 1e-6):
    """GroupNorm whose statistics pool across the tile axis when ``ctx`` is
    given. ``x`` is [(T*B), C, h, w], tile index major. Without a context it
    is the plain per-sample GroupNorm in the formulation ``MDU_GN`` names
    (``mdu_tpu/ops/tile_context.py:65-78``)."""
    if ctx is None:
        mode = flags.gn_mode()
        if mode == "chanreduce":
            return group_norm_chanreduce(x, num_groups, weight, bias, eps)
        if mode == "fold":
            return group_norm_fold(x, num_groups, weight, bias, eps)
        return group_norm(x, num_groups, weight, bias, eps)

    TB, C, h, w = x.shape
    T = ctx.num_tiles
    B = TB // T
    G = num_groups

    mask = ctx.mask_for(h, w)
    if mask is not None:
        mm = mask.float().repeat_interleave(B, dim=0).reshape(TB, 1, 1, h, w)
        xf = x.float().reshape(TB, G, C // G, h, w)
        n = (mm.sum(dim=(2, 3, 4)) * (C // G)).reshape(TB, 1) * torch.ones(
            (1, G), device=x.device)
        s1 = (xf * mm).sum(dim=(2, 3, 4))
        s2 = (xf * xf * mm).sum(dim=(2, 3, 4))
        # tiles that own nothing weigh 0; keep their moments finite
        n_safe = torch.clamp(n, min=1.0)
        mean_t, meansq_t, n_t = s1 / n_safe, s2 / n_safe, n
    else:
        mean_t, meansq_t, n_t = group_stats(x, G)

    mean_t = mean_t.reshape(T, B, G)
    meansq_t = meansq_t.reshape(T, B, G)
    n_t = n_t.reshape(T, B, G)

    sn = n_t.sum(dim=0)
    s1 = (mean_t * n_t).sum(dim=0)
    s2 = (meansq_t * n_t).sum(dim=0)
    if ctx.axis is not None:
        sn, s1, s2 = ctx.axis.psum([sn, s1, s2])
    mean = s1 / sn
    if ctx.reference_pooling:
        var_t = torch.clamp(meansq_t - mean_t * mean_t, min=0.0)
        sv = (var_t * n_t).sum(dim=0)
        if ctx.axis is not None:
            sv, = ctx.axis.psum([sv])
        var = sv / sn
    else:
        var = torch.clamp(s2 / sn - mean * mean, min=0.0)

    mean_b = mean[None].expand(T, B, G).reshape(TB, G)
    var_b = var[None].expand(T, B, G).reshape(TB, G)
    return apply_group_norm(x, G, mean_b, var_b, weight, bias, eps)
