"""Exact tiled VAE decode (counterpart of the lockstep path of
``mdu_tpu/tiling/tiled_vae.py``).

All tiles run lockstep-batched on the leading axis; every GroupNorm pools
the statistics of the tiles' owned regions (``ops/tile_context.py``), so the
result does not depend on the tiling. The plan mirrors the reference's
split_tiles (tilevae.py:405-462): latent halo 11, tile sizes auto-shrunk and
rounded to multiples of 32, every padded input tile the same shape (edge
windows slide inward).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.vae import AutoencoderKL
from ..ops.tile_context import TileContext

DECODER_PAD = 11   # latent-space halo


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class VAETilePlan:
    h: int
    w: int
    pad: int
    tile_h: int
    tile_w: int
    in_h: int                                         # padded input tile size
    in_w: int
    in_origins: Tuple[Tuple[int, int], ...]           # (y, x) of each tile
    owned: Tuple[Tuple[int, int, int, int], ...]      # (y0, y1, x0, x1)

    @property
    def num_tiles(self) -> int:
        return len(self.in_origins)

    def local_masks(self) -> np.ndarray:
        """[T, 1, in_h, in_w] 0/1 owned-region masks in tile coordinates."""
        m = np.zeros((self.num_tiles, 1, self.in_h, self.in_w), np.float32)
        for t, ((oy, ox), (y0, y1, x0, x1)) in enumerate(zip(self.in_origins, self.owned)):
            m[t, 0, y0 - oy:y1 - oy, x0 - ox:x1 - ox] = 1.0
        return m


def plan_vae_tiles(h: int, w: int, tile_size: int, pad: int) -> Optional[VAETilePlan]:
    """Split an (h, w) canvas; None when max(h, w) <= 2 * pad + tile_size."""
    if max(h, w) <= pad * 2 + tile_size:
        return None
    nth = max(1, math.ceil((h - 2 * pad) / tile_size))
    ntw = max(1, math.ceil((w - 2 * pad) / tile_size))
    rth = min(_round_up(math.ceil((h - 2 * pad) / nth), 32), _round_up(h, 32))
    rtw = min(_round_up(math.ceil((w - 2 * pad) / ntw), 32), _round_up(w, 32))
    in_h = min(rth + 2 * pad, h)
    in_w = min(rtw + 2 * pad, w)

    origins: List[Tuple[int, int]] = []
    owned: List[Tuple[int, int, int, int]] = []
    for i in range(nth):
        y0 = pad + i * rth
        y1 = min(pad + (i + 1) * rth, h)
        oy0 = y0 if i > 0 else 0
        oy1 = y1 if i < nth - 1 else h
        ty = min(max(0, y0 - pad), h - in_h)
        for j in range(ntw):
            x0 = pad + j * rtw
            x1 = min(pad + (j + 1) * rtw, w)
            ox0 = x0 if j > 0 else 0
            ox1 = x1 if j < ntw - 1 else w
            tx = min(max(0, x0 - pad), w - in_w)
            origins.append((ty, tx))
            owned.append((oy0, oy1, ox0, ox1))
    return VAETilePlan(h, w, pad, rth, rtw, in_h, in_w, tuple(origins), tuple(owned))


def _gather_plan_tiles(x, plan: VAETilePlan):
    """[B, C, H, W] -> [T*B, C, in_h, in_w] (tile-major)."""
    return torch.cat([x[:, :, oy:oy + plan.in_h, ox:ox + plan.in_w]
                      for (oy, ox) in plan.in_origins])


def _scatter_owned(tiles_out, plan: VAETilePlan, scale_num: int, scale_den: int,
                   out_channels: int, batch: int):
    """Place the owned region of each [T*B, C, oh, ow] tile into the canvas."""
    def s(v):
        return v * scale_num // scale_den

    out = torch.zeros((batch, out_channels, s(plan.h), s(plan.w)),
                      dtype=tiles_out.dtype, device=tiles_out.device)
    for t, ((oy, ox), (y0, y1, x0, x1)) in enumerate(zip(plan.in_origins, plan.owned)):
        tile = tiles_out[t * batch:(t + 1) * batch]
        out[:, :, s(y0):s(y1), s(x0):s(x1)] = \
            tile[:, :, s(y0 - oy):s(y1 - oy), s(x0 - ox):s(x1 - ox)]
    return out


def lockstep_footprint_bytes(tile_size: int, num_tiles: int, batch: int,
                             dtype_bytes: int = 2) -> int:
    """Rough peak-memory estimate of the lockstep decode: the widest
    full-resolution activation (128 channels) times ~4 live tensors."""
    side = (tile_size + 2 * DECODER_PAD) * 8
    return num_tiles * batch * 128 * side * side * dtype_bytes * 4


def tiled_vae_decode(vae: AutoencoderKL, z, tile_size: int = 96,
                     reference_pooling: bool = False):
    """Decode [B, 4, h, w] latents -> [B, 3, 8h, 8w] with exact pooled stats."""
    B = z.shape[0]
    plan = plan_vae_tiles(z.shape[2], z.shape[3], tile_size, DECODER_PAD)
    if plan is None:
        return vae.decode(z)
    ctx = TileContext(plan.num_tiles, (plan.in_h, plan.in_w),
                      torch.as_tensor(plan.local_masks(), device=z.device),
                      reference_pooling=reference_pooling)
    out_tiles = vae.decode(_gather_plan_tiles(z, plan), ctx)
    return _scatter_owned(out_tiles, plan, 8, 1, vae.cfg.out_channels, B)
