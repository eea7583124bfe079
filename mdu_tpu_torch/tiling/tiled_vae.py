"""Tiled VAE encode and decode (counterpart of ``mdu_tpu/tiling/tiled_vae.py``;
the streaming exact modes are in ``tiling/streaming_vae.py``).

* exact mode: all tiles run lockstep-batched on the leading axis; every
  GroupNorm pools the statistics of the tiles' owned regions
  (``ops/tile_context.py``), so the result does not depend on the tiling;
* fast mode: the GroupNorm statistics are estimated once from a
  nearest-exact downsampled whole image with the reference's
  distribution-shift correction (tilevae.py:542-563), then the tiles run in
  chunks of ``tile_batch`` with those statistics injected;
* ``color_fix`` (fast encoder): the estimated statistics only before the
  first downsample, exact pooling after it (tilevae.py:492-496).

The plan mirrors the reference's split_tiles (tilevae.py:405-462): halo 11
latent pixels (decoder) or 32 pixels (encoder), tile sizes auto-shrunk and
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
from ..ops.groupnorm import GroupNormStats
from ..ops.resize import resize_nchw
from ..ops.tile_context import TileContext

ENCODER_PAD = 32   # pixel-space halo (ref tilevae.py:373)
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


def _tile_side(which: str, tile_size: int) -> int:
    """Side of the widest full-resolution activation of one padded tile."""
    if which == "encoder":
        return tile_size + 2 * ENCODER_PAD
    return (tile_size + 2 * DECODER_PAD) * 8


def lockstep_footprint_bytes(which: str, tile_size: int, num_tiles: int, batch: int,
                             dtype_bytes: int = 2) -> int:
    """Rough peak-memory estimate of the exact lockstep mode: the widest
    full-resolution activation (128 channels) of every tile times ~4 live
    tensors."""
    side = _tile_side(which, tile_size)
    return num_tiles * batch * 128 * side * side * dtype_bytes * 4


def fast_footprint_bytes(which: str, tile_size: int, num_tiles: int, batch: int,
                         tile_batch: int, dtype_bytes: int = 2) -> int:
    """Rough peak-memory estimate of a fast mode: the gathered input tiles and
    the output tiles, plus one chunk's working set (~4 live tensors of the
    widest 128-channel activation)."""
    if which == "encoder":
        side_in = tile_size + 2 * ENCODER_PAD
        in_ch, out_ch, side_out, work_side = 3, 8, max(1, side_in // 8), side_in
    else:
        side_in = tile_size + 2 * DECODER_PAD
        in_ch, out_ch, side_out = 4, 3, side_in * 8
        work_side = side_out
    tile_io = in_ch * side_in * side_in + out_ch * side_out * side_out
    return (num_tiles * batch * tile_io * dtype_bytes
            + tile_batch * batch * 128 * work_side * work_side * dtype_bytes * 4)


def segment_tile_bytes(which: str, tile_size: int, dtype_bytes: int = 2) -> int:
    """Working-set bytes of one tile in the widest streaming segment
    (``tiling/streaming_vae.py``): about 5 tensors of the 128-channel
    full-resolution activation (the carried activation, the ResnetBlock
    residual, the conv's input and output, the fp32 statistics pass)."""
    side = _tile_side(which, tile_size)
    return 128 * side * side * dtype_bytes * 5


def streaming_device_footprint_bytes(which: str, tile_size: int, num_tiles: int,
                                     batch: int, group_size: int = 4,
                                     dtype_bytes: int = 2) -> int:
    """Peak-memory estimate of the device-resident streaming mode: every
    tile's current activation, the residual carried across the segment
    boundary (segments split mid-ResnetBlock) and the transition of an
    upsampling segment (3 widest activations of every tile), plus one
    group's working set."""
    side = _tile_side(which, tile_size)
    per_tile = 128 * side * side * dtype_bytes
    return (3 * num_tiles * batch * per_tile
            + group_size * batch * segment_tile_bytes(which, tile_size, dtype_bytes))


def _estimate_stats(x, tile_size: int, method) -> GroupNormStats:
    """Fast-mode statistics: ``method`` (the VAE's ``encode_moments`` or
    ``decode``) once on a nearest-exact downsampled whole input, whose
    per-channel mean and population std are moved to the input's, clipped to
    its range (tilevae.py:542-563); every GroupNorm records its statistics."""
    B, C, H, W = x.shape
    scale = tile_size / max(H, W)
    hw = (max(8, int(H * scale)) // 8 * 8, max(8, int(W * scale)) // 8 * 8)
    xd = resize_nchw(x, hw, "nearest")
    dims = (0, 2, 3)
    std_o = torch.std(x, dim=dims, keepdim=True, correction=0)
    mean_o = torch.mean(x, dim=dims, keepdim=True)
    std_n = torch.std(xd, dim=dims, keepdim=True, correction=0)
    mean_n = torch.mean(xd, dim=dims, keepdim=True)
    xd = (xd - mean_n) / (std_n + 1e-12) * std_o + mean_o
    xd = torch.clamp(xd, x.min(), x.max())
    stats = GroupNormStats(capture=True)
    method(xd, stats=stats)
    return stats.injected()


def _filter_pre_downsample(vae: AutoencoderKL, stats: GroupNormStats) -> GroupNormStats:
    """The estimated statistics of the encoder's norms before its first
    downsample only (the colour-fix boundary, ref tilevae.py:492-496)."""
    keep = [m for name, m in vae.encoder.named_modules() if name.startswith("down_0_block")]
    return stats.injected(keep)


def _map_tiles_with_stats(stats: GroupNormStats, tiles, method, tile_batch: int, B: int):
    """The tiles through ``method`` in chunks of ``tile_batch * B`` with the
    statistics injected; a short last chunk is padded by repeating its last
    tile, and the padded tiles are dropped."""
    TB = tiles.shape[0]
    chunk = max(1, min(tile_batch * B, TB))
    outs = []
    for i in range(0, TB, chunk):
        part = tiles[i:i + chunk]
        n = part.shape[0]
        if n < chunk:
            part = torch.cat([part, part[-1:].expand(chunk - n, *part.shape[1:])])
        outs.append(method(part, stats=stats)[:n])
    return torch.cat(outs)


def _context(plan: VAETilePlan, device, reference_pooling: bool = False) -> TileContext:
    return TileContext(plan.num_tiles, (plan.in_h, plan.in_w),
                       torch.as_tensor(plan.local_masks(), device=device),
                       reference_pooling=reference_pooling)


def tiled_vae_decode(vae: AutoencoderKL, z, tile_size: int = 96, fast: bool = False,
                     tile_batch: int = 8, reference_pooling: bool = False):
    """Decode [B, 4, h, w] latents -> [B, 3, 8h, 8w]."""
    B = z.shape[0]
    plan = plan_vae_tiles(z.shape[2], z.shape[3], tile_size, DECODER_PAD)
    if plan is None:
        return vae.decode(z)
    tiles = _gather_plan_tiles(z, plan)
    if fast:
        stats = _estimate_stats(z, tile_size, vae.decode)
        out_tiles = _map_tiles_with_stats(stats, tiles, vae.decode, tile_batch, B)
    else:
        out_tiles = vae.decode(tiles, _context(plan, z.device, reference_pooling))
    return _scatter_owned(out_tiles, plan, 8, 1, vae.cfg.out_channels, B)


def tiled_vae_encode_moments(vae: AutoencoderKL, x, tile_size: int = 1536,
                             fast: bool = False, tile_batch: int = 8,
                             color_fix: bool = False):
    """Encode [B, 3, H, W] images -> [B, 8, H/8, W/8] gaussian moments."""
    B = x.shape[0]
    plan = plan_vae_tiles(x.shape[2], x.shape[3], tile_size, ENCODER_PAD)
    if plan is None:
        return vae.encode_moments(x)
    tiles = _gather_plan_tiles(x, plan)
    if fast and color_fix:
        stats = _filter_pre_downsample(
            vae, _estimate_stats(x, tile_size, vae.encode_moments))
        out_tiles = vae.encode_moments(tiles, _context(plan, x.device), stats)
    elif fast:
        stats = _estimate_stats(x, tile_size, vae.encode_moments)
        out_tiles = _map_tiles_with_stats(stats, tiles, vae.encode_moments, tile_batch, B)
    else:
        out_tiles = vae.encode_moments(tiles, _context(plan, x.device))
    return _scatter_owned(out_tiles, plan, 1, 8, 2 * vae.cfg.latent_channels, B)
