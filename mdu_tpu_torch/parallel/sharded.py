"""Tile parallelism over a tile mesh (counterpart of
``mdu_tpu/parallel/sharded.py``).

* ``make_sharded_tile_denoiser``: the grid's tiles split over the mesh's
  shards, each shard denoised on its device, the denoised tiles added into
  the canvas in bbox order on the canvas's device: the pipeline's sharded
  grid (``tiling/schedulers.py::make_sharded_grid``) under a plain tile
  denoiser.
* The sharded exact tiled VAE: the lockstep tiles split over the shards,
  one host thread a shard (as ``torch.nn.parallel.parallel_apply`` runs
  its replicas), every GroupNorm's pooled sums added over the shards
  through the mesh's all-reduce (``TileContext.axis``). Padding tiles, which
  repeat the last tile, own nothing, so they add nothing to the statistics
  or to the output.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..ops.tile_context import TileContext
from ..tiling.schedulers import DiffusionTilePlan, make_sharded_grid, make_tiled_denoiser
from ..tiling.tiled_vae import (DECODER_PAD, ENCODER_PAD, _gather_plan_tiles, _scatter_owned,
                                plan_vae_tiles)
from .mesh import ShardAxis, TileMesh


def make_sharded_tile_denoiser(mesh: TileMesh, plan: DiffusionTilePlan,
                               tile_denoise_flat: Callable[[torch.Tensor, torch.Tensor],
                                                           torch.Tensor]):
    """``denoised_fn(x, sigma, step)`` with the grid's tiles sharded over the
    mesh (``mdu_tpu/parallel/sharded.py:37-103``): ``tile_denoise_flat(tiles
    [K * B, C, th, tw], sigma)`` denoises a chunk of one shard's tiles on the
    shard's device, and the tiles are fused as ``make_tiled_denoiser`` fuses
    them on one device. Grid tiles only: regions run unsharded."""
    grid = make_sharded_grid(plan, mesh, lambda flat, sigma, step, conds, chunk: (
        tile_denoise_flat(flat, sigma)))
    return make_tiled_denoiser(plan, None, sharded_grid=grid)


def shard_vae_tiles(mesh: TileMesh, num_tiles: int) -> Tuple[int, int]:
    """(padded tile count, tiles a shard) of a lockstep tiled VAE over the
    mesh (``mdu_tpu/parallel/sharded.py:106-110``)."""
    t_pad = -(-num_tiles // mesh.tiles) * mesh.tiles
    return t_pad, t_pad // mesh.tiles


def _device_context(dev: torch.device):
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def run_shards(mesh: TileMesh, fn: Callable[[int, torch.device, ShardAxis], object],
               ) -> List[object]:
    """``fn(shard, device, axis)`` for every shard, one host thread a shard
    under its device (and the caller's grad and inference modes, which a
    thread does not inherit); ``axis.psum`` meets the other shards. The
    results in shard order; a shard that raises breaks the meeting for the
    others, and its error is raised here."""
    reducer = mesh.reducer()
    results: List[object] = [None] * mesh.tiles
    errors: List[Tuple[int, BaseException]] = []
    grad, inference = torch.is_grad_enabled(), torch.is_inference_mode_enabled()

    def work(shard: int, dev: torch.device):
        try:
            with torch.inference_mode(inference), torch.set_grad_enabled(grad), \
                    _device_context(dev):
                results[shard] = fn(shard, dev, ShardAxis(reducer, shard))
        except BaseException as e:                       # noqa: BLE001
            errors.append((shard, e))
            reducer.abort()

    threads = [threading.Thread(target=work, args=(i, dev), name=f"tile-shard-{i}")
               for i, dev in enumerate(mesh.devices)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        first = [e for e in errors if not isinstance(e[1], threading.BrokenBarrierError)]
        shard, err = (first or errors)[0]
        raise RuntimeError(f"tile shard {shard} on {mesh.devices[shard]} failed") from err
    return results


def _sharded_tiled_vae(mesh: TileMesh, vaes: Dict, x: torch.Tensor, which: str,
                       tile_size: int) -> torch.Tensor:
    """The exact tiled VAE encode or decode with the tiles split over the
    mesh (``mdu_tpu/parallel/sharded.py:113-164``). ``vaes``: the VAE on
    each mesh device, by device (the caller makes the copies, as
    ``DiffusionPipeline._on`` does). An input that needs no tiling runs
    whole on the first shard's device."""
    decode = which == "decoder"
    plan = plan_vae_tiles(x.shape[2], x.shape[3], tile_size,
                          DECODER_PAD if decode else ENCODER_PAD)
    if plan is None:
        model = vaes[mesh.devices[0]]
        run = model.decode if decode else model.encode_moments
        return run(x.to(mesh.devices[0])).to(x.device)
    B, T = x.shape[0], plan.num_tiles
    T_pad, t_local = shard_vae_tiles(mesh, T)
    tiles = _gather_plan_tiles(x, plan)                        # [T * B, C, th, tw]
    if T_pad > T:
        tiles = torch.cat([tiles] + [tiles[-B:]] * (T_pad - T))
    masks = plan.local_masks()
    masks = np.concatenate([masks, np.zeros((T_pad - T,) + masks.shape[1:], np.float32)])
    cfg = vaes[mesh.devices[0]].cfg

    def shard(d, dev, axis):
        model = vaes[dev]
        ctx = TileContext(t_local, (plan.in_h, plan.in_w),
                          torch.as_tensor(masks[d * t_local:(d + 1) * t_local], device=dev),
                          axis=axis)
        part = tiles[d * t_local * B:(d + 1) * t_local * B].to(dev)
        return model.decode(part, ctx) if decode else model.encode_moments(part, ctx)

    out = torch.cat([o.to(x.device) for o in run_shards(mesh, shard)])[:T * B]
    if decode:
        return _scatter_owned(out, plan, 8, 1, cfg.out_channels, B)
    return _scatter_owned(out, plan, 1, 8, 2 * cfg.latent_channels, B)


def sharded_tiled_vae_decode(mesh: TileMesh, vaes: Dict, z: torch.Tensor,
                             tile_size: int = 96) -> torch.Tensor:
    """[B, 4, h, w] latents -> [B, 3, 8h, 8w], the exact tiled decode sharded;
    ``vaes`` the VAE on each mesh device."""
    return _sharded_tiled_vae(mesh, vaes, z, "decoder", tile_size)


def sharded_tiled_vae_encode_moments(mesh: TileMesh, vaes: Dict, x: torch.Tensor,
                                     tile_size: int = 1536) -> torch.Tensor:
    """[B, 3, H, W] images -> [B, 8, H/8, W/8] moments, the exact tiled encode
    sharded; ``vaes`` the VAE on each mesh device."""
    return _sharded_tiled_vae(mesh, vaes, x, "encoder", tile_size)
