"""Tile parallelism over a mesh of devices (counterpart of the inference part
of ``mdu_tpu/parallel/``; the dp x tp training step is not ported yet)."""
from .mesh import ShardAxis, ShardReducer, TileMesh, canonical_device, make_tile_mesh
from .sharded import (make_sharded_tile_denoiser, run_shards, shard_vae_tiles,
                      sharded_tiled_vae_decode, sharded_tiled_vae_encode_moments)

__all__ = ["ShardAxis", "ShardReducer", "TileMesh", "canonical_device", "make_tile_mesh",
           "make_sharded_tile_denoiser", "run_shards", "shard_vae_tiles",
           "sharded_tiled_vae_decode", "sharded_tiled_vae_encode_moments"]
