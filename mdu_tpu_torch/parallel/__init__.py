"""Parallelism over a mesh of devices (counterpart of ``mdu_tpu/parallel/``):
the tile mesh at inference and the dp x tp train step."""
from .mesh import (NamedSharding, ShardAxis, ShardReducer, TileMesh, TrainMesh,
                   canonical_device, make_tile_mesh, make_train_mesh, replicated)
from .sharded import (make_sharded_tile_denoiser, run_shards, shard_vae_tiles,
                      sharded_tiled_vae_decode, sharded_tiled_vae_encode_moments)
from .training import make_train_step, param_shardings

__all__ = ["NamedSharding", "ShardAxis", "ShardReducer", "TileMesh", "TrainMesh",
           "canonical_device", "make_tile_mesh", "make_train_mesh", "replicated",
           "make_sharded_tile_denoiser", "run_shards", "shard_vae_tiles",
           "sharded_tiled_vae_decode", "sharded_tiled_vae_encode_moments",
           "make_train_step", "param_shardings"]
