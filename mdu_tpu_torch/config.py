"""Configuration dataclasses of the port's txt2img path.

A copy of the knobs of ``mdu_tpu.config`` that the MultiDiffusion txt2img
path reads, with the same names and defaults. A knob of a feature this slice
does not port is kept only where the pipeline checks it and raises
``NotImplementedError`` when it is switched on.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


class Method:
    """Tile-scheduler method names (ref tile_utils/utils.py:28-34)."""

    MULTI_DIFF = "MultiDiffusion"
    MIX_DIFF = "Mixture of Diffusers"
    DEMO_FU = "DemoFusion"


@dataclass
class TiledDiffusionConfig:
    enabled: bool = True
    method: str = Method.MULTI_DIFF
    tile_w: int = 96
    tile_h: int = 96
    overlap: int = 48
    tile_bs: int = 4
    regions: List = field(default_factory=list)
    noise_inverse: bool = False
    # pad every tile UNet batch to exactly tile_bs (same call shape for
    # every batch)
    deterministic: bool = False


@dataclass
class TiledVAEConfig:
    enabled: bool = True
    decoder_tile_size: int = 96
    fast_decoder: bool = True
    streaming: bool = False


@dataclass
class SamplerConfig:
    name: str = "Euler"          # Euler | DDIM in this slice
    steps: int = 20
    cfg_scale: float = 7.0
    image_cfg_scale: Optional[float] = None
    schedule: str = "automatic"
    s_churn: float = 0.0
    deepcache: int = 1
