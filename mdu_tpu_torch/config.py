"""Configuration dataclasses of the port's txt2img and img2img paths.

A copy of the knobs of ``mdu_tpu.config`` that the MultiDiffusion txt2img
path and the img2img upscaling path read, with the same names and defaults. A knob of a feature this slice
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
    # pre-upscale of the init image before img2img (``upscale.py``)
    upscaler: Optional[str] = None
    scale_factor: float = 2.0
    regions: List = field(default_factory=list)
    # noise inversion (img2img only)
    noise_inverse: bool = False
    noise_inverse_steps: int = 10
    noise_inverse_retouch: float = 1.0
    noise_inverse_renoise_strength: float = 1.0
    noise_inverse_renoise_kernel: int = 64
    # pad every tile UNet batch to exactly tile_bs (same call shape for
    # every batch)
    deterministic: bool = False


@dataclass
class TiledVAEConfig:
    enabled: bool = True
    # pixel-space tile size for the encoder, latent-space for the decoder
    encoder_tile_size: int = 1536
    decoder_tile_size: int = 96
    fast_decoder: bool = True
    fast_encoder: bool = True
    color_fix: bool = False
    # tiles per chunk of the fast modes
    tile_batch: int = 4
    streaming: bool = False


@dataclass
class SamplerConfig:
    name: str = "Euler"          # Euler | DDIM in this slice
    steps: int = 20
    cfg_scale: float = 7.0
    image_cfg_scale: Optional[float] = None
    denoising_strength: float = 0.75   # img2img only
    schedule: str = "automatic"
    s_churn: float = 0.0
    deepcache: int = 1
