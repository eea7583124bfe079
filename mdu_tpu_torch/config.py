"""Configuration dataclasses of the port's txt2img and img2img paths, and the
region JSON.

A copy of the knobs of ``mdu_tpu.config`` that the txt2img, regional and
img2img upscaling paths read, with the same names and defaults. A knob of a
feature the port does not have yet is kept only where the pipeline checks it
and raises ``NotImplementedError`` when it is switched on.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional

from .utils.bbox import BlendMode, RegionSpec


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
    # regional prompt control; without regions the grid is always drawn
    draw_background: bool = True
    regions: List[RegionSpec] = field(default_factory=list)
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
    name: str = "Euler"          # one of samplers.SAMPLERS, optionally + " Karras"
    steps: int = 20
    cfg_scale: float = 7.0
    image_cfg_scale: Optional[float] = None
    # kept as in the JAX package, whose pipeline never reads it: DDIM is not
    # a stochastic sampler there, so eta-DDIM is reached only by calling
    # samplers.sample_ddim(..., noise, eta) directly
    eta: float = 0.0
    denoising_strength: float = 0.75   # img2img only
    schedule: str = "automatic"        # automatic | karras
    # Karras churn (A1111's s_churn / s_tmin / s_tmax / s_noise): Euler, Heun
    # and DPM2 only
    s_churn: float = 0.0
    s_tmin: float = 0.0
    s_tmax: float = float("inf")
    s_noise: float = 1.0
    deepcache: int = 1


def regions_to_json(regions: List[RegionSpec]) -> str:
    """Region settings as the reference's region-config JSON
    (tilediffusion.py:533-571)."""
    payload = {
        f"Region {i + 1}": {
            "x": r.x, "y": r.y, "w": r.w, "h": r.h,
            "prompt": r.prompt, "neg_prompt": r.neg_prompt,
            "blend_mode": r.blend_mode.value,
            "feather_ratio": r.feather_ratio, "seed": r.seed,
        }
        for i, r in enumerate(regions)
    }
    return json.dumps(payload, indent=2)


def regions_from_json(text: str) -> List[RegionSpec]:
    """The regions of a region-config JSON, in the order of their keys
    sorted as strings (as the JAX package reads them)."""
    out = []
    for _, d in sorted(json.loads(text).items()):
        out.append(RegionSpec(
            x=round(float(d["x"]), 4), y=round(float(d["y"]), 4),
            w=round(float(d["w"]), 4), h=round(float(d["h"]), 4),
            prompt=d.get("prompt", ""), neg_prompt=d.get("neg_prompt", ""),
            blend_mode=BlendMode(d.get("blend_mode", "Background")),
            feather_ratio=round(float(d.get("feather_ratio", 0.2)), 4),
            seed=int(d.get("seed", -1)),
        ))
    return out


def regions_from_png_info(info: dict) -> List[RegionSpec]:
    """The regions, with their resolved seeds, from a generated image's info
    dict (``GenerationResult.info``; the reference's seed recovery,
    javascript/bboxHint.js:171-221)."""
    block = (info.get("Tiled Diffusion") or {}).get("Region control") or {}
    return regions_from_json(json.dumps(block))
