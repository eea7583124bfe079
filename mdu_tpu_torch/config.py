"""Configuration dataclasses of the port's txt2img, img2img and DemoFusion
paths, the region JSON and the DemoFusion info block.

A copy of the knobs of ``mdu_tpu.config`` that the txt2img, regional,
img2img upscaling and DemoFusion paths read, with the same names and defaults.
"""
from __future__ import annotations

import dataclasses
import json
import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

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
    # the reference's causal-layers knob, carried as the JAX package carries
    # it (``mdu_tpu/config.py:42``): nothing reads it
    causal_layers: bool = False
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
    # the JAX package's switch for its lax.scan grid, decided by its rule
    # into the plan's ``scan_tiles`` (None: when the batches reach
    # MDU_TILE_SCAN_THRESHOLD, 8; never under ``deterministic``). The scan
    # bounds a compile and gives the unrolled result; the eager port runs
    # the batches unrolled either way
    tile_scan: Optional[bool] = None

    def validate(self) -> "TiledDiffusionConfig":
        """A copy with the overlap clamped below the tile size
        (``mdu_tpu/config.py:67-71``)."""
        from .utils.grid import clamp_overlap

        return dataclasses.replace(self, overlap=clamp_overlap(self.tile_w, self.tile_h,
                                                               self.overlap))


@dataclass
class TiledVAEConfig:
    enabled: bool = True
    # pixel-space tile size for the encoder, latent-space for the decoder
    encoder_tile_size: int = 1536
    decoder_tile_size: int = 96
    fast_decoder: bool = True
    fast_encoder: bool = True
    color_fix: bool = False
    # tiles per chunk of the fast modes, and per group of the streaming modes
    tile_batch: int = 4
    # the exact modes with the tiles in CPU memory between segments
    # (stream-host, tiling/streaming_vae.py) whatever the memory budget
    streaming: bool = False
    # the dtype stream-host spills its activations in (e.g. 'float8_e4m3fn');
    # None keeps the VAE's dtype
    spill_dtype: Optional[str] = None


@dataclass
class DemoFusionConfig:
    """DemoFusion knobs (ref scripts/tileglobal.py:55-124 UI)."""

    enabled: bool = True
    window_size: int = 128
    overlap: int = 64
    tile_bs: int = 4
    tile_bs_g: int = 4           # global dilated-view batch size
    scale_factor: int = 3
    cosine_scale_1: float = 3.0  # skip-residual schedule
    cosine_scale_2: float = 1.0  # local/global mix schedule
    cosine_scale_3: float = 1.0  # gaussian blur sigma schedule
    sigma: float = 0.6
    random_jitter: bool = True
    mixture: bool = False        # run half the global views unblurred
    gaussian_filter: bool = True
    keep_intermediate: bool = True
    denoise_strengths: Tuple[float, ...] = (0.45,)  # per-phase strengths
    # the JAX package's switch for its windows' lax.scan, decided by its
    # rule (``tiling/demofusion.py::resolve_df_scan``; None: MDU_DF_SCAN,
    # else at MDU_TILE_SCAN_THRESHOLD, 8, or more batches a phase); the
    # eager port runs the batches unrolled either way
    scan_windows: Optional[bool] = None


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
    # DeepCache (arXiv 2312.00858): every ``deepcache``-th step runs the full
    # UNet and refreshes the cache of its deep features; the steps between
    # recompute only the shallowest ``deepcache_branch`` levels. 1 = off
    deepcache: int = 1
    deepcache_branch: int = 1


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


def _natural_key(key: str):
    """Sort key that compares the digit runs of ``key`` as numbers: "Region
    2" before "Region 10". Below ten regions this is the order of the keys
    sorted as strings, which the JAX package uses for any count."""
    return [int(t) if i % 2 else t for i, t in enumerate(re.split(r"(\d+)", key))]


def regions_from_json(text: str) -> List[RegionSpec]:
    """The regions of a region-config JSON, in the order of N in the "Region
    N" keys that ``regions_to_json`` writes (the JAX package sorts the keys
    as strings, which puts "Region 10" before "Region 2")."""
    out = []
    for _, d in sorted(json.loads(text).items(), key=lambda kv: _natural_key(kv[0])):
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


def demofusion_from_png_info(info: dict) -> Tuple[DemoFusionConfig, SamplerConfig]:
    """The DemoFusion and sampler settings from a DemoFusion image's info dict
    (``GenerationResult.info``; ref tileglobal.py:28-40, 172-191)."""
    b = info.get("DemoFusion") or {}
    cfg = DemoFusionConfig(
        scale_factor=int(b.get("Scale factor", 3)),
        window_size=int(b.get("Window size", 128)),
        overlap=int(b.get("Overlap", 64)),
        tile_bs=int(b.get("Tile batch size", 4)),
        tile_bs_g=int(b.get("Global batch size", 4)),
        cosine_scale_1=float(b.get("Cosine scale 1", 3.0)),
        cosine_scale_2=float(b.get("Cosine scale 2", 1.0)),
        cosine_scale_3=float(b.get("Cosine scale 3", 1.0)),
        sigma=float(b.get("Sigma", 0.6)),
        random_jitter=bool(b.get("Random jitter", True)),
        mixture=bool(b.get("Mixture", False)),
        gaussian_filter=bool(b.get("Gaussian filter", True)),
        keep_intermediate=bool(b.get("Keep intermediate", True)),
        denoise_strengths=tuple(float(s) for s in b.get("Denoise strengths", (0.45,))),
    )
    sp = SamplerConfig(name=info.get("Sampler", "Euler"), steps=int(info.get("Steps", 20)),
                       cfg_scale=float(info.get("CFG scale", 7.0)))
    return cfg, sp
