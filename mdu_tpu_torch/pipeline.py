"""txt2img with MultiDiffusion and the exact tiled VAE decode (counterpart of
the txt2img path of ``mdu_tpu/pipeline.py``).

  plan    = plan_tiled_diffusion(...)                    static geometry
  den_fn  = make_tiled_denoiser(plan, tile_denoise)      CFG'd per-tile denoiser
  latent  = sampler(den_fn, noise * sigma_0, sigmas)     Python loop
  image   = tiled_vae_decode(...)                        lockstep, pooled stats

The pipeline runs on the card unless the caller passes ``device="cpu"``.
Features of ``mdu_tpu`` that this slice does not port raise
``NotImplementedError`` naming the ROADMAP item they wait for.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from .config import SamplerConfig, TiledDiffusionConfig, TiledVAEConfig
from .device import resolve_device
from .models.unet import UNet2DCondition
from .models.vae import AutoencoderKL
from .samplers.denoiser import cfg_combine, denoised_from_model
from .samplers.samplers import get_sampler
from .samplers.schedule import NoiseSchedule
from .tiling.conds import Cond, concat_conds, tile_cond
from .tiling.schedulers import DiffusionTilePlan, make_tiled_denoiser, plan_tiled_diffusion
from .tiling.tiled_vae import (DECODER_PAD, lockstep_footprint_bytes,
                               plan_vae_tiles, tiled_vae_decode)
from .utils.grid import splitable
from .utils.image import tensor_to_image

# cond leaves this slice consumes; the others belong to later slices
_COND_KEYS = {"crossattn", "concat"}
_WAITING = {
    "control": "ControlNet (ROADMAP queue 1, item 18)",
    "guidance": "StableSR guidance (ROADMAP queue 1, item 18)",
    "vector": "SDXL conditioning (ROADMAP queue 1, item 18)",
    "adm": "unCLIP conditioning (ROADMAP queue 1, item 12)",
    "__and__": "AND prompt composition (ROADMAP queue 1, item 15)",
    "__bank__": "scheduled prompts (ROADMAP queue 1, item 15)",
}


@dataclass
class GenerationResult:
    images: Optional[np.ndarray]          # uint8 [B, H, W, 3]
    latents: torch.Tensor
    seed: int
    info: Dict[str, Any]


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to mdu_tpu_torch yet")


class DiffusionPipeline:
    """Stable-Diffusion txt2img over explicit cond dicts
    ``{"crossattn": [B, 77, D]}``. ``unet`` and ``vae`` hold their weights
    and are moved to the pipeline's device."""

    def __init__(self, unet: UNet2DCondition, vae: AutoencoderKL,
                 schedule: Optional[NoiseSchedule] = None, device=None,
                 controlnet=None, mesh=None, guidance_model=None):
        if controlnet is not None or guidance_model is not None:
            raise _unported("ControlNet/StableSR guidance (ROADMAP queue 1, item 18)")
        if mesh is not None:
            raise _unported("the multi-device mesh (ROADMAP queue 1, item 22)")
        self.device = resolve_device(device)
        self.unet = unet.to(self.device).eval()
        self.vae = vae.to(self.device).eval()
        self.schedule = schedule or NoiseSchedule()

    # ------------------------------------------------------------ denoisers

    def _cond(self, c: Optional[Cond]) -> Optional[Cond]:
        if c is None:
            return None
        if callable(c):
            raise _unported("callable conds (ROADMAP queue 1, item 15)")
        for key in c:
            if key not in _COND_KEYS:
                raise _unported(_WAITING.get(key, f"cond leaf {key!r}"))
        return {k: torch.as_tensor(v, device=self.device) for k, v in c.items()}

    def _model_fn(self):
        unet = self.unet

        def fn(x, t, cond: Cond):
            xin = x
            cc = cond.get("concat")
            if cc is not None and cc.shape[-2:] == x.shape[-2:] and cc.shape[1] > 0:
                xin = torch.cat([x, cc.to(x.dtype)], dim=1)
            return unet(xin, t, cond["crossattn"])

        return fn

    def _make_guided(self, cfg_scale: float):
        """``guided(x, sigma, c, u)``: the CFG'd denoiser, [uncond, cond]
        batched into one model call."""
        den = denoised_from_model(self._model_fn(), self.schedule)

        def _align(c, B):
            if c is None:
                return None
            out = {}
            for k, leaf in c.items():
                n = leaf.shape[0]
                out[k] = (leaf.repeat_interleave(B // n, dim=0)
                          if leaf.dim() >= 1 and n not in (0, B) and B % n == 0
                          else leaf)
            return out

        def guided(x, sigma, c, u):
            B = x.shape[0]
            c, u = _align(c, B), _align(u, B)
            s = torch.atleast_1d(sigma).expand(B)
            if u is None or cfg_scale == 1.0:
                return den(x, s, c)
            d = den(torch.cat([x, x]), torch.cat([s, s]), concat_conds(u, c))
            du, dc = d.chunk(2)
            return cfg_combine(du, dc, cfg_scale)

        return guided

    def _make_denoised_fn(self, plan: Optional[DiffusionTilePlan], cond, uncond,
                          cfg_scale: float):
        guided = self._make_guided(cfg_scale)
        if plan is None:
            return lambda x, sigma, step: guided(x, sigma, cond, uncond)
        hw = (plan.h, plan.w)

        def tile_denoise(flat, sigma, step, bboxes, batch_i):
            c = tile_cond(cond, bboxes, hw)
            u = tile_cond(uncond, bboxes, hw) if uncond is not None else None
            return guided(flat, sigma, c, u)

        return make_tiled_denoiser(plan, tile_denoise)

    def _plan(self, td: Optional[TiledDiffusionConfig], h: int, w: int):
        if td is None or not td.enabled:
            return None
        if td.regions:
            raise _unported("regional prompts (ROADMAP queue 1, item 17)")
        if td.noise_inverse:
            raise _unported("noise inversion (ROADMAP queue 1, item 12)")
        if not splitable(w, h, td.tile_w, td.tile_h, td.overlap):
            return None
        return plan_tiled_diffusion(td.method, h, w, tile_h=td.tile_h,
                                    tile_w=td.tile_w, overlap=td.overlap,
                                    tile_bs=td.tile_bs,
                                    uniform_batches=td.deterministic)

    @staticmethod
    def _check_sampler(sp: SamplerConfig) -> None:
        if sp.deepcache > 1:
            raise _unported("DeepCache (ROADMAP queue 1, item 20)")
        if sp.image_cfg_scale is not None:
            raise _unported("edit-model image CFG (ROADMAP queue 1, item 12)")
        if sp.s_churn > 0:
            raise _unported("sigma churn (ROADMAP queue 1, item 14)")
        get_sampler(sp.name)

    # --------------------------------------------------------------- txt2img

    def txt2img(self, cond: Cond, uncond: Optional[Cond], width: int = 512,
                height: int = 512, sampler: Optional[SamplerConfig] = None,
                seed: int = 0,
                tiled_diffusion: Optional[TiledDiffusionConfig] = None,
                tiled_vae: Optional[TiledVAEConfig] = None,
                region_conds: Sequence = (), batch_size: int = 1,
                decode: bool = True, step_callback=None) -> GenerationResult:
        """Generate ``batch_size`` images; image i starts from the noise of a
        ``torch.Generator`` seeded with ``seed + i``."""
        if region_conds:
            raise _unported("regional prompts (ROADMAP queue 1, item 17)")
        if step_callback is not None:
            raise _unported("step callbacks (ROADMAP queue 1, item 21)")
        h, w = height // 8, width // 8
        C = self.unet.cfg.out_channels
        noise = []
        for i in range(batch_size):
            gen = torch.Generator(device=self.device).manual_seed(seed + i)
            noise.append(torch.randn((1, C, h, w), generator=gen, device=self.device))
        return self._txt2img_from_noise(torch.cat(noise), cond, uncond, sampler,
                                        seed, tiled_diffusion, tiled_vae, decode)

    @torch.inference_mode()
    def _txt2img_from_noise(self, noise, cond: Cond, uncond: Optional[Cond],
                            sampler: Optional[SamplerConfig] = None, seed: int = 0,
                            tiled_diffusion: Optional[TiledDiffusionConfig] = None,
                            tiled_vae: Optional[TiledVAEConfig] = None,
                            decode: bool = True) -> GenerationResult:
        """txt2img from given unit-variance noise [B, 4, h, w]."""
        sp = sampler or SamplerConfig()
        self._check_sampler(sp)
        noise = torch.as_tensor(noise, dtype=torch.float32, device=self.device)
        h, w = noise.shape[2], noise.shape[3]
        plan = self._plan(tiled_diffusion, h, w)
        den_fn = self._make_denoised_fn(plan, self._cond(cond), self._cond(uncond),
                                        sp.cfg_scale)
        sigmas = torch.as_tensor(self.schedule.sampling_sigmas(sp.steps, sp.schedule),
                                 device=self.device)
        latents = get_sampler(sp.name)(den_fn, noise * sigmas[0], sigmas)
        images = self._decode(latents, tiled_vae) if decode else None
        return GenerationResult(images, latents, seed,
                                self._info(sp, tiled_diffusion, seed))

    # ------------------------------------------------------------------- VAE

    def _decode(self, latents, tv: Optional[TiledVAEConfig]) -> np.ndarray:
        out = self._decode_tensor(latents, tv)
        if not bool(torch.isfinite(out).all()):
            raise _unported("the NaN fallback of the VAE decode (ROADMAP queue 1, item 11)")
        return tensor_to_image(out)

    def _exact_vae_mode(self, tile_size: int, h: int, w: int, B: int) -> str:
        """'lockstep' when every tile fits through the decoder at once in the
        card's free memory (``torch.cuda.mem_get_info``), else the streaming
        mode it would need."""
        plan = plan_vae_tiles(h, w, tile_size, DECODER_PAD)
        if plan is None or self.device.type != "cuda":
            return "lockstep"
        free, _ = torch.cuda.mem_get_info(self.device)
        if lockstep_footprint_bytes(tile_size, plan.num_tiles, B) <= free:
            return "lockstep"
        return "stream"

    @torch.inference_mode()
    def _decode_tensor(self, latents, tv: Optional[TiledVAEConfig]):
        latents = torch.as_tensor(latents, device=self.device)
        z = latents / self.vae.cfg.scaling_factor
        if tv is None or not tv.enabled:
            return self.vae.decode(z)
        if tv.streaming:
            raise _unported("the streaming tiled VAE (ROADMAP queue 1, item 13)")
        if tv.fast_decoder:
            raise _unported("the fast tiled VAE decoder (ROADMAP queue 1, item 11)")
        if self._exact_vae_mode(tv.decoder_tile_size, z.shape[2], z.shape[3],
                                z.shape[0]) != "lockstep":
            raise _unported(
                "the exact lockstep decode does not fit in free device memory; "
                "the streaming exact decode (ROADMAP queue 1, item 13)")
        return tiled_vae_decode(self.vae, z, tile_size=tv.decoder_tile_size)

    # ------------------------------------------------------------------ misc

    @staticmethod
    def _info(sp: SamplerConfig, td: Optional[TiledDiffusionConfig], seed: int):
        info: Dict[str, Any] = {"Sampler": sp.name, "Steps": sp.steps,
                                "CFG scale": sp.cfg_scale, "Seed": seed}
        if td is not None and td.enabled:
            info["Tiled Diffusion"] = {
                "Method": td.method, "Tile tile width": td.tile_w,
                "Tile tile height": td.tile_h, "Tile Overlap": td.overlap,
                "Tile batch size": td.tile_bs}
        return info
