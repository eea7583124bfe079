"""The system under test: the port's ``DiffusionPipeline``, built from a
configuration file and a workload file, with the weights and conds the run
drew. The benchmark calls the port's public entries (``txt2img``,
``img2img``) and reads ``last_decode`` / ``last_vae_mode``; nothing else
of the port is touched here."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


@dataclass
class ImageResult:
    ok: bool
    image: Optional[np.ndarray]
    latents: Optional[torch.Tensor]
    why: str = ""
    traj: List[torch.Tensor] = field(default_factory=list)
    events: list = field(default_factory=list)


class Program:
    def __init__(self, config: dict, workload: dict, weights: dict, conds: dict, device):
        from mdu_tpu_torch import (DiffusionPipeline, SamplerConfig, TiledDiffusionConfig,
                                   TiledVAEConfig)
        from mdu_tpu_torch.models import AutoencoderKL, UNet2DCondition, UNetConfig, VAEConfig
        from mdu_tpu_torch.utils.bbox import BlendMode, RegionSpec

        self.wl, self.device = workload, torch.device(device)
        dtype = getattr(torch, config["dtype"])
        with torch.device("meta"):
            unet = UNet2DCondition(UNetConfig(**_tuples(config["unet"])), dtype=dtype)
            vae = AutoencoderKL(VAEConfig(**_tuples(config["vae"])), dtype=dtype)

        def part(prefix):
            return {k[len(prefix):]: v for k, v in weights.items() if k.startswith(prefix)}

        unet.load_state_dict(part("unet."), strict=True, assign=True)
        vae.load_state_dict(part("vae."), strict=True, assign=True)
        self.pipe = DiffusionPipeline(unet, vae, device=self.device)
        td = dict(workload["tiled_diffusion"])
        regions = [RegionSpec(r["x"], r["y"], r["w"], r["h"],
                              blend_mode=BlendMode(r.get("blend_mode", "Background")))
                   for r in td.pop("regions", ())]
        self.td = TiledDiffusionConfig(**td, regions=regions)
        self.tv = TiledVAEConfig(**workload["tiled_vae"])
        self.sp = SamplerConfig(**workload["sampler"])
        self.cond, self.uncond = conds["cond"], conds["uncond"]
        self.region_conds = conds["regions"]
        if workload["entry"] == "img2img":
            s = int(workload["image"]["size"] * workload["tiled_diffusion"]["scale_factor"])
            self.shape = (1, s, s, 3)
        else:
            self.shape = (1, workload["height"], workload["width"], 3)

    def image(self, seed: int, input_image: Optional[np.ndarray] = None,
              capture: bool = False, step_events: bool = False) -> ImageResult:
        """One whole image, back on the host. ``capture`` keeps the state
        after every sampler step (device copies); ``step_events`` records a
        CUDA event as the image starts and after every step, with no
        synchronize."""
        traj, events = [], []
        if step_events:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)

        def callback(i: int, x):
            if capture:
                traj.append(x.detach().clone())
            if step_events:
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                events.append(e)

        cb = callback if (capture or step_events) else None
        if self.wl["entry"] == "img2img":
            res = self.pipe.img2img(input_image, self.cond, self.uncond, sampler=self.sp,
                                    seed=seed, tiled_diffusion=self.td, tiled_vae=self.tv,
                                    step_callback=cb)
        else:
            res = self.pipe.txt2img(self.cond, self.uncond, width=self.wl["width"],
                                    height=self.wl["height"], sampler=self.sp, seed=seed,
                                    tiled_diffusion=self.td, tiled_vae=self.tv,
                                    region_conds=self.region_conds, step_callback=cb)
        images = np.asarray(res.images)
        why = ""
        if tuple(images.shape) != self.shape:
            why = f"output of shape {tuple(images.shape)}, expected {self.shape}"
        elif self.pipe.last_decode != "decode":
            why = f"the decode's recovery chain gave the image ({self.pipe.last_decode})"
        elif not bool(torch.isfinite(res.latents).all()):
            why = "non-finite latents"
        return ImageResult(not why, images[0] if images.ndim == 4 else None, res.latents,
                           why, traj, events)

    def close(self) -> None:
        del self.pipe
        self.cond = self.uncond = self.region_conds = None
