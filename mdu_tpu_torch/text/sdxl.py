"""SDXL conditioning: two text encoders and the size micro-conditioning
(counterpart of ``mdu_tpu/text/sdxl.py``).

  crossattn = concat(CLIP-L penultimate, OpenCLIP-bigG penultimate)  [B, 77, 2048]
  vector    = bigG's pooled state, projected                         [B, 1280]
  time_ids  = (orig_h, orig_w, crop_top, crop_left, target_h, target_w)
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .conditioning import TextConditioner


class SDXLConditioner:
    """SDXL conds from two ``TextConditioner``s on the same device."""

    def __init__(self, te1: TextConditioner, te2: TextConditioner):
        self.te1 = te1        # CLIP-L (clip_skip 2)
        self.te2 = te2        # OpenCLIP-bigG (projection_dim 1280)

    def cond(self, prompt: str, width: int, height: int,
             original_size: Optional[Tuple[int, int]] = None,
             crops_coords_top_left: Tuple[int, int] = (0, 0), steps: Optional[int] = None):
        z1, _ = self.te1.encode([prompt])
        z2, pooled2 = self.te2.encode([prompt])
        # the chunk counts may differ when a prompt overflows: repeat to the longer
        L = max(z1.shape[1], z2.shape[1])

        def pad(z):
            return torch.cat([z] * max(1, L // z.shape[1]), dim=1)[:, :L]

        oh, ow = original_size or (height, width)
        ct, cl = crops_coords_top_left
        time_ids = torch.tensor([[oh, ow, ct, cl, height, width]], dtype=torch.float32,
                                device=z1.device)
        return {"crossattn": torch.cat([pad(z1), pad(z2)], dim=-1), "vector": pooled2,
                "time_ids": time_ids}

    def pair(self, prompt: str, neg_prompt: str, width: int, height: int,
             steps: Optional[int] = None, **kw):
        return (self.cond(prompt, width, height, steps=steps, **kw),
                self.cond(neg_prompt, width, height, steps=steps, **kw))
