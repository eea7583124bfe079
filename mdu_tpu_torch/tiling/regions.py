"""Region-seeded noise for regional prompt control (counterpart of
``mdu_tpu/tiling/regions.py``; ref scripts/tilediffusion.py:486-529,
create_random_tensors_hijack): each region gets a gaussian patch of its own
seed; BACKGROUND patches are averaged where they overlap and replace the
base noise, then FOREGROUND patches, averaged the same way, replace both.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..utils.bbox import BlendMode, RegionBBox


def resolve_seed(seed: Optional[int], gen: torch.Generator) -> int:
    """-1 (or None) means random: draw a seed from ``gen`` (ref
    get_fixed_seed)."""
    if seed is None or int(seed) == -1:
        return int(torch.randint(0, 2**31 - 1, (), generator=gen, device=gen.device))
    return int(seed)


def compose_region_noise(base_noise: torch.Tensor, regions: Sequence[RegionBBox],
                         resolved_seeds: Sequence[int]) -> torch.Tensor:
    """[B, C, h, w] base noise with each region's patch [1, C, rh, rw],
    drawn from a ``torch.Generator`` on the noise's device seeded with the
    region's seed, pasted in."""
    if not regions:
        return base_noise
    B, C, H, W = base_noise.shape
    dev = base_noise.device
    layers = {mode: (torch.zeros_like(base_noise),
                     torch.zeros((1, 1, H, W), dtype=torch.float32, device=dev))
              for mode in BlendMode}
    for r, seed in zip(regions, resolved_seeds):
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        patch = torch.randn((1, C, r.h, r.w), generator=gen, dtype=base_noise.dtype,
                            device=dev)
        buf, cnt = layers[r.blend_mode]
        buf[:, :, r.y:r.y + r.h, r.x:r.x + r.w] += patch
        cnt[:, :, r.y:r.y + r.h, r.x:r.x + r.w] += 1.0
    out = base_noise
    for mode in (BlendMode.BACKGROUND, BlendMode.FOREGROUND):
        buf, cnt = layers[mode]
        buf = torch.where(cnt > 1, buf / cnt, buf)
        out = torch.where(cnt > 0, buf, out)
    return out
