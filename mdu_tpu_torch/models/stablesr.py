"""StableSR's latent-image guidance adapter (counterpart of
``mdu_tpu/models/stablesr.py``, with its module names).

A time-aware encoder over the low-resolution guidance latent: conv_in, the
UNet's ResBlocks and downsamples level by level, a mid ResBlock, and a zero
conv after each, whose outputs are residuals on the UNet's skips and mid
state, the interface a ControlNet uses (``UNet2DCondition(...,
residuals=)``). The guidance latent rides the cond as its ``guidance`` leaf,
which ``tiling/`` cuts per tile, region and window like any latent-canvas
leaf (ref abstractdiffusion.py:547-588). There is no text cross-attention
and no pixel-space hint encoder.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .controlnet import ZeroConv
from .layers import Conv2D, Linear, silu, timestep_embedding
from .unet import Downsample2D, ResBlock, UNetConfig


class StableSRGuidance(nn.Module):
    """``forward(guidance [B, C, h, w], timesteps [B]) -> (down_residuals,
    mid_residual)``, each times ``guidance_scale``; the residuals match
    ``UNet2DCondition``'s skip list (conv_in, ``layers_per_block`` a level,
    a downsample between levels) and its mid state. The guidance latent has
    the UNet's ``out_channels``."""

    def __init__(self, cfg: UNetConfig, guidance_scale: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.guidance_scale = guidance_scale
        self.dtype = dtype
        bc = cfg.block_out_channels
        ted = cfg.time_embed_dim
        g = cfg.norm_num_groups
        self.time_embed_1 = Linear(bc[0], ted, dtype=dtype)
        self.time_embed_2 = Linear(ted, ted, dtype=dtype)
        self.conv_in = Conv2D(cfg.out_channels, bc[0], dtype=dtype)
        self.zero_0 = ZeroConv(bc[0], bc[0], dtype)
        zc = 1
        ch = bc[0]
        for i, out_ch in enumerate(bc):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", ResBlock(ch, out_ch, ted, g, dtype))
                ch = out_ch
                self.add_module(f"zero_{zc}", ZeroConv(ch, ch, dtype))
                zc += 1
            if i != len(bc) - 1:
                self.add_module(f"down_{i}_downsample", Downsample2D(ch, dtype))
                self.add_module(f"zero_{zc}", ZeroConv(ch, ch, dtype))
                zc += 1
        self.mid_res = ResBlock(bc[-1], bc[-1], ted, g, dtype)
        self.zero_mid = ZeroConv(bc[-1], bc[-1], dtype)

    def forward(self, guidance, timesteps):
        cfg = self.cfg
        bc = cfg.block_out_channels
        temb = timestep_embedding(timesteps, bc[0])
        temb = self.time_embed_2(silu(self.time_embed_1(temb)))
        h = self.conv_in(guidance.to(self.dtype))
        residuals = [self.zero_0(h)]
        zc = 1
        for i in range(len(bc)):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{i}_res_{j}")(h, temb)
                residuals.append(getattr(self, f"zero_{zc}")(h))
                zc += 1
            if i != len(bc) - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
                residuals.append(getattr(self, f"zero_{zc}")(h))
                zc += 1
        mid = self.zero_mid(self.mid_res(h, temb))
        s = self.guidance_scale
        return tuple(r * s for r in residuals), mid * s


def combine_residuals(a: Optional[tuple], b: Optional[tuple]) -> Optional[tuple]:
    """Two (down_residuals, mid) tuples added (a ControlNet's and StableSR's);
    either may be None."""
    if a is None:
        return b
    if b is None:
        return a
    return tuple(x + y for x, y in zip(a[0], b[0])), a[1] + b[1]
