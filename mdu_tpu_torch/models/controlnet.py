"""ControlNet: the zero-conv control branch of the UNet (counterpart of
``mdu_tpu/models/controlnet.py``, with its module names).

A copy of the UNet's down and mid path, a small conv encoder that takes the
pixel-space hint to the latent resolution, and 1x1 convs initialised to zero
that give one residual a skip and one for the mid state (diffusers
ControlNetModel semantics). The UNet adds them (``UNet2DCondition(...,
residuals=)``). The hint is a pixel-space cond leaf, so the tile and window
slicing of ``tiling/`` cuts it per tile at 8x the latent bbox.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .layers import Conv2D, Linear, silu, timestep_embedding
from .unet import Downsample2D, ResBlock, Transformer2D, UNetConfig, text_time_embedding


def ZeroConv(in_channels: int, features: int, dtype: torch.dtype = torch.float32) -> Conv2D:
    """1x1 conv whose weight and bias start at zero (the ControlNet gate);
    ``random_state_dict`` keeps every ``zero*`` parameter at zero."""
    return Conv2D(in_channels, features, kernel_size=(1, 1), padding=0, dtype=dtype)


class ControlNetConditioningEmbedding(nn.Module):
    """Pixel hint [B, 3, H, W] -> latent-resolution features (a stride-8
    conv stack ending in a zero conv)."""

    def __init__(self, out_channels: int,
                 block_channels: Tuple[int, ...] = (16, 32, 96, 256),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ch = block_channels
        self.n = len(ch) - 1
        self.conv_in = Conv2D(3, ch[0], dtype=dtype)            # an RGB hint
        for i in range(self.n):
            self.add_module(f"block_{2 * i}", Conv2D(ch[i], ch[i], dtype=dtype))
            self.add_module(f"block_{2 * i + 1}", Conv2D(ch[i], ch[i + 1], strides=(2, 2),
                                                         dtype=dtype))
        self.conv_out = ZeroConv(ch[-1], out_channels, dtype=dtype)

    def forward(self, hint):
        h = silu(self.conv_in(hint))
        for i in range(2 * self.n):
            h = silu(getattr(self, f"block_{i}")(h))
        return self.conv_out(h)


class ControlNet(nn.Module):
    """The UNet's down and mid path emitting a residual per skip:
    ``forward(x, t, context, hint, added_cond) -> (down_residuals,
    mid_residual)``, each scaled by ``conditioning_scale``."""

    def __init__(self, cfg: UNetConfig, conditioning_scale: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.conditioning_scale = conditioning_scale
        self.dtype = dtype
        bc = cfg.block_out_channels
        ted = cfg.time_embed_dim
        g = cfg.norm_num_groups
        self.time_embed_1 = Linear(bc[0], ted, dtype=dtype)
        self.time_embed_2 = Linear(ted, ted, dtype=dtype)
        if cfg.addition_embed_type == "text_time":
            add_in = cfg.addition_pooled_dim + cfg.num_time_ids * cfg.addition_time_embed_dim
            self.add_embed_1 = Linear(add_in, ted, dtype=dtype)
            self.add_embed_2 = Linear(ted, ted, dtype=dtype)
        self.conv_in = Conv2D(cfg.in_channels, bc[0], dtype=dtype)
        self.cond_embedding = ControlNetConditioningEmbedding(bc[0], dtype=dtype)

        self.zero_0 = ZeroConv(bc[0], bc[0], dtype)
        zc = 1
        ch = bc[0]
        for i, out_ch in enumerate(bc):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", ResBlock(ch, out_ch, ted, g, dtype))
                ch = out_ch
                if cfg.transformer_layers[i] > 0:
                    self.add_module(f"down_{i}_attn_{j}", Transformer2D(
                        cfg, ch, cfg.transformer_layers[i], dtype))
                self.add_module(f"zero_{zc}", ZeroConv(ch, ch, dtype))
                zc += 1
            if i != len(bc) - 1:
                self.add_module(f"down_{i}_downsample", Downsample2D(ch, dtype))
                self.add_module(f"zero_{zc}", ZeroConv(ch, ch, dtype))
                zc += 1
        mid_depth = cfg.transformer_layers[-1] if cfg.transformer_layers[-1] > 0 else 1
        self.mid_res_0 = ResBlock(bc[-1], bc[-1], ted, g, dtype)
        self.mid_attn = Transformer2D(cfg, bc[-1], mid_depth, dtype)
        self.mid_res_1 = ResBlock(bc[-1], bc[-1], ted, g, dtype)
        self.zero_mid = ZeroConv(bc[-1], bc[-1], dtype)

    def forward(self, x, timesteps, context, hint, added_cond: Optional[dict] = None):
        cfg = self.cfg
        bc = cfg.block_out_channels
        temb = timestep_embedding(timesteps, bc[0])
        temb = self.time_embed_2(silu(self.time_embed_1(temb)))
        if cfg.addition_embed_type == "text_time" and added_cond is not None:
            temb = temb + text_time_embedding(self, cfg, added_cond, x.shape[0])

        h = self.conv_in(x[:, :cfg.in_channels]) + self.cond_embedding(hint)
        residuals = [self.zero_0(h)]
        zc = 1
        for i in range(len(bc)):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{i}_res_{j}")(h, temb)
                if cfg.transformer_layers[i] > 0:
                    h = getattr(self, f"down_{i}_attn_{j}")(h, context)
                residuals.append(getattr(self, f"zero_{zc}")(h))
                zc += 1
            if i != len(bc) - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
                residuals.append(getattr(self, f"zero_{zc}")(h))
                zc += 1
        h = self.mid_res_0(h, temb)
        h = self.mid_attn(h, context)
        h = self.mid_res_1(h, temb)
        mid = self.zero_mid(h)
        s = self.conditioning_scale
        return tuple(r * s for r in residuals), mid * s
