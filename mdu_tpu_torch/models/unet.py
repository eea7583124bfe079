"""SD1.5 UNet2DCondition in NCHW (counterpart of ``mdu_tpu/models/unet.py``).

Submodule names follow the flax modules (``down_0_res_0``, ``mid_attn``,
``up_1_upsample`` ...), so a flattened JAX parameter tree is this module's
``state_dict`` (see ``models/convert.py``). This slice ports the SD1.5
family: conv projections, fixed head count, no addition embedding.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import flags
from ..ops.attention import multi_head_attention
from .layers import Conv2D, GroupNorm, LayerNorm, Linear, silu, timestep_embedding


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    num_heads: Optional[int] = 8
    head_dim: Optional[int] = None
    transformer_layers: Tuple[int, ...] = (1, 1, 1, 0)   # 0 = no attn block
    use_linear_projection: bool = False
    addition_embed_type: Optional[str] = None
    norm_num_groups: int = 32
    adm_in_channels: Optional[int] = None

    def heads_for(self, channels: int) -> int:
        if self.head_dim is not None:
            return channels // self.head_dim
        return self.num_heads

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


def sd15_unet_config() -> UNetConfig:
    return UNetConfig()


def tiny_unet_config() -> UNetConfig:
    """Small SD1.5-shaped config for tests (full depth, thin width)."""
    return UNetConfig(block_out_channels=(8, 16, 16, 16), cross_attention_dim=16,
                      num_heads=2, transformer_layers=(1, 1, 1, 0), norm_num_groups=4)


class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, heads: int, context_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cdim = query_dim if context_dim is None else context_dim
        self.heads = heads
        self.to_q = Linear(query_dim, query_dim, use_bias=False, dtype=dtype)
        self.to_k = Linear(cdim, query_dim, use_bias=False, dtype=dtype)
        self.to_v = Linear(cdim, query_dim, use_bias=False, dtype=dtype)
        self.to_out = Linear(query_dim, query_dim, dtype=dtype)

    def forward(self, x, context=None):
        ctx = x if context is None else context
        out = multi_head_attention(self.to_q(x), self.to_k(ctx), self.to_v(ctx),
                                   self.heads)
        return self.to_out(out)


class FeedForwardGEGLU(nn.Module):
    def __init__(self, dim: int, mult: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = dim * mult
        self.proj = Linear(dim, inner * 2, dtype=dtype)
        self.out = Linear(inner, dim, dtype=dtype)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        # jax.nn.gelu defaults to the tanh approximation
        return self.out(h * F.gelu(gate, approximate="tanh"))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn1 = CrossAttention(dim, heads, dtype=dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.attn2 = CrossAttention(dim, heads, context_dim, dtype=dtype)
        self.norm3 = LayerNorm(dim, dtype=dtype)
        self.ff = FeedForwardGEGLU(dim, dtype=dtype)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    def __init__(self, cfg: UNetConfig, channels: int, depth: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.use_linear_projection:
            raise NotImplementedError(
                "linear projections (SD2/SDXL) wait for ROADMAP queue 1, item 18")
        C = channels
        self.norm = GroupNorm(C, cfg.norm_num_groups, eps=1e-6, dtype=dtype)
        self.proj_in = Conv2D(C, C, kernel_size=(1, 1), padding=0, dtype=dtype)
        for d in range(depth):
            self.add_module(f"block_{d}", BasicTransformerBlock(
                C, cfg.heads_for(C), cfg.cross_attention_dim, dtype=dtype))
        self.proj_out = Conv2D(C, C, kernel_size=(1, 1), padding=0, dtype=dtype)
        self.depth = depth

    def forward(self, x, context):
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x))
        h = h.reshape(B, C, H * W).transpose(1, 2)
        for d in range(self.depth):
            h = getattr(self, f"block_{d}")(h, context)
        h = h.transpose(1, 2).reshape(B, C, H, W)
        return x + self.proj_out(h)


class ResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_dim: int,
                 groups: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, groups, eps=1e-5, dtype=dtype)
        self.conv1 = Conv2D(in_channels, out_channels, dtype=dtype)
        self.norm2 = GroupNorm(out_channels, groups, eps=1e-5, dtype=dtype)
        self.conv2 = Conv2D(out_channels, out_channels, dtype=dtype)
        self.time_emb_proj = Linear(temb_dim, out_channels, dtype=dtype)
        self.conv_shortcut = (Conv2D(in_channels, out_channels, kernel_size=(1, 1),
                                     padding=0, dtype=dtype)
                              if in_channels != out_channels else None)

    def forward(self, x, temb):
        t = self.time_emb_proj(silu(temb))[:, :, None, None]
        if flags.fused_conv():
            # normalise + SiLU inside the conv (JAX ``unet.py:229-235``)
            a1, b1 = self.norm1(x, affine_only=True)
            h = self.conv1(x, scale=a1, shift=b1)
            h = h + t
            a2, b2 = self.norm2(h, affine_only=True)
            h = self.conv2(h, scale=a2, shift=b2)
        else:
            h = self.conv1(silu(self.norm1(x)))
            h = h + t
            h = self.conv2(silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2D(channels, channels, strides=(2, 2), padding=1, dtype=dtype)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2D(channels, channels, dtype=dtype)

    def forward(self, x, out_size=None):
        if out_size is not None and tuple(out_size) != (2 * x.shape[2], 2 * x.shape[3]):
            # to the skip's size, sampling at half-pixel centres like
            # jax.image.resize(..., "nearest")
            x = F.interpolate(x, size=tuple(int(s) for s in out_size),
                              mode="nearest-exact")
        else:
            x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return self.conv(x)


class UNet2DCondition(nn.Module):
    def __init__(self, cfg: UNetConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.addition_embed_type is not None or cfg.adm_in_channels is not None:
            raise NotImplementedError(
                "addition embeddings (SDXL, unCLIP) wait for ROADMAP queue 1, item 18")
        self.cfg = cfg
        self.dtype = dtype
        bc = cfg.block_out_channels
        ted = cfg.time_embed_dim
        L = len(bc)
        g = cfg.norm_num_groups
        self.time_embed_1 = Linear(bc[0], ted, dtype=dtype)
        self.time_embed_2 = Linear(ted, ted, dtype=dtype)
        self.conv_in = Conv2D(cfg.in_channels, bc[0], dtype=dtype)

        skip_ch = [bc[0]]
        ch = bc[0]
        for i in range(L):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", ResBlock(ch, bc[i], ted, g, dtype))
                ch = bc[i]
                if cfg.transformer_layers[i] > 0:
                    self.add_module(f"down_{i}_attn_{j}", Transformer2D(
                        cfg, ch, cfg.transformer_layers[i], dtype))
                skip_ch.append(ch)
            if i != L - 1:
                self.add_module(f"down_{i}_downsample", Downsample2D(ch, dtype))
                skip_ch.append(ch)

        mid_depth = cfg.transformer_layers[-1] if cfg.transformer_layers[-1] > 0 else 1
        self.mid_res_0 = ResBlock(bc[-1], bc[-1], ted, g, dtype)
        self.mid_attn = Transformer2D(cfg, bc[-1], mid_depth, dtype)
        self.mid_res_1 = ResBlock(bc[-1], bc[-1], ted, g, dtype)

        ch = bc[-1]
        for i in range(L):
            level = L - 1 - i
            out_ch = bc[level]
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}",
                                ResBlock(ch + skip_ch.pop(), out_ch, ted, g, dtype))
                ch = out_ch
                if cfg.transformer_layers[level] > 0:
                    self.add_module(f"up_{i}_attn_{j}", Transformer2D(
                        cfg, ch, cfg.transformer_layers[level], dtype))
            if i != L - 1:
                self.add_module(f"up_{i}_upsample", Upsample2D(ch, dtype))

        self.norm_out = GroupNorm(ch, g, eps=1e-5, dtype=dtype)
        self.conv_out = Conv2D(ch, cfg.out_channels, dtype=dtype)

    def forward(self, x, timesteps, context):
        """x [B, C, H, W]; timesteps [B]; context [B, L, D] -> [B, C, H, W]."""
        cfg = self.cfg
        bc = cfg.block_out_channels
        L = len(bc)
        temb = timestep_embedding(timesteps, bc[0])
        temb = self.time_embed_2(silu(self.time_embed_1(temb)))

        h = self.conv_in(x)
        skips = [h]
        for i in range(L):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{i}_res_{j}")(h, temb)
                if cfg.transformer_layers[i] > 0:
                    h = getattr(self, f"down_{i}_attn_{j}")(h, context)
                skips.append(h)
            if i != L - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
                skips.append(h)

        h = self.mid_res_0(h, temb)
        h = self.mid_attn(h, context)
        h = self.mid_res_1(h, temb)

        for i in range(L):
            level = L - 1 - i
            for j in range(cfg.layers_per_block + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = getattr(self, f"up_{i}_res_{j}")(h, temb)
                if cfg.transformer_layers[level] > 0:
                    h = getattr(self, f"up_{i}_attn_{j}")(h, context)
            if i != L - 1:
                nxt = skips[-1]
                h = getattr(self, f"up_{i}_upsample")(h, nxt.shape[2:])

        h = self.norm_out(h)
        return self.conv_out(silu(h))
