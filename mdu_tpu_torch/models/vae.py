"""SD VAE, decoder side (counterpart of ``mdu_tpu/models/vae.py``).

Every GroupNorm takes an optional ``TileContext``: with one, its statistics
pool across the lockstep-batched tiles, which makes the tiled decode exact.
The encoder waits for slice B (ROADMAP queue 1, item 11).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.attention import multi_head_attention
from ..ops.tile_context import TileContext
from .layers import Conv2D, GroupNorm, Linear, silu


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    attn_q_chunk: int = 4096

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


def tiny_vae_config() -> VAEConfig:
    """Small config for tests: downscale 8 like SD, 4-ch latent, thin."""
    return VAEConfig(block_out_channels=(8, 8, 16, 16), norm_num_groups=4)


class ResnetBlock(nn.Module):
    def __init__(self, cfg: VAEConfig, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        g = cfg.norm_num_groups
        self.norm1 = GroupNorm(in_channels, g, dtype=dtype)
        self.conv1 = Conv2D(in_channels, out_channels, dtype=dtype)
        self.norm2 = GroupNorm(out_channels, g, dtype=dtype)
        self.conv2 = Conv2D(out_channels, out_channels, dtype=dtype)
        self.conv_shortcut = (Conv2D(in_channels, out_channels, kernel_size=(1, 1),
                                     padding=0, dtype=dtype)
                              if in_channels != out_channels else None)

    def forward(self, x, ctx: Optional[TileContext] = None):
        h = self.conv1(silu(self.norm1(x, ctx)))
        h = self.conv2(silu(self.norm2(h, ctx)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over spatial tokens (VAE mid block)."""

    def __init__(self, cfg: VAEConfig, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.q_chunk = cfg.attn_q_chunk
        self.group_norm = GroupNorm(channels, cfg.norm_num_groups, dtype=dtype)
        self.to_q = Linear(channels, channels, dtype=dtype)
        self.to_k = Linear(channels, channels, dtype=dtype)
        self.to_v = Linear(channels, channels, dtype=dtype)
        self.to_out = Linear(channels, channels, dtype=dtype)

    def forward(self, x, ctx: Optional[TileContext] = None):
        h = self.group_norm(x, ctx)
        B, C, H, W = h.shape
        tokens = h.reshape(B, C, H * W).transpose(1, 2)
        out = multi_head_attention(self.to_q(tokens), self.to_k(tokens),
                                   self.to_v(tokens), num_heads=1,
                                   q_chunk=self.q_chunk)
        out = self.to_out(out).transpose(1, 2).reshape(B, C, H, W)
        return x + out


class Upsample(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2D(channels, channels, dtype=dtype)

    def forward(self, x):
        return self.conv(x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3))


class MidBlock(nn.Module):
    def __init__(self, cfg: VAEConfig, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.block_1 = ResnetBlock(cfg, channels, channels, dtype)
        self.attn_1 = AttnBlock(cfg, channels, dtype)
        self.block_2 = ResnetBlock(cfg, channels, channels, dtype)

    def forward(self, x, ctx: Optional[TileContext] = None):
        return self.block_2(self.attn_1(self.block_1(x, ctx), ctx), ctx)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        chans = list(reversed(cfg.block_out_channels))
        self.conv_in = Conv2D(cfg.latent_channels, chans[0], dtype=dtype)
        self.mid = MidBlock(cfg, chans[0], dtype)
        in_ch = chans[0]
        for i, ch in enumerate(chans):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_block_{j}", ResnetBlock(cfg, in_ch, ch, dtype))
                in_ch = ch
            if i != len(chans) - 1:
                self.add_module(f"up_{i}_upsample", Upsample(ch, dtype))
        self.norm_out = GroupNorm(in_ch, cfg.norm_num_groups, dtype=dtype)
        self.conv_out = Conv2D(in_ch, cfg.out_channels, dtype=dtype)

    def forward(self, z, ctx: Optional[TileContext] = None):
        cfg = self.cfg
        n = len(cfg.block_out_channels)
        h = self.mid(self.conv_in(z), ctx)
        for i in range(n):
            for j in range(cfg.layers_per_block + 1):
                h = getattr(self, f"up_{i}_block_{j}")(h, ctx)
            if i != n - 1:
                h = getattr(self, f"up_{i}_upsample")(h)
        return self.conv_out(silu(self.norm_out(h, ctx)))


class AutoencoderKL(nn.Module):
    """The decoding half of the SD VAE: ``post_quant_conv`` and ``decoder``."""

    def __init__(self, cfg: VAEConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.decoder = Decoder(cfg, dtype)
        self.post_quant_conv = Conv2D(cfg.latent_channels, cfg.latent_channels,
                                      kernel_size=(1, 1), padding=0, dtype=dtype)

    def decode(self, z, ctx: Optional[TileContext] = None):
        return self.decoder(self.post_quant_conv(z), ctx)

    def forward(self, z, ctx: Optional[TileContext] = None):
        return self.decode(z, ctx)
