"""The SD VAE, encoder and decoder (counterpart of ``mdu_tpu/models/vae.py``,
with its module names, so that parameters carry across).

Every GroupNorm takes an optional ``TileContext``: with one, its statistics
pool across the lockstep-batched tiles, which makes the tiled VAE exact. It
also takes an optional ``GroupNormStats``, which records its statistics or
injects recorded ones (the fast tiled modes).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.attention import multi_head_attention
from ..ops.groupnorm import GroupNormStats
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

    def forward(self, x, ctx: Optional[TileContext] = None,
                stats: Optional[GroupNormStats] = None):
        h = self.conv1(silu(self.norm1(x, ctx, stats=stats)))
        h = self.conv2(silu(self.norm2(h, ctx, stats=stats)))
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

    def attend(self, h):
        """Attention over an already normalised input (no residual)."""
        B, C, H, W = h.shape
        tokens = h.reshape(B, C, H * W).transpose(1, 2)
        out = multi_head_attention(self.to_q(tokens), self.to_k(tokens),
                                   self.to_v(tokens), num_heads=1,
                                   q_chunk=self.q_chunk)
        return self.to_out(out).transpose(1, 2).reshape(B, C, H, W)

    def forward(self, x, ctx: Optional[TileContext] = None,
                stats: Optional[GroupNormStats] = None):
        return x + self.attend(self.group_norm(x, ctx, stats=stats))


class Downsample(nn.Module):
    """Asymmetric (0, 1) x (0, 1) pad and a stride-2 conv (CompVis /
    diffusers VAE)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2D(channels, channels, strides=(2, 2), padding=((0, 1), (0, 1)),
                           dtype=dtype)

    def forward(self, x):
        return self.conv(x)


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

    def forward(self, x, ctx: Optional[TileContext] = None,
                stats: Optional[GroupNormStats] = None):
        x = self.block_1(x, ctx, stats)
        x = self.attn_1(x, ctx, stats)
        return self.block_2(x, ctx, stats)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        chans = cfg.block_out_channels
        self.conv_in = Conv2D(cfg.in_channels, chans[0], dtype=dtype)
        in_ch = chans[0]
        for i, ch in enumerate(chans):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_block_{j}", ResnetBlock(cfg, in_ch, ch, dtype))
                in_ch = ch
            if i != len(chans) - 1:
                self.add_module(f"down_{i}_downsample", Downsample(ch, dtype))
        self.mid = MidBlock(cfg, chans[-1], dtype)
        self.norm_out = GroupNorm(chans[-1], cfg.norm_num_groups, dtype=dtype)
        self.conv_out = Conv2D(chans[-1], 2 * cfg.latent_channels, dtype=dtype)

    def forward(self, x, ctx: Optional[TileContext] = None,
                stats: Optional[GroupNormStats] = None):
        cfg = self.cfg
        n = len(cfg.block_out_channels)
        h = self.conv_in(x)
        for i in range(n):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{i}_block_{j}")(h, ctx, stats)
            if i != n - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
        h = self.mid(h, ctx, stats)
        return self.conv_out(silu(self.norm_out(h, ctx, stats=stats)))


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

    def forward(self, z, ctx: Optional[TileContext] = None,
                stats: Optional[GroupNormStats] = None):
        cfg = self.cfg
        n = len(cfg.block_out_channels)
        h = self.mid(self.conv_in(z), ctx, stats)
        for i in range(n):
            for j in range(cfg.layers_per_block + 1):
                h = getattr(self, f"up_{i}_block_{j}")(h, ctx, stats)
            if i != n - 1:
                h = getattr(self, f"up_{i}_upsample")(h)
        return self.conv_out(silu(self.norm_out(h, ctx, stats=stats)))


class AutoencoderKL(nn.Module):
    """The SD VAE: ``encoder`` and ``quant_conv`` give the diagonal gaussian
    moments [B, 2 * latent, h, w]; ``post_quant_conv`` and ``decoder``
    decode."""

    def __init__(self, cfg: VAEConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.encoder = Encoder(cfg, dtype)
        self.decoder = Decoder(cfg, dtype)
        self.quant_conv = Conv2D(2 * cfg.latent_channels, 2 * cfg.latent_channels,
                                 kernel_size=(1, 1), padding=0, dtype=dtype)
        self.post_quant_conv = Conv2D(cfg.latent_channels, cfg.latent_channels,
                                      kernel_size=(1, 1), padding=0, dtype=dtype)

    def encode_moments(self, x, ctx: Optional[TileContext] = None,
                       stats: Optional[GroupNormStats] = None):
        return self.quant_conv(self.encoder(x, ctx, stats))

    def decode(self, z, ctx: Optional[TileContext] = None,
               stats: Optional[GroupNormStats] = None):
        return self.decoder(self.post_quant_conv(z), ctx, stats)

    def forward(self, z, ctx: Optional[TileContext] = None):
        return self.decode(z, ctx)


def sample_from_moments(moments, noise=None, generator: Optional[torch.Generator] = None):
    """Diagonal gaussian sample from [B, 2C, H, W] (mean, logvar) moments:
    ``mean + exp(logvar / 2) * noise``, logvar clipped to [-30, 20]. ``noise``
    (the mean's shape) is given, or drawn from ``generator`` in the moments'
    dtype, as the JAX package draws it."""
    mean, logvar = moments.chunk(2, dim=1)
    std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                            device=mean.device)
    return mean + std * torch.as_tensor(noise, dtype=mean.dtype, device=mean.device)
