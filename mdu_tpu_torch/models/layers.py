"""Shared building blocks (counterpart of ``mdu_tpu/models/layers.py``).

Parameters keep torch names and layouts, as the JAX package does: conv
``weight`` OIHW, linear ``weight`` [out, in]. Activations are NCHW. Each
module computes in its ``dtype``: inputs and weights are cast to it, while
GroupNorm and LayerNorm compute their statistics in fp32.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.tile_context import TileContext, tile_group_norm


class Conv2D(nn.Module):
    """2-D conv over NCHW with an OIHW ``weight``. ``padding`` is an int or
    ((top, bottom), (left, right))."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1),
                 padding: Union[int, Sequence[Tuple[int, int]]] = 1,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.strides = tuple(strides)
        self.padding = padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_channels, *kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x):
        x = x.to(self.dtype)
        w = self.weight.to(self.dtype)
        b = self.bias.to(self.dtype) if self.bias is not None else None
        if isinstance(self.padding, int):
            return F.conv2d(x, w, b, stride=self.strides, padding=self.padding)
        (top, bottom), (left, right) = self.padding
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, w, b, stride=self.strides)


class Linear(nn.Module):
    """Dense layer with a ``[out, in]`` ``weight``."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x):
        b = self.bias.to(self.dtype) if self.bias is not None else None
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class GroupNorm(nn.Module):
    """GroupNorm with fp32 statistics: per sample, or pooled across the
    lockstep-batched tiles of a ``TileContext``."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, ctx: Optional[TileContext] = None):
        return tile_group_norm(x, self.num_groups, self.weight, self.bias, ctx,
                               self.eps).to(self.dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis: fp32, biased variance."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = (xf - mean) * torch.rsqrt(var + self.eps)
        return (out * self.weight + self.bias).to(self.dtype)


def silu(x):
    return F.silu(x)


def timestep_embedding(t, dim: int, max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True, shift: int = 0):
    """Sinusoidal timestep embedding [B] -> [B, dim] (diffusers convention)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / (half - shift))
    args = t.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb
