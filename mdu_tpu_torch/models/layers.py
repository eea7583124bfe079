"""Shared building blocks (counterpart of ``mdu_tpu/models/layers.py``).

Parameters keep torch names and layouts, as the JAX package does: conv
``weight`` OIHW, linear ``weight`` [out, in]. Activations are NCHW. Each
module computes in its ``dtype``: inputs and weights are cast to it, while
GroupNorm and LayerNorm compute their statistics in fp32. ``Conv2D`` and
``GroupNorm`` take the fused kernels under the JAX package's flags
``MDU_FUSED_CONV`` and ``MDU_FUSED_GN`` (``flags.py``), on the same layers
as the JAX package does.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .. import flags
from ..ops.groupnorm import group_norm_affine
from ..ops.kernels import (conv3x3_plan_fits, fused_conv3x3, fused_group_norm,
                           pack_conv3x3_weight)
from ..ops.tile_context import TileContext, tile_group_norm

FUSED_GN_MAX_BYTES = 4 * 2 ** 20   # (C/G)*H*W*4 cap of the JAX dispatch


class Conv2D(nn.Module):
    """2-D conv over NCHW with an OIHW ``weight``. ``padding`` is an int or
    ((top, bottom), (left, right)).

    ``scale`` / ``shift`` ([B, C_in] fp32, a folded GroupNorm affine) ask
    for conv(silu(x * scale + shift)): the fused kernel where the JAX
    package's ``fused_ok`` holds (``mdu_tpu/models/layers.py:128-136``),
    else the fp32 elementwise chain before the ordinary conv. The kernel's
    re-laid-out weight is derived from ``weight`` once per weight and dtype;
    it is not part of the state dict."""

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
        self._packed = None
        self._packed_key = None

    def _fused_ok(self, x) -> bool:
        Co, C, kh, kw = self.weight.shape
        H, W = x.shape[2], x.shape[3]
        return ((kh, kw) == (3, 3) and self.strides == (1, 1) and self.padding == 1
                and H * W >= 64 and max(C, Co) <= 640 and flags.fused_conv()
                and conv3x3_plan_fits(H, W, C, Co))

    def _packed_weight(self):
        w = self.weight
        key = (w.data_ptr(), w._version, w.device, self.dtype)
        if self._packed_key != key:
            self._packed = pack_conv3x3_weight(w.to(self.dtype).permute(2, 3, 1, 0))
            self._packed_key = key
        return self._packed

    def forward(self, x, scale=None, shift=None):
        if scale is not None and self._fused_ok(x):
            xh = x.to(self.dtype).permute(0, 2, 3, 1).contiguous()        # NHWC
            wh = self.weight.to(self.dtype).permute(2, 3, 1, 0)           # HWIO
            y = fused_conv3x3(xh, wh, scale, shift, fuse_act=True,
                              packed=self._packed_weight()).permute(0, 3, 1, 2)
            if self.bias is not None:
                y = y + self.bias.to(self.dtype).reshape(1, -1, 1, 1)
            return y
        if scale is not None:
            xf = x.float() * scale[:, :, None, None] + shift[:, :, None, None]
            x = xf * torch.sigmoid(xf)
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
    lockstep-batched tiles of a ``TileContext``. ``affine_only`` returns the
    folded per-(batch, channel) (a, b) for a fused consumer. Under
    ``MDU_FUSED_GN`` a per-sample norm whose group fits the JAX cap runs the
    fused kernel."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, ctx: Optional[TileContext] = None, affine_only: bool = False):
        if affine_only:
            if ctx is not None:
                raise ValueError("affine_only takes per-sample statistics only")
            return group_norm_affine(x, self.num_groups, self.weight, self.bias, self.eps)
        if ctx is None and flags.fused_group_norm():
            B, C, H, W = x.shape
            if C // self.num_groups * H * W * 4 <= FUSED_GN_MAX_BYTES:
                return fused_group_norm(x.contiguous(), self.num_groups, self.weight,
                                        self.bias, self.eps).to(self.dtype)
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
