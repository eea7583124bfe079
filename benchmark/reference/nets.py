"""Plain PyTorch forms of the Stable Diffusion UNet (SD1.5 and SDXL) and of the
SD VAE, written from the published architectures in float32.

They judge the program; they never import it. Parameter names follow the
layout of the program's ``state_dict`` (``down_0_res_0.conv1.weight``,
``mid_attn.block_0.attn1.to_q.weight``, ``decoder.up_1_block_0.norm1.bias``
...), so one set of weights, drawn by the benchmark from the run's seed, is
loaded into both sides.

Every product goes through a ``Precision``:

* ``Precision("fp32")``: float32 operands and accumulation (the caller turns
  TF32 off), the plain reference;
* ``Precision("fp8")``: the control, each product's operands (activations,
  weights, and attention's q, k, v) rounded to float8 e4m3 with one scale a
  tensor, accumulated in float32: the precision below the configuration's
  bfloat16;
* ``Precision("count")``: attention runs no product and records its
  operations instead, ``4 * B * H * Lq * Lk * D``; the convolutions and
  linears run, on the meta device, under ``FlopCounterMode``.

GroupNorm pools its statistics across the lockstep tiles of the exact tiled
VAE when it is handed a ``TileMasks`` (each tile's owned region), as the
reference implementation of Tiled VAE does (statistics of the owned pixels
of every tile, E[x^2] - mean^2, float64 sums here).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0          # the largest finite float8 e4m3 value


class Precision:
    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8", "count"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind
        self.attention_flops = 0.0

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind != "fp8":
            return t
        scale = t.abs().amax().float().clamp(min=1e-30) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def conv(self, x, w, b=None, stride=1, padding=0):
        return F.conv2d(self.q(x), self.q(w), b, stride=stride, padding=padding)

    def attention(self, q, k, v):
        """softmax(q k^T / sqrt(D)) v over [B, H, L, D]."""
        B, H, Lq, D = q.shape
        if self.kind == "count":
            self.attention_flops += 4.0 * B * H * Lq * k.shape[2] * D
            return torch.zeros_like(q)
        q, k, v = self.q(q), self.q(k), self.q(v)
        if q.is_cuda:
            return F.scaled_dot_product_attention(q, k, v)
        scores = torch.matmul(q, k.transpose(-1, -2)) * D ** -0.5
        return torch.matmul(torch.softmax(scores, dim=-1), v)


# ----------------------------------------------------------------- layers


class Conv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1, padding=1,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride, self.padding = stride, padding

    def forward(self, p: Precision, x):
        if isinstance(self.padding, tuple):          # (left, right, top, bottom)
            x = F.pad(x, self.padding)
            return p.conv(x, self.weight, self.bias, self.stride, 0)
        return p.conv(x, self.weight, self.bias, self.stride, self.padding)


class Lin(nn.Module):
    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, p: Precision, x):
        return p.linear(x, self.weight, self.bias)


@dataclass
class TileMasks:
    """Owned regions of the lockstep tiles, [T, 1, h, w] at the tiles' input
    resolution; ``at(h, w)`` derives them at any integer up- or down-sampled
    resolution."""

    masks: torch.Tensor

    def at(self, h: int, w: int) -> torch.Tensor:
        bh, bw = self.masks.shape[-2:]
        if (h, w) == (bh, bw):
            return self.masks
        if bh % h == 0 and bw % w == 0:
            return self.masks[:, :, ::bh // h, ::bw // w]
        if h % bh == 0 and w % bw == 0:
            return self.masks.repeat_interleave(h // bh, 2).repeat_interleave(w // bw, 3)
        raise ValueError(f"mask resolution {(h, w)} against {(bh, bw)}")


class Norm(nn.Module):
    """GroupNorm (``groups`` set) or LayerNorm (``groups`` None) with float32
    statistics."""

    def __init__(self, channels: int, groups: Optional[int], eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.groups, self.eps = groups, eps

    def forward(self, x, tiles: Optional[TileMasks] = None):
        if self.groups is None:
            return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)
        if tiles is None:
            return F.group_norm(x, self.groups, self.weight, self.bias, self.eps)
        return pooled_group_norm(x, self.groups, self.weight, self.bias, self.eps,
                                 tiles.at(x.shape[2], x.shape[3]))


def pooled_group_norm(x, G: int, weight, bias, eps: float, masks):
    """GroupNorm of [T*B, C, h, w] lockstep tiles (tile-major) whose statistics
    are those of every tile's owned pixels together; one tile at a time, so
    that no second full-size temporary lives."""
    TB, C, h, w = x.shape
    T = masks.shape[0]
    B = TB // T
    s1 = torch.zeros(B, G, dtype=torch.float64, device=x.device)
    s2 = torch.zeros_like(s1)
    n = torch.zeros_like(s1)
    for t in range(T):
        xt = x[t * B:(t + 1) * B].reshape(B, G, C // G, h, w).double()
        m = masks[t].reshape(1, 1, 1, h, w).double()
        s1 += (xt * m).sum(dim=(2, 3, 4))
        s2 += (xt * xt * m).sum(dim=(2, 3, 4))
        n += m.sum() * (C // G)
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps).float()
    mean = mean.float()
    out = torch.empty_like(x)
    for t in range(T):
        xt = x[t * B:(t + 1) * B].reshape(B, G, C // G, h, w)
        o = (xt - mean[:, :, None, None, None]) * rstd[:, :, None, None, None]
        out[t * B:(t + 1) * B] = (o.reshape(B, C, h, w) * weight[None, :, None, None]
                                  + bias[None, :, None, None])
    return out


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """Sinusoidal embedding, cos first (diffusers' flip_sin_to_cos, shift 0)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


# ------------------------------------------------------------------- UNet


@dataclass(frozen=True)
class UNetSpec:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    num_heads: Optional[int] = 8
    head_dim: Optional[int] = None
    transformer_layers: Tuple[int, ...] = (1, 1, 1, 0)
    use_linear_projection: bool = False
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: int = 256
    addition_pooled_dim: int = 1280
    num_time_ids: int = 6
    norm_num_groups: int = 32

    @staticmethod
    def from_json(d: dict) -> "UNetSpec":
        d = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
        return UNetSpec(**d)

    def heads(self, channels: int) -> int:
        return channels // self.head_dim if self.head_dim else self.num_heads


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: Optional[int] = None):
        super().__init__()
        cdim = context_dim or dim
        self.heads = heads
        self.to_q = Lin(dim, dim, bias=False)
        self.to_k = Lin(cdim, dim, bias=False)
        self.to_v = Lin(cdim, dim, bias=False)
        self.to_out = Lin(dim, dim)

    def forward(self, p: Precision, x, context=None):
        ctx = x if context is None else context
        q, k, v = self.to_q(p, x), self.to_k(p, ctx), self.to_v(p, ctx)
        B, Lq, C = q.shape
        H = self.heads

        def split(t):
            return t.reshape(B, t.shape[1], H, C // H).transpose(1, 2)

        out = p.attention(split(q), split(k), split(v))
        return self.to_out(p, out.transpose(1, 2).reshape(B, Lq, C))


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = Lin(dim, dim * 8)
        self.out = Lin(dim * 4, dim)

    def forward(self, p: Precision, x):
        h, gate = self.proj(p, x).chunk(2, dim=-1)
        return self.out(p, h * F.gelu(gate, approximate="tanh"))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.norm1, self.norm2, self.norm3 = (Norm(dim, None, 1e-5) for _ in range(3))
        self.attn1 = Attention(dim, heads)
        self.attn2 = Attention(dim, heads, context_dim)
        self.ff = FeedForward(dim)

    def forward(self, p: Precision, x, context):
        x = x + self.attn1(p, self.norm1(x))
        x = x + self.attn2(p, self.norm2(x), context)
        return x + self.ff(p, self.norm3(x))


class Transformer2D(nn.Module):
    def __init__(self, spec: UNetSpec, C: int, depth: int):
        super().__init__()
        self.linear = spec.use_linear_projection
        self.norm = Norm(C, spec.norm_num_groups, 1e-6)
        self.proj_in = Lin(C, C) if self.linear else Conv(C, C, 1, padding=0)
        self.depth = depth
        for d in range(depth):
            self.add_module(f"block_{d}", TransformerBlock(C, spec.heads(C),
                                                           spec.cross_attention_dim))
        self.proj_out = Lin(C, C) if self.linear else Conv(C, C, 1, padding=0)

    def forward(self, p: Precision, x, context):
        B, C, H, W = x.shape
        h = self.norm(x)
        if self.linear:
            h = self.proj_in(p, h.reshape(B, C, H * W).transpose(1, 2))
        else:
            h = self.proj_in(p, h).reshape(B, C, H * W).transpose(1, 2)
        for d in range(self.depth):
            h = getattr(self, f"block_{d}")(p, h, context)
        if self.linear:
            h = self.proj_out(p, h).transpose(1, 2).reshape(B, C, H, W)
        else:
            h = self.proj_out(p, h.transpose(1, 2).reshape(B, C, H, W))
        return x + h


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, temb: int, groups: int):
        super().__init__()
        self.norm1 = Norm(cin, groups, 1e-5)
        self.conv1 = Conv(cin, cout)
        self.norm2 = Norm(cout, groups, 1e-5)
        self.conv2 = Conv(cout, cout)
        self.time_emb_proj = Lin(temb, cout)
        self.conv_shortcut = Conv(cin, cout, 1, padding=0) if cin != cout else None

    def forward(self, p: Precision, x, temb):
        h = self.conv1(p, F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(p, F.silu(temb))[:, :, None, None]
        h = self.conv2(p, F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(p, x)
        return x + h


class _ConvHolder(nn.Module):
    def __init__(self, conv: Conv):
        super().__init__()
        self.conv = conv


class UNet(nn.Module):
    def __init__(self, spec: UNetSpec):
        super().__init__()
        self.spec = spec
        bc, L, g = spec.block_out_channels, len(spec.block_out_channels), spec.norm_num_groups
        ted = bc[0] * 4
        self.time_embed_1 = Lin(bc[0], ted)
        self.time_embed_2 = Lin(ted, ted)
        if spec.addition_embed_type == "text_time":
            add_in = spec.addition_pooled_dim + spec.num_time_ids * spec.addition_time_embed_dim
            self.add_embed_1 = Lin(add_in, ted)
            self.add_embed_2 = Lin(ted, ted)
        self.conv_in = Conv(spec.in_channels, bc[0])
        skips, ch = [bc[0]], bc[0]
        for i in range(L):
            for j in range(spec.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", ResBlock(ch, bc[i], ted, g))
                ch = bc[i]
                if spec.transformer_layers[i] > 0:
                    self.add_module(f"down_{i}_attn_{j}",
                                    Transformer2D(spec, ch, spec.transformer_layers[i]))
                skips.append(ch)
            if i != L - 1:
                self.add_module(f"down_{i}_downsample", _ConvHolder(Conv(ch, ch, stride=2)))
                skips.append(ch)
        mid_depth = spec.transformer_layers[-1] or 1
        self.mid_res_0 = ResBlock(ch, ch, ted, g)
        self.mid_attn = Transformer2D(spec, ch, mid_depth)
        self.mid_res_1 = ResBlock(ch, ch, ted, g)
        for i in range(L):
            level = L - 1 - i
            for j in range(spec.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}", ResBlock(ch + skips.pop(), bc[level], ted, g))
                ch = bc[level]
                if spec.transformer_layers[level] > 0:
                    self.add_module(f"up_{i}_attn_{j}",
                                    Transformer2D(spec, ch, spec.transformer_layers[level]))
            if i != L - 1:
                self.add_module(f"up_{i}_upsample", _ConvHolder(Conv(ch, ch)))
        self.norm_out = Norm(ch, g, 1e-5)
        self.conv_out = Conv(ch, spec.out_channels)

    def forward(self, p: Precision, x, t, context, text_embeds=None, time_ids=None):
        """x [B, 4, h, w], t [B] fractional timesteps, context [B, 77, D];
        SDXL: text_embeds [B, pooled], time_ids [B, 6]."""
        spec = self.spec
        L = len(spec.block_out_channels)
        temb = timestep_embedding(t, spec.block_out_channels[0])
        temb = self.time_embed_2(p, F.silu(self.time_embed_1(p, temb)))
        if spec.addition_embed_type == "text_time":
            B = x.shape[0]
            tid = timestep_embedding(time_ids.reshape(-1), spec.addition_time_embed_dim)
            add = torch.cat([text_embeds.float(), tid.reshape(B, -1)], dim=-1)
            temb = temb + self.add_embed_2(p, F.silu(self.add_embed_1(p, add)))
        h = self.conv_in(p, x)
        skips = [h]
        for i in range(L):
            for j in range(spec.layers_per_block):
                h = getattr(self, f"down_{i}_res_{j}")(p, h, temb)
                if spec.transformer_layers[i] > 0:
                    h = getattr(self, f"down_{i}_attn_{j}")(p, h, context)
                skips.append(h)
            if i != L - 1:
                h = getattr(self, f"down_{i}_downsample").conv(p, h)
                skips.append(h)
        h = self.mid_res_0(p, h, temb)
        h = self.mid_attn(p, h, context)
        h = self.mid_res_1(p, h, temb)
        for i in range(L):
            level = L - 1 - i
            for j in range(spec.layers_per_block + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = getattr(self, f"up_{i}_res_{j}")(p, h, temb)
                if spec.transformer_layers[level] > 0:
                    h = getattr(self, f"up_{i}_attn_{j}")(p, h, context)
            if i != L - 1:
                size = tuple(skips[-1].shape[2:])
                if size == (2 * h.shape[2], 2 * h.shape[3]):
                    h = F.interpolate(h, scale_factor=2.0, mode="nearest")
                else:
                    h = F.interpolate(h, size=size, mode="nearest-exact")
                h = getattr(self, f"up_{i}_upsample").conv(p, h)
        return self.conv_out(p, F.silu(self.norm_out(h)))


# -------------------------------------------------------------------- VAE


@dataclass(frozen=True)
class VAESpec:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215

    @staticmethod
    def from_json(d: dict) -> "VAESpec":
        d = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
        return VAESpec(**d)


class VResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, g: int):
        super().__init__()
        self.norm1 = Norm(cin, g, 1e-6)
        self.conv1 = Conv(cin, cout)
        self.norm2 = Norm(cout, g, 1e-6)
        self.conv2 = Conv(cout, cout)
        self.conv_shortcut = Conv(cin, cout, 1, padding=0) if cin != cout else None

    def forward(self, p: Precision, x, tiles=None):
        h = self.conv1(p, F.silu(self.norm1(x, tiles)))
        h = self.conv2(p, F.silu(self.norm2(h, tiles)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(p, x)
        return x + h


class VAttn(nn.Module):
    def __init__(self, C: int, g: int):
        super().__init__()
        self.group_norm = Norm(C, g, 1e-6)
        self.to_q, self.to_k, self.to_v, self.to_out = (Lin(C, C) for _ in range(4))

    def forward(self, p: Precision, x, tiles=None):
        B, C, H, W = x.shape
        tok = self.group_norm(x, tiles).reshape(B, C, H * W).transpose(1, 2)
        q, k, v = (m(p, tok)[:, None] for m in (self.to_q, self.to_k, self.to_v))
        out = self.to_out(p, p.attention(q, k, v)[:, 0])
        return x + out.transpose(1, 2).reshape(B, C, H, W)


class VMid(nn.Module):
    def __init__(self, C: int, g: int):
        super().__init__()
        self.block_1 = VResBlock(C, C, g)
        self.attn_1 = VAttn(C, g)
        self.block_2 = VResBlock(C, C, g)

    def forward(self, p, x, tiles=None):
        return self.block_2(p, self.attn_1(p, self.block_1(p, x, tiles), tiles), tiles)


class VEncoder(nn.Module):
    def __init__(self, spec: VAESpec):
        super().__init__()
        self.spec = spec
        ch, g = spec.block_out_channels, spec.norm_num_groups
        self.conv_in = Conv(spec.in_channels, ch[0])
        cin = ch[0]
        for i, c in enumerate(ch):
            for j in range(spec.layers_per_block):
                self.add_module(f"down_{i}_block_{j}", VResBlock(cin, c, g))
                cin = c
            if i != len(ch) - 1:
                self.add_module(f"down_{i}_downsample",
                                _ConvHolder(Conv(c, c, stride=2, padding=(0, 1, 0, 1))))
        self.mid = VMid(ch[-1], g)
        self.norm_out = Norm(ch[-1], g, 1e-6)
        self.conv_out = Conv(ch[-1], 2 * spec.latent_channels)

    def forward(self, p, x, tiles=None):
        spec, n = self.spec, len(self.spec.block_out_channels)
        h = self.conv_in(p, x)
        for i in range(n):
            for j in range(spec.layers_per_block):
                h = getattr(self, f"down_{i}_block_{j}")(p, h, tiles)
            if i != n - 1:
                h = getattr(self, f"down_{i}_downsample").conv(p, h)
        h = self.mid(p, h, tiles)
        return self.conv_out(p, F.silu(self.norm_out(h, tiles)))


class VDecoder(nn.Module):
    def __init__(self, spec: VAESpec):
        super().__init__()
        self.spec = spec
        ch, g = list(reversed(spec.block_out_channels)), spec.norm_num_groups
        self.conv_in = Conv(spec.latent_channels, ch[0])
        self.mid = VMid(ch[0], g)
        cin = ch[0]
        for i, c in enumerate(ch):
            for j in range(spec.layers_per_block + 1):
                self.add_module(f"up_{i}_block_{j}", VResBlock(cin, c, g))
                cin = c
            if i != len(ch) - 1:
                self.add_module(f"up_{i}_upsample", _ConvHolder(Conv(c, c)))
        self.norm_out = Norm(cin, g, 1e-6)
        self.conv_out = Conv(cin, spec.out_channels)

    def forward(self, p, z, tiles=None):
        spec, n = self.spec, len(self.spec.block_out_channels)
        h = self.mid(p, self.conv_in(p, z), tiles)
        for i in range(n):
            for j in range(spec.layers_per_block + 1):
                h = getattr(self, f"up_{i}_block_{j}")(p, h, tiles)
            if i != n - 1:
                h = F.interpolate(h, scale_factor=2.0, mode="nearest")
                h = getattr(self, f"up_{i}_upsample").conv(p, h)
        return self.conv_out(p, F.silu(self.norm_out(h, tiles)))


class VAE(nn.Module):
    def __init__(self, spec: VAESpec):
        super().__init__()
        self.spec = spec
        self.encoder = VEncoder(spec)
        self.decoder = VDecoder(spec)
        c = spec.latent_channels
        self.quant_conv = Conv(2 * c, 2 * c, 1, padding=0)
        self.post_quant_conv = Conv(c, c, 1, padding=0)

    def encode_moments(self, p, x, tiles=None):
        return self.quant_conv(p, self.encoder(p, x, tiles))

    def decode(self, p, z, tiles=None):
        return self.decoder(p, self.post_quant_conv(p, z), tiles)


def parameter_shapes(module: nn.Module) -> List[Tuple[str, Tuple[int, ...]]]:
    return [(name, tuple(t.shape)) for name, t in module.state_dict().items()]


def load(module: nn.Module, weights, dtype=torch.float32, device=None) -> nn.Module:
    """The weights, as float32 copies, into ``module`` (built on the meta
    device), every name required."""
    sd = {k: v.to(device=device or v.device, dtype=dtype) for k, v in weights.items()}
    module.load_state_dict(sd, strict=True, assign=True)
    return module.eval().requires_grad_(False)


def build(kind: str, spec_json: dict, device="meta") -> nn.Module:
    with torch.device(device):
        if kind == "unet":
            return UNet(UNetSpec.from_json(spec_json))
        return VAE(VAESpec.from_json(spec_json))


def shapes_of(kind: str, spec_json: dict) -> Sequence[Tuple[str, Tuple[int, ...]]]:
    return parameter_shapes(build(kind, spec_json))
