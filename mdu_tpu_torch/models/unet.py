"""The SD1.5 and SDXL UNet2DCondition in NCHW (counterpart of
``mdu_tpu/models/unet.py``).

Submodule names follow the flax modules (``down_0_res_0``, ``mid_attn``,
``up_1_upsample`` ...), so a flattened JAX parameter tree is this module's
``state_dict`` (see ``models/convert.py``). SD1.5: conv projections and a
fixed head count. SDXL: linear projections, head_dim 64, per-level
transformer depths and the ``text_time`` addition embedding (pooled text
and size micro-conditions). SD2.1-unCLIP: a CLIP image embedding (``adm``)
through the ``label_embed`` MLP into the time embedding. ControlNet and
StableSR residuals add to the skips and the mid state (``residuals``).

DeepCache (arXiv 2312.00858): ``cache_mode="write"`` also returns the
activation that enters the last ``cache_branch`` up-levels; ``"read"`` runs
only conv_in, the first ``cache_branch`` down levels and those up-levels,
resuming from that cached activation (``mdu_tpu/models/unet.py:290-429``).

``layout="NHWC"`` (``MDU_UNET_LAYOUT=NHWC`` through ``default_unet_layout``,
which the loaders read) runs the network on ``torch.channels_last``
activations: the input is converted once at entry and the output once at
exit (JAX's two transposes), ControlNet residuals once at their add sites;
the shapes, the ``state_dict`` and the call contract are those of NCHW. The
token reshapes around attention are views, and so are the permutes around
the fused conv, which takes every channel count the JAX planner fits. The
DeepCache feature stays channels-last, as JAX's is NHWC.
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
    addition_embed_type: Optional[str] = None            # 'text_time' for SDXL
    addition_time_embed_dim: int = 256
    addition_pooled_dim: int = 1280
    num_time_ids: int = 6
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


def sd21_unet_config() -> UNetConfig:
    """SD2.x: 1024-wide OpenCLIP-H context, 64-channel heads, linear
    projections."""
    return UNetConfig(cross_attention_dim=1024, num_heads=None, head_dim=64,
                      use_linear_projection=True)


def sd21_unclip_unet_config(variant: str = "l") -> UNetConfig:
    """SD2.1-unCLIP: SD2.1 with the CLIP image-embedding head, ``adm`` 1536
    wide for the ViT-L variant ("l") and 2048 for ViT-H ("h")."""
    return UNetConfig(cross_attention_dim=1024, num_heads=None, head_dim=64,
                      use_linear_projection=True,
                      adm_in_channels=1536 if variant == "l" else 2048)


def sdxl_unet_config() -> UNetConfig:
    return UNetConfig(
        block_out_channels=(320, 640, 1280), cross_attention_dim=2048,
        num_heads=None, head_dim=64, transformer_layers=(0, 2, 10),
        use_linear_projection=True, addition_embed_type="text_time")


def default_unet_layout() -> str:
    """The layout of a newly built UNet: ``MDU_UNET_LAYOUT`` (``NCHW`` by
    default, or ``NHWC``; any other value raises), as
    ``mdu_tpu/models/unet.py:87-101`` reads it."""
    return flags.unet_layout()


def tiny_unet_config() -> UNetConfig:
    """Small SD1.5-shaped config for tests (full depth, thin width)."""
    return UNetConfig(block_out_channels=(8, 16, 16, 16), cross_attention_dim=16,
                      num_heads=2, transformer_layers=(1, 1, 1, 0), norm_num_groups=4)


def tiny_sdxl_unet_config() -> UNetConfig:
    return UNetConfig(block_out_channels=(8, 16, 16), cross_attention_dim=16,
                      num_heads=None, head_dim=8, transformer_layers=(0, 1, 2),
                      use_linear_projection=True, addition_embed_type="text_time",
                      addition_time_embed_dim=8, addition_pooled_dim=16, norm_num_groups=4)


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
        C = channels
        self.linear = cfg.use_linear_projection
        self.norm = GroupNorm(C, cfg.norm_num_groups, eps=1e-6, dtype=dtype)
        if self.linear:
            self.proj_in = Linear(C, C, dtype=dtype)
        else:
            self.proj_in = Conv2D(C, C, kernel_size=(1, 1), padding=0, dtype=dtype)
        for d in range(depth):
            self.add_module(f"block_{d}", BasicTransformerBlock(
                C, cfg.heads_for(C), cfg.cross_attention_dim, dtype=dtype))
        if self.linear:
            self.proj_out = Linear(C, C, dtype=dtype)
        else:
            self.proj_out = Conv2D(C, C, kernel_size=(1, 1), padding=0, dtype=dtype)
        self.depth = depth

    def forward(self, x, context):
        B, C, H, W = x.shape
        h = self.norm(x)
        if self.norm.layout == "NHWC":
            # channels-last: the token reshapes are views
            def to_tokens(t):
                return t.permute(0, 2, 3, 1).reshape(B, H * W, C)

            def from_tokens(t):
                return t.reshape(B, H, W, C).permute(0, 3, 1, 2)
        else:
            def to_tokens(t):
                return t.reshape(B, C, H * W).transpose(1, 2)

            def from_tokens(t):
                return t.transpose(1, 2).reshape(B, C, H, W)
        h = self.proj_in(to_tokens(h)) if self.linear else to_tokens(self.proj_in(h))
        for d in range(self.depth):
            h = getattr(self, f"block_{d}")(h, context)
        h = from_tokens(self.proj_out(h)) if self.linear else self.proj_out(from_tokens(h))
        return x + h


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
            if self.conv.layout == "NHWC":
                x = x.contiguous(memory_format=torch.channels_last)
        elif self.conv.layout == "NHWC":
            xh = x.permute(0, 2, 3, 1)
            x = xh.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2).permute(0, 3, 1, 2)
        else:
            x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return self.conv(x)


class UNet2DCondition(nn.Module):
    def __init__(self, cfg: UNetConfig, dtype: torch.dtype = torch.float32,
                 layout: str = "NCHW"):
        super().__init__()
        if cfg.addition_embed_type not in (None, "text_time"):
            raise ValueError(f"unknown addition_embed_type {cfg.addition_embed_type!r}")
        if layout not in ("NCHW", "NHWC"):
            raise ValueError(f"layout must be NCHW or NHWC, got {layout!r}")
        self.cfg = cfg
        self.dtype = dtype
        bc = cfg.block_out_channels
        ted = cfg.time_embed_dim
        L = len(bc)
        g = cfg.norm_num_groups
        self.time_embed_1 = Linear(bc[0], ted, dtype=dtype)
        self.time_embed_2 = Linear(ted, ted, dtype=dtype)
        if cfg.addition_embed_type == "text_time":
            add_in = cfg.addition_pooled_dim + cfg.num_time_ids * cfg.addition_time_embed_dim
            self.add_embed_1 = Linear(add_in, ted, dtype=dtype)
            self.add_embed_2 = Linear(ted, ted, dtype=dtype)
        if cfg.adm_in_channels is not None:
            self.label_embed_1 = Linear(cfg.adm_in_channels, ted, dtype=dtype)
            self.label_embed_2 = Linear(ted, ted, dtype=dtype)
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
        self.layout = layout
        for m in self.modules():
            if isinstance(m, (Conv2D, GroupNorm)):
                m.layout = layout

    def forward(self, x, timesteps, context, added_cond: Optional[dict] = None,
                residuals: Optional[tuple] = None, cache: Optional[torch.Tensor] = None,
                cache_mode: Optional[str] = None, cache_branch: int = 1):
        """x [B, C, H, W]; timesteps [B]; context [B, L, D] -> [B, C, H, W].
        ``added_cond``: SDXL's {"text_embeds": [B, pooled], "time_ids": [B, 6]};
        unCLIP's {"adm": [B, adm_in_channels]}. ``residuals``: a ControlNet's
        or StableSR's (down_residuals, mid_residual), added to the skips and
        to the mid state (diffusers semantics); a read pass has only the
        shallow skips, and ``zip`` pairs them with the first residuals, as
        in the JAX package. ``cache_mode`` "write" returns (out, feature);
        "read" takes ``cache`` in place of the deep path."""
        cfg = self.cfg
        bc = cfg.block_out_channels
        L = len(bc)
        if cache_mode not in (None, "write", "read"):
            raise ValueError(f"unknown cache_mode {cache_mode!r}")
        read = cache_mode == "read"
        if cache_mode is not None and not (1 <= cache_branch <= L - 1):
            raise ValueError(f"cache_branch must be in [1, {L - 1}]")
        temb = timestep_embedding(timesteps, bc[0])
        temb = self.time_embed_2(silu(self.time_embed_1(temb)))
        if cfg.addition_embed_type == "text_time":
            temb = temb + text_time_embedding(self, cfg, added_cond, x.shape[0])
        if cfg.adm_in_channels is not None:
            if added_cond is None or added_cond.get("adm") is None:
                raise ValueError("an unCLIP UNet needs added_cond['adm'] (cond['adm'])")
            lab = added_cond["adm"].to(temb.dtype)
            temb = temb + self.label_embed_2(silu(self.label_embed_1(lab)))

        nhwc = self.layout == "NHWC"
        if nhwc:
            x = x.contiguous(memory_format=torch.channels_last)
        h = self.conv_in(x)
        skips = [h]
        for i in range(cache_branch if read else L):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{i}_res_{j}")(h, temb)
                if cfg.transformer_layers[i] > 0:
                    h = getattr(self, f"down_{i}_attn_{j}")(h, context)
                skips.append(h)
            # a read pass skips the deepest shallow level's downsample: only
            # the deep path consumes it
            if i != L - 1 and not (read and i == cache_branch - 1):
                h = getattr(self, f"down_{i}_downsample")(h)
                skips.append(h)

        if residuals is not None:
            down_res, mid_res = residuals
            if nhwc:                        # the adapters' residuals come NCHW
                down_res = [r.contiguous(memory_format=torch.channels_last) for r in down_res]
                mid_res = mid_res.contiguous(memory_format=torch.channels_last)
            skips = [s + r for s, r in zip(skips, down_res)]

        if read:
            h = cache.contiguous(memory_format=torch.channels_last) if nhwc else cache
        else:
            h = self.mid_res_0(h, temb)
            h = self.mid_attn(h, context)
            h = self.mid_res_1(h, temb)
            if residuals is not None:
                h = h + mid_res

        feature = None
        for i in range(L - cache_branch if read else 0, L):
            level = L - 1 - i
            for j in range(cfg.layers_per_block + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = getattr(self, f"up_{i}_res_{j}")(h, temb)
                if cfg.transformer_layers[level] > 0:
                    h = getattr(self, f"up_{i}_attn_{j}")(h, context)
            if i != L - 1:
                nxt = skips[-1]
                h = getattr(self, f"up_{i}_upsample")(h, nxt.shape[2:])
                if cache_mode == "write" and i == L - cache_branch - 1:
                    feature = h

        h = self.norm_out(h)
        out = self.conv_out(silu(h))
        if nhwc:
            out = out.contiguous()
        return (out, feature) if cache_mode == "write" else out


def text_time_embedding(module: nn.Module, cfg: UNetConfig, added_cond: Optional[dict],
                        batch: int):
    """SDXL's addition embedding: ``add_embed_2(silu(add_embed_1([text_embeds,
    timestep_embedding(time_ids)])))`` of ``module``, in fp32 before the
    first layer casts it (``mdu_tpu/models/unet.py:330-338``)."""
    if added_cond is None or added_cond.get("text_embeds") is None:
        raise ValueError("an SDXL UNet needs added_cond text_embeds (cond['vector'])")
    tids = added_cond["time_ids"].reshape(-1)
    tid_emb = timestep_embedding(tids, cfg.addition_time_embed_dim).reshape(batch, -1)
    add = torch.cat([added_cond["text_embeds"].float(), tid_emb], dim=-1)
    return module.add_embed_2(silu(module.add_embed_1(add)))
