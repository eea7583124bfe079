"""CLIP text encoder (counterpart of ``mdu_tpu/models/clip.py``, with its
parameter names, so that weights carry across): SD1.x CLIP-L, SD2.x
OpenCLIP-H and SDXL's CLIP-L + OpenCLIP-bigG, one module by config.

  * SD1.5 CLIP-L/14 : 768 wide, 12 layers, quick_gelu, final-layer states
  * SD2.1 OpenCLIP-H: 1024 wide, 23 layers, gelu, the penultimate layer's
                      states LayerNormed
  * SDXL            : CLIP-L and OpenCLIP-bigG (1280 wide, 32 layers), both
                      the penultimate layer's raw states; bigG's pooled state
                      through ``text_projection``

The 77-token causal self-attention is a plain einsum softmax in the JAX
package, not a Pallas kernel; here it is ``F.scaled_dot_product_attention``
with ``is_causal``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import LayerNorm, Linear


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    hidden_act: str = "quick_gelu"        # quick_gelu (CLIP-L) | gelu (OpenCLIP)
    projection_dim: Optional[int] = None  # OpenCLIP text_projection (SDXL encoder 2)
    clip_skip: int = 1                    # 1 = final layer, 2 = penultimate, ...
    # A1111's clip skip LayerNorms the earlier layer's states (SD1, SD2);
    # SDXL's conditioners take hidden_states[-2] raw
    ln_penultimate: bool = True


def clip_l_config() -> CLIPTextConfig:
    return CLIPTextConfig()


def open_clip_h_config() -> CLIPTextConfig:
    return CLIPTextConfig(hidden_size=1024, num_layers=23, num_heads=16, hidden_act="gelu",
                          clip_skip=2)


def open_clip_bigg_config() -> CLIPTextConfig:
    return CLIPTextConfig(hidden_size=1280, num_layers=32, num_heads=20, hidden_act="gelu",
                          projection_dim=1280, clip_skip=2, ln_penultimate=False)


def tiny_clip_config() -> CLIPTextConfig:
    return CLIPTextConfig(vocab_size=1000, hidden_size=16, num_layers=2, num_heads=2,
                          max_length=16)


def _act(name: str, x):
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x, approximate="tanh")          # jax.nn.gelu's default


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        D = cfg.hidden_size
        self.cfg = cfg
        self.ln1 = LayerNorm(D, dtype=dtype)
        self.q = Linear(D, D, dtype=dtype)
        self.k = Linear(D, D, dtype=dtype)
        self.v = Linear(D, D, dtype=dtype)
        self.out = Linear(D, D, dtype=dtype)
        self.ln2 = LayerNorm(D, dtype=dtype)
        self.fc1 = Linear(D, 4 * D, dtype=dtype)
        self.fc2 = Linear(4 * D, D, dtype=dtype)

    def forward(self, x):
        h = self.ln1(x)
        B, L, D = h.shape
        Hn = self.cfg.num_heads

        def heads(t):
            return t.reshape(B, L, Hn, D // Hn).transpose(1, 2)

        att = F.scaled_dot_product_attention(heads(self.q(h)), heads(self.k(h)),
                                             heads(self.v(h)), is_causal=True)
        x = x + self.out(att.transpose(1, 2).reshape(B, L, D))
        h = _act(self.cfg.hidden_act, self.fc1(self.ln2(x)))
        return x + self.fc2(h)


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.token_embedding = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size))
        self.position_embedding = nn.Parameter(torch.empty(cfg.max_length, cfg.hidden_size))
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", CLIPLayer(cfg, dtype))
        self.ln_final = LayerNorm(cfg.hidden_size, dtype=dtype)
        self.text_projection = (Linear(cfg.hidden_size, cfg.projection_dim, use_bias=False,
                                       dtype=dtype)
                                if cfg.projection_dim is not None else None)

    def forward(self, input_ids) -> Tuple[torch.Tensor, torch.Tensor]:
        """input_ids [B, L] -> (hidden states [B, L, D], pooled [B, D or proj]).

        The hidden states follow ``clip_skip``: 1 the final LayerNorm's
        output; k > 1 the states after layer num_layers - k + 1, LayerNormed
        by the final LayerNorm unless ``ln_penultimate`` is off. The pooled
        state is the final output at the highest token id (the EOT token)."""
        c = self.cfg
        B, L = input_ids.shape
        x = (self.token_embedding[input_ids].to(self.dtype)
             + self.position_embedding[None, :L].to(self.dtype))
        keep = c.num_layers - (c.clip_skip - 1)
        hidden = None
        for i in range(c.num_layers):
            x = getattr(self, f"layer_{i}")(x)
            if i == keep - 1:
                hidden = x
        final = self.ln_final(x)
        if c.clip_skip > 1:
            out_hidden = self.ln_final(hidden) if c.ln_penultimate else hidden
        else:
            out_hidden = final
        pooled = final[torch.arange(B, device=final.device), input_ids.argmax(dim=-1)]
        if self.text_projection is not None:
            pooled = self.text_projection(pooled)
        return out_hidden, pooled
