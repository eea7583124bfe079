"""Attention primitives (counterpart of ``mdu_tpu/ops/attention.py``).

* ``sdpa``          softmax(q k^T * scale) v with fp32 scores and softmax,
                    probabilities cast to v's dtype.
* ``chunked_sdpa``  the same, materialising at most ``q_chunk`` query rows
                    of scores at a time.
* ``multi_head_attention`` dispatches long sequences on the card to the
  flash kernels of ``ops/kernels`` and everything else to ``sdpa``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from .. import flags
from .kernels import flash_attention, flash_attention_fm, flash_attention_t

FLASH_MIN_SEQ = 512


def sdpa(q, k, v, scale: Optional[float] = None):
    """softmax(q k^T * scale) v over [..., L, D] with fp32 softmax."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


def chunked_sdpa(q, k, v, scale: Optional[float] = None, q_chunk: int = 1024):
    """Query-chunked ``sdpa``: live scores bounded at O(q_chunk * L)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    L = q.shape[-2]
    if L <= q_chunk:
        return sdpa(q, k, v, scale)
    return torch.cat([sdpa(q[..., i:i + q_chunk, :], k, v, scale)
                      for i in range(0, L, q_chunk)], dim=-2)


def _flash_variant(D: int):
    """The online-softmax kernel for D % 128 == 0, else the fixed-shift one;
    ``MDU_FLASH`` overrides it as in the JAX package: ``lane`` the online
    kernel, ``trans`` the online kernel with D padded to 16, ``fm`` the
    fixed-shift kernel, ``fm16`` the fixed-shift kernel with ``bf16_exp``.
    Any other value keeps the default."""
    ov = flags.flash_override()
    if ov == "lane":
        return flash_attention
    if ov == "trans":
        return flash_attention_t
    if ov == "fm":
        return flash_attention_fm
    if ov == "fm16":
        return functools.partial(flash_attention_fm, bf16_exp=True)
    return flash_attention if D % 128 == 0 else flash_attention_fm


def multi_head_attention(q, k, v, num_heads: int, q_chunk: Optional[int] = None):
    """[B, L, H*D] q, k, v -> attention output [B, L, H*D].

    On a CUDA tensor with Lq and Lk both >= FLASH_MIN_SEQ the flash kernels
    run (their wrappers raise on a dtype they do not take); otherwise full
    ``sdpa``, or ``chunked_sdpa`` when ``q_chunk`` is given.
    """
    B, Lq, HD = q.shape
    Lk = k.shape[1]
    D = HD // num_heads

    def split(x, L):
        return x.reshape(B, L, num_heads, D).transpose(1, 2)

    qh, kh, vh = split(q, Lq), split(k, Lk), split(v, Lk)
    if q.is_cuda and Lq >= FLASH_MIN_SEQ and Lk >= FLASH_MIN_SEQ:
        out = _flash_variant(D)(qh.contiguous(), kh.contiguous(), vh.contiguous())
    elif q_chunk is not None:
        out = chunked_sdpa(qh, kh, vh, q_chunk=q_chunk)
    else:
        out = sdpa(qh, kh, vh)
    return out.transpose(1, 2).reshape(B, Lq, HD)
