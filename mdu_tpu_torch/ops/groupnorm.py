"""GroupNorm with fp32 statistics (counterpart of ``mdu_tpu/ops/groupnorm.py``).

* ``group_stats``       per-(batch, group) mean, E[x^2] and count, fp32,
                        optionally masked to a tile's owned region;
* ``apply_group_norm``  normalise with given stats, then the affine;
* ``group_norm``        plain GroupNorm, var = max(E[x^2] - mean^2, 0);
* ``group_norm_affine`` the same statistics folded into a per-(batch,
                        channel) fp32 (a, b) with group_norm(x) = x * a + b,
                        for a consumer that fuses the normalisation.
"""
from __future__ import annotations

from typing import Tuple

import torch


def group_stats(x, num_groups: int, mask=None) -> Tuple[torch.Tensor, ...]:
    """(mean, meansq, count), each [B, G], of an NCHW tensor in fp32.

    ``mask``: optional [H, W] or [1, 1, H, W] 0/1 map of the pixels counted.
    """
    B, C, H, W = x.shape
    G = num_groups
    xf = x.float().reshape(B, G, C // G, H, W)
    if mask is None:
        n = torch.full((B, G), float(C // G * H * W), dtype=torch.float32,
                       device=x.device)
        s1 = xf.sum(dim=(2, 3, 4))
        s2 = (xf * xf).sum(dim=(2, 3, 4))
    else:
        m = mask.float().reshape(1, 1, 1, H, W)
        n = (m.sum(dim=(2, 3, 4)) * (C // G)).expand(B, G)
        s1 = (xf * m).sum(dim=(2, 3, 4))
        s2 = (xf * xf * m).sum(dim=(2, 3, 4))
    return s1 / n, s2 / n, n


def apply_group_norm(x, num_groups: int, mean, var, weight=None, bias=None,
                     eps: float = 1e-6):
    """Normalise NCHW ``x`` with per-(batch, group) stats, then the affine.
    The result has x's dtype."""
    B, C, H, W = x.shape
    G = num_groups
    xf = x.float().reshape(B, G, C // G, H, W)
    mu = mean.reshape(B, G, 1, 1, 1)
    rstd = torch.reciprocal(torch.sqrt(var.reshape(B, G, 1, 1, 1) + eps))
    out = ((xf - mu) * rstd).reshape(B, C, H, W)
    if weight is not None:
        out = out * weight.reshape(1, C, 1, 1)
    if bias is not None:
        out = out + bias.reshape(1, C, 1, 1)
    return out.to(x.dtype)


def group_norm(x, num_groups: int, weight=None, bias=None, eps: float = 1e-6):
    """Plain per-sample GroupNorm with fp32 stats."""
    mean, meansq, _ = group_stats(x, num_groups)
    var = torch.clamp(meansq - mean * mean, min=0.0)
    return apply_group_norm(x, num_groups, mean, var, weight, bias, eps)


def group_norm_affine(x, num_groups: int, weight=None, bias=None, eps: float = 1e-6):
    """Folded GroupNorm affine of an NCHW tensor: per-(batch, channel) fp32
    (a, b), each [B, C], with group_norm(x) == x * a + b."""
    B, C, H, W = x.shape
    G = num_groups
    xf = x.float()
    s1 = xf.sum(dim=(2, 3))                          # [B, C]
    s2 = (xf * xf).sum(dim=(2, 3))
    n = float(C // G * H * W)
    gmean = s1.reshape(B, G, C // G).sum(dim=2) / n
    gmeansq = s2.reshape(B, G, C // G).sum(dim=2) / n
    var = torch.clamp(gmeansq - gmean * gmean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    mu_c = gmean.repeat_interleave(C // G, dim=1)    # [B, C]
    rstd_c = rstd.repeat_interleave(C // G, dim=1)
    w = torch.ones(C, device=x.device) if weight is None else weight.float()
    b = torch.zeros(C, device=x.device) if bias is None else bias.float()
    a_c = rstd_c * w[None, :]
    b_c = b[None, :] - mu_c * a_c
    return a_c, b_c
