"""GroupNorm with fp32 statistics (counterpart of ``mdu_tpu/ops/groupnorm.py``).

* ``group_stats``       per-(batch, group) mean, E[x^2] and count, fp32,
                        optionally masked to a tile's owned region;
* ``apply_group_norm``  normalise with given stats, then the affine;
* ``group_norm``        plain GroupNorm, var = max(E[x^2] - mean^2, 0);
* ``group_norm_affine`` the same statistics folded into a per-(batch,
                        channel) fp32 (a, b) with group_norm(x) = x * a + b,
                        for a consumer that fuses the normalisation;
* ``group_norm_fold`` / ``group_norm_chanreduce``  the plain GroupNorm as
                        per-channel moments and that folded affine
                        (``MDU_GN=fold|chanreduce``);
* ``group_norm_nhwc`` / ``group_norm_affine_nhwc`` the same on the
                        channels-last UNet's activations (a tensor of NCHW
                        shape in ``torch.channels_last`` memory; the result
                        keeps it);
* ``GroupNormStats``    statistics recorded by one call and injected into
                        another (the JAX package's ``gn_stats`` collection).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

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
    """Folded GroupNorm affine of an NCHW-shaped tensor in either memory
    format (no reshape of ``x``): per-(batch, channel) fp32 (a, b), each [B,
    C], with group_norm(x) == x * a + b."""
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


def group_norm_fold(x, num_groups: int, weight=None, bias=None, eps: float = 1e-6):
    """GroupNorm as the folded affine applied in one elementwise pass, x * a +
    b in fp32, rounded to x's dtype (``MDU_GN=fold``; JAX keeps every fp32
    value inside its fusions this way, ``mdu_tpu/ops/groupnorm.py:123``)."""
    a_c, b_c = group_norm_affine(x, num_groups, weight, bias, eps)
    return (x.float() * a_c[:, :, None, None] + b_c[:, :, None, None]).to(x.dtype)


def group_norm_chanreduce(x, num_groups: int, weight=None, bias=None, eps: float = 1e-6):
    """GroupNorm from per-channel moments pooled on the [B, C] pair, then the
    folded affine (``MDU_GN=chanreduce``, ``mdu_tpu/ops/groupnorm.py:235``).
    The JAX package's ``fold`` and ``chanreduce`` differ only in how XLA
    fuses them; eager PyTorch runs both as ``group_norm_fold``."""
    return group_norm_fold(x, num_groups, weight, bias, eps)


def group_norm_nhwc(x, num_groups: int, weight=None, bias=None, eps: float = 1e-6):
    """The channels-last UNet's GroupNorm (``mdu_tpu/ops/groupnorm.py:177``):
    per-channel moments, the folded affine, one elementwise pass. ``x`` has
    NCHW shape in ``torch.channels_last`` memory, and so has the result."""
    return group_norm_fold(x, num_groups, weight, bias, eps)


def group_norm_affine_nhwc(x, num_groups: int, weight=None, bias=None, eps: float = 1e-6):
    """The folded (a, b) of a channels-last ``x`` for the fused conv
    (``mdu_tpu/ops/groupnorm.py:201``)."""
    return group_norm_affine(x, num_groups, weight, bias, eps)


class GroupNormStats:
    """Per-layer GroupNorm statistics handed down a VAE call, in place of the
    JAX package's ``gn_stats`` variable collection (Tiled VAE fast mode, ref
    tilevae.py:465-505). Keys are the ``GroupNorm`` modules themselves.

    * ``capture=True``: every GroupNorm that gets no injected statistics
      computes its per-sample (mean, var) [B, G], records them here and
      normalises with them;
    * a held entry: that GroupNorm normalises with the recorded (mean, var),
      tiled over the batch: row i takes batch i % B, as ``jnp.tile`` does.
    """

    def __init__(self, capture: bool = False,
                 stats: Optional[Dict[object, Tuple[torch.Tensor, torch.Tensor]]] = None):
        self.capture = capture
        self.stats = dict(stats or {})

    def get(self, layer) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        return self.stats.get(layer)

    def record(self, layer, mean, var) -> None:
        self.stats[layer] = (mean, var)

    def injected(self, layers: Optional[Iterable] = None) -> "GroupNormStats":
        """The recorded statistics for injection only, restricted to
        ``layers`` when given."""
        keep = None if layers is None else set(layers)
        return GroupNormStats(stats={k: v for k, v in self.stats.items()
                                     if keep is None or k in keep})
