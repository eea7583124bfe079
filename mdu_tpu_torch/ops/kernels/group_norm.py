"""Fused GroupNorm: the CUDA kernel ``csrc/group_norm.cu`` and its plain
PyTorch version.

``fused_group_norm`` replaces ``mdu_tpu.ops.pallas.group_norm.fused_group_norm``:
NCHW GroupNorm with per-(batch, group) fp32 statistics, var = max(E[x^2] -
mean^2, 0) (the port clamps; the Pallas body does not), ((x - mean) *
rsqrt(var + eps)) * w + b in fp32, output in x's dtype. x is bf16 or fp32,
the affine bf16 or fp32. The wrapper launches the kernel for a CUDA tensor
and raises on anything it does not take; it runs the plain version only for
a CPU tensor. Each launch adds one to ``LAUNCHES["fused_group_norm"]``.
"""
from __future__ import annotations

import ctypes

import torch

from .launch import aligned16, launch, ptr

__all__ = ["fused_group_norm", "fused_group_norm_plain"]

_DTYPES = (torch.bfloat16, torch.float32)


def fused_group_norm_plain(x, num_groups: int, weight, bias, eps: float = 1e-6):
    """The kernel's arithmetic on an NCHW tensor."""
    B, C, H, W = x.shape
    G = num_groups
    xf = x.float().reshape(B, G, C // G * H * W)
    mean = xf.mean(dim=2, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=2, keepdim=True) - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    out = ((xf - mean) * rstd).reshape(B, C, H, W)
    out = out * weight.float().reshape(1, C, 1, 1) + bias.float().reshape(1, C, 1, 1)
    return out.to(x.dtype)


def fused_group_norm(x, num_groups: int, weight, bias, eps: float = 1e-6):
    """GroupNorm over NCHW with per-(batch, group) fp32 stats, one kernel."""
    if x.device.type == "cpu":
        return fused_group_norm_plain(x, num_groups, weight, bias, eps)
    name = "fused_group_norm"
    if x.device.type != "cuda" or x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"{name}: needs a CUDA [B, C, H, W] bf16 or fp32 tensor, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous NCHW")
    B, C, H, W = x.shape
    if C % num_groups:
        raise ValueError(f"{name}: {C} channels do not split into {num_groups} groups")
    if C // num_groups * H * W >= 2 ** 31:
        raise ValueError(f"{name}: a group of {C // num_groups * H * W} elements "
                         f"is too large")
    for n, t in (("weight", weight), ("bias", bias)):
        if (t.device != x.device or t.dtype not in _DTYPES or tuple(t.shape) != (C,)
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {n} must be a contiguous [{C}] bf16 or fp32 "
                             f"tensor on {x.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if weight.dtype != bias.dtype:
        raise ValueError(f"{name}: weight and bias have different dtypes")
    y = torch.empty_like(x)
    per16 = 16 // x.element_size()
    vec = int(H * W % per16 == 0 and aligned16(x, y))
    launch(name, "group_norm", "mdu_group_norm", x.device,
           ptr(x), ptr(weight), ptr(bias), ptr(y), ctypes.c_int(B), ctypes.c_int(C),
           ctypes.c_int(num_groups), ctypes.c_int(H * W), ctypes.c_float(eps),
           ctypes.c_int(int(x.dtype == torch.bfloat16)),
           ctypes.c_int(int(weight.dtype == torch.bfloat16)), ctypes.c_int(vec))
    return y
