"""Fused GroupNorm: the CUDA kernels ``csrc/group_norm.cu`` and their plain
PyTorch version.

``fused_group_norm`` replaces ``mdu_tpu.ops.pallas.group_norm.fused_group_norm``:
NCHW GroupNorm with per-(batch, group) fp32 statistics, var = max(E[x^2] -
mean^2, 0) (the port clamps; the Pallas body does not), ((x - mean) *
rsqrt(var + eps)) * w + b in fp32, output in x's dtype. x is bf16 or fp32,
the affine bf16 or fp32. The wrapper launches a kernel for a CUDA tensor
and raises on anything it does not take; it runs the plain version only for
a CPU tensor. Each launch adds one to ``LAUNCHES["fused_group_norm"]`` and
to ``LAUNCHES["fused_group_norm.<form>"]``, its form chosen by ``gn_plan``
from the shape and dtype alone:

* ``cluster``: each group held in shared memory across a thread-block
  cluster of up to 8 CTAs and read from HBM once, for a tensor too large for
  L2 to keep it for a second read;
* ``two_read``: one block per group that reads it twice (the second time
  from L2, for a tensor that fits there), and for a group larger than a
  cluster holds.
"""
from __future__ import annotations

import ctypes

import torch

from .launch import aligned16, launch, ptr, refuse_grad

__all__ = ["fused_group_norm", "fused_group_norm_plain", "gn_plan", "cluster_split",
           "launch_form"]

_DTYPES = (torch.bfloat16, torch.float32)
CLUSTER_MAX = 8                 # CTAs of a cluster (the portable limit)
PART_BYTES = 32 * 1024          # a CTA's part of a group, where 8 CTAs allow it
PART_MAX_BYTES = 192 * 1024     # the most a CTA holds (of 227 KB of shared memory)
# A tensor this small finds the two_read form's second read in L2 (50 MB,
# beside its output); the cluster form only pays above it (PERF.md, #4).
L2_RESIDENT_BYTES = 32 * 2 ** 20


def cluster_split(n: int, itemsize: int):
    """(cluster size, elements per CTA) of a group of ``n`` elements: the
    fewest CTAs (a power of two up to 8) whose parts hold at most 32 KB each,
    or more if 8 do not get there, a part being whole 16-byte lines; None
    when a part would pass 192 KB."""
    per16 = 16 // itemsize
    cluster = 1
    while cluster < CLUSTER_MAX and -(-n * itemsize // cluster) > PART_BYTES:
        cluster *= 2
    part = -(-n // cluster)
    part = -(-part // per16) * per16
    return None if part * itemsize > PART_MAX_BYTES else (cluster, part)


def gn_plan(B: int, C: int, num_groups: int, H: int, W: int, itemsize: int):
    """(form, cluster size, elements per CTA) of the kernel for a [B, C, H, W]
    tensor of ``itemsize`` bytes: ``cluster`` (with ``cluster_split``'s
    split) for a tensor past ``L2_RESIDENT_BYTES`` whose group fits a
    cluster; else ``two_read`` (cluster size and part 0)."""
    split = cluster_split(C // num_groups * H * W, itemsize)
    if split is None or B * C * H * W * itemsize <= L2_RESIDENT_BYTES:
        return "two_read", 0, 0
    return ("cluster",) + split


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
    refuse_grad(name, "train with MDU_FUSED_GN off (the backward of #4 is ROADMAP "
                "item 26)", x, weight, bias)
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
    return launch_form(gn_plan(B, C, num_groups, H, W, x.element_size())[0], x, num_groups,
                       weight, bias, eps)


def launch_form(form: str, x, num_groups: int, weight, bias, eps: float = 1e-6):
    """Launch one form of the kernel on checked inputs (the wrapper passes
    ``gn_plan``'s choice; a benchmark may time the other form on the same
    inputs, the cluster form wherever a group fits a cluster)."""
    B, C, H, W = x.shape
    y = torch.empty_like(x)
    dtypes = (ctypes.c_int(int(x.dtype == torch.bfloat16)),
              ctypes.c_int(int(weight.dtype == torch.bfloat16)))
    args = (ptr(x), ptr(weight), ptr(bias), ptr(y), ctypes.c_int(B), ctypes.c_int(C),
            ctypes.c_int(num_groups), ctypes.c_int(H * W))
    if form == "cluster":
        cluster, part = cluster_split(C // num_groups * H * W, x.element_size())
        launch("fused_group_norm", "group_norm", "mdu_group_norm_cluster", x.device, *args,
               ctypes.c_int(cluster), ctypes.c_int(part), ctypes.c_float(eps), *dtypes,
               form=form)
    else:
        vec = int(H * W % (16 // x.element_size()) == 0 and aligned16(x, y))
        launch("fused_group_norm", "group_norm", "mdu_group_norm", x.device, *args,
               ctypes.c_float(eps), *dtypes, ctypes.c_int(vec), form=form)
    return y
