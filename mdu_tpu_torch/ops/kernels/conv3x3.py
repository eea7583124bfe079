"""Fused (normalise -> SiLU ->) conv3x3: the CUDA kernel ``csrc/conv3x3.cu``,
its plain PyTorch version, and the port's copy of the JAX block planner.

``fused_conv3x3`` replaces ``mdu_tpu.ops.pallas.conv3x3.fused_conv3x3``: an
NHWC, stride-1, 'same' 3x3 convolution of silu(x * scale + shift) (scale and
shift [B, C] fp32, a folded GroupNorm affine), the zero pad staying zero
after the activation, fp32 accumulation, output in x's dtype;
``fuse_act=False`` gives a plain conv. Inputs and outputs keep the JAX
layouts: x [B, H, W, C], w HWIO [3, 3, C, Co], y [B, H, W, Co]. The kernel
takes the weight re-laid out by ``pack_conv3x3_weight`` (a caller packs once
per module and passes ``packed``). bf16 runs on the tensor cores (launches
count under ``fused_conv3x3``), fp32 on the CUDA cores
(``fused_conv3x3_f32``). The wrapper raises on a CUDA tensor it does not
take and runs the plain version only for a CPU tensor.

``_plan_blocks`` / ``conv3x3_plan_fits`` are copies of the JAX planner. The
port uses them only to decide dispatch as the JAX package does (the same
layers take the fused arithmetic on both sides), not to size CUDA blocks.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .launch import aligned16, launch, ptr

__all__ = ["fused_conv3x3", "fused_conv3x3_plain", "pack_conv3x3_weight",
           "conv3x3_plan_fits"]

K_CHUNK = 32     # input channels of one K chunk of the kernel


def _plan_blocks(H: int, W: int, C: int, Co: int,
                 vmem_budget: int = 9 * 2 ** 20) -> Optional[Tuple[int, int]]:
    """(bh, bco) whose working set fits the TPU kernel's VMEM budget, or None
    (the JAX planner, ``mdu_tpu/ops/pallas/conv3x3.py::_plan_blocks``)."""
    bcos = [Co] + [c for c in (512, 384, 256, 128) if c < Co and Co % c == 0]
    for bh in (32, 16, 8, 4, 2, 1):
        if H % bh and bh > 1:
            continue
        x_bytes = (bh + 2) * (W + 2) * C * 2
        patch_bytes = bh * W * C * 2
        for bco in bcos:
            w_bytes = 9 * C * bco * 2
            acc_bytes = bh * W * bco * 4
            o_bytes = bh * W * bco * 2
            total = (x_bytes * 3 + o_bytes * 2 + acc_bytes + w_bytes * 2
                     + 2 * patch_bytes)
            if total <= vmem_budget:
                return bh, bco
    return None


def conv3x3_plan_fits(H: int, W: int, C: int, Co: int) -> bool:
    return _plan_blocks(H, W, C, Co) is not None


def pack_conv3x3_weight(w):
    """HWIO [3, 3, C, Co] -> the kernel's [Co, 9 * Cp] (tap-major, C padded
    with zeros to Cp, a multiple of 32), in w's dtype and on its device."""
    kh, kw, C, Co = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"pack_conv3x3_weight: needs a 3x3 HWIO kernel, got {tuple(w.shape)}")
    Cp = -(-C // K_CHUNK) * K_CHUNK
    packed = torch.zeros(Co, 3, 3, Cp, dtype=w.dtype, device=w.device)
    packed[..., :C] = w.permute(3, 0, 1, 2)
    return packed.reshape(Co, 9 * Cp)


def fused_conv3x3_plain(x, w, scale=None, shift=None, fuse_act: bool = False):
    """The kernel's arithmetic: the activation in fp32, rounded to x's dtype,
    zero padding after it, fp32 products, output in x's dtype."""
    if fuse_act:
        xf = x.float() * scale[:, None, None, :].float() + shift[:, None, None, :].float()
        x = (xf * torch.sigmoid(xf)).to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w.permute(3, 2, 0, 1).float(), padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def fused_conv3x3(x, w, scale=None, shift=None, fuse_act: bool = False,
                  packed=None):
    """conv3x3(silu(x * scale + shift)) ('same' padding) on NHWC x with HWIO
    w; ``packed``: ``pack_conv3x3_weight(w)``, packed now when not given.
    Returns [B, H, W, Co]."""
    if x.device.type == "cpu":
        return fused_conv3x3_plain(x, w, scale, shift, fuse_act)
    bf16 = x.dtype == torch.bfloat16
    name = "fused_conv3x3" if bf16 else "fused_conv3x3_f32"
    if x.device.type != "cuda" or x.dim() != 4 or x.dtype not in (torch.bfloat16,
                                                                 torch.float32):
        raise ValueError(f"fused_conv3x3: needs a CUDA NHWC bf16 or fp32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous():
        raise ValueError("fused_conv3x3: x must be contiguous NHWC")
    B, H, W, C = x.shape
    Co = w.shape[3]
    if tuple(w.shape) != (3, 3, C, Co):
        raise ValueError(f"fused_conv3x3: w must be HWIO [3, 3, {C}, Co], got {tuple(w.shape)}")
    if packed is None:
        packed = pack_conv3x3_weight(w.to(x.dtype))
    Cp = -(-C // K_CHUNK) * K_CHUNK
    if (tuple(packed.shape) != (Co, 9 * Cp) or packed.dtype != x.dtype
            or packed.device != x.device or not packed.is_contiguous()):
        raise ValueError(f"fused_conv3x3: packed weight must be a contiguous "
                         f"[{Co}, {9 * Cp}] {x.dtype} tensor on {x.device}, got "
                         f"{packed.dtype} {tuple(packed.shape)} on {packed.device}")
    if fuse_act:
        for n, t in (("scale", scale), ("shift", shift)):
            if (t is None or t.device != x.device or t.dtype != torch.float32
                    or tuple(t.shape) != (B, C) or not t.is_contiguous()):
                raise ValueError(f"fused_conv3x3: {n} must be a contiguous fp32 "
                                 f"[{B}, {C}] tensor on {x.device}")
    else:
        scale = shift = x                    # not read by the kernel
    y = torch.empty(B, H, W, Co, dtype=x.dtype, device=x.device)
    vec = int(bf16 and C % 8 == 0 and aligned16(x, scale, shift))
    launch(name, "conv3x3", "mdu_conv3x3", x.device,
           ptr(x), ptr(packed), ptr(scale), ptr(shift), ptr(y),
           *(ctypes.c_int(v) for v in (B, H, W, C, Cp, Co, int(bool(fuse_act)),
                                       int(bf16), vec)))
    return y
