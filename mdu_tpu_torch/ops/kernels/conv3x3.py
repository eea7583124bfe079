"""Fused (normalise -> SiLU ->) conv3x3: the CUDA kernel ``csrc/conv3x3.cu``,
its plain PyTorch version, and the port's copy of the JAX block planner.

``fused_conv3x3`` replaces ``mdu_tpu.ops.pallas.conv3x3.fused_conv3x3``: an
NHWC, stride-1, 'same' 3x3 convolution of silu(x * scale + shift) (scale and
shift [B, C] fp32, a folded GroupNorm affine), the zero pad staying zero
after the activation, fp32 accumulation, output in x's dtype;
``fuse_act=False`` gives a plain conv. Inputs and outputs keep the JAX
layouts: x [B, H, W, C], w HWIO [3, 3, C, Co], y [B, H, W, Co]. The kernel
takes the weight re-laid out by ``pack_conv3x3_weight`` (a caller packs once
per module and passes ``packed``). Launches count under ``fused_conv3x3``
(bf16) and ``fused_conv3x3_f32`` (fp32). The wrapper raises on a CUDA
tensor it does not take and runs the plain version only for a CPU tensor.

bf16 has two forms, chosen by ``conv_form`` on shape and alignment alone
(never on a failure), each counted also under
``LAUNCHES["fused_conv3x3.<form>"]``:

* ``sm90``: the warpgroup kernel (wgmma, TMA, a producer warp, three
  activation warps and two consumer warpgroups) for C % 64 == 0, Co % 8 == 0
  and 16-byte aligned x, packed weight, scale and shift: all of config 2;
* ``mma``: the ``mma.sync`` kernel for any other bf16 input (the tiny UNet's
  C = 12 and 24, unaligned operands).

fp32 has two forms, chosen by ``conv_f32_form`` in the same way and counted
also under ``LAUNCHES["fused_conv3x3_f32.<form>"]``:

* ``sm90``: the warpgroup kernel on the tensor cores, each product as three
  TF32 products (``csrc/conv3x3_f32_sm90.cuh``), which keeps fp32's
  precision, for C % 16 == 0, Co % 8 == 0 and 16-byte aligned x, packed
  weight, scale and shift: all of config 2;
* ``simt``: the CUDA-core kernel for any other fp32 input (the tiny UNet's
  C = 12 and 24, unaligned operands).

The fp32 weight is packed in two parts, [2, Co, 9 * Cp]: big, the weight
rounded to tf32 (to the nearest, ties away from zero, by integer
operations), and small, the exact rest, so that big + small is the weight
and the card splits only the activated input.

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
           "conv3x3_plan_fits", "conv_form", "launch_form", "conv_f32_form",
           "launch_f32_form"]

K_CHUNK = 32     # input channels of one K chunk of the mma.sync kernel
SM90_CHUNK = 64  # ... of the warpgroup kernel, which takes no padded channels
F32_SM90_CHUNK = 16  # ... of the fp32 warpgroup kernel
# C function of each bf16 form and of each fp32 form (library conv3x3)
FORMS = {"sm90": "mdu_conv3x3_sm90", "mma": "mdu_conv3x3"}
F32_FORMS = {"sm90": "mdu_conv3x3_f32_sm90", "simt": "mdu_conv3x3"}


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


def tf32_split(w):
    """(big, small) of an fp32 tensor: big = w rounded to tf32 (10 mantissa
    bits, to the nearest, ties away from zero, as ``sm90.cuh::to_tf32``
    rounds: its low 13 bits zero), small = w - big, exact in fp32."""
    bits = (w.contiguous().view(torch.int32) + 0x1000) & -0x2000
    big = bits.view(torch.float32)
    return big, w - big


def packed_shape(C: int, Co: int, dtype) -> tuple:
    """The shape ``pack_conv3x3_weight`` gives a [3, 3, C, Co] weight."""
    Cp = -(-C // K_CHUNK) * K_CHUNK
    return (2, Co, 9 * Cp) if dtype == torch.float32 else (Co, 9 * Cp)


def pack_conv3x3_weight(w):
    """HWIO [3, 3, C, Co] -> the kernel's [Co, 9 * Cp] (tap-major, C padded
    with zeros to Cp, a multiple of 32), in w's dtype and on its device; in
    fp32 [2, Co, 9 * Cp]: ``tf32_split``'s big and small parts."""
    kh, kw, C, Co = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"pack_conv3x3_weight: needs a 3x3 HWIO kernel, got {tuple(w.shape)}")
    Cp = -(-C // K_CHUNK) * K_CHUNK
    packed = torch.zeros(Co, 3, 3, Cp, dtype=w.dtype, device=w.device)
    packed[..., :C] = w.permute(3, 0, 1, 2)
    packed = packed.reshape(Co, 9 * Cp)
    return torch.stack(tf32_split(packed)) if w.dtype == torch.float32 else packed


def fused_conv3x3_plain(x, w, scale=None, shift=None, fuse_act: bool = False):
    """The kernel's arithmetic: the activation in fp32, rounded to x's dtype,
    zero padding after it, fp32 products, output in x's dtype."""
    if fuse_act:
        xf = x.float() * scale[:, None, None, :].float() + shift[:, None, None, :].float()
        x = (xf * torch.sigmoid(xf)).to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w.permute(3, 2, 0, 1).float(), padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def conv_form(x, packed, scale=None, shift=None) -> str:
    """The form of the bf16 kernel that takes these operands: ``sm90`` for
    C % 64 == 0 and Co % 8 == 0 with every operand on a 16-byte boundary (a
    tensor map needs 16-byte aligned bases and strides; the activation reads
    scale and shift 8 channels at a time), else ``mma``."""
    ops = [t for t in (x, packed, scale, shift) if t is not None]
    if (x.shape[-1] % SM90_CHUNK == 0 and packed.shape[0] % 8 == 0
            and aligned16(*ops)):
        return "sm90"
    return "mma"


def launch_form(form: str, x, packed, scale, shift, fuse_act: bool):
    """Launch one bf16 form on checked operands (the wrapper passes
    ``conv_form``'s choice; a benchmark may time the other form on the same
    inputs). Returns y [B, H, W, Co]."""
    B, H, W, C = x.shape
    Co = packed.shape[0]
    Cp = -(-C // K_CHUNK) * K_CHUNK
    if not fuse_act:
        scale = shift = x                    # not read by the kernels
    y = torch.empty(B, H, W, Co, dtype=x.dtype, device=x.device)
    args = [ptr(x), ptr(packed), ptr(scale), ptr(shift), ptr(y),
            *(ctypes.c_int(v) for v in (B, H, W, C, Cp, Co, int(bool(fuse_act))))]
    if form == "mma":
        args += [ctypes.c_int(1),            # is_bf16
                 ctypes.c_int(int(C % 8 == 0 and aligned16(x, scale, shift)))]
    launch("fused_conv3x3", "conv3x3", FORMS[form], x.device, *args, form=form)
    return y


def conv_f32_form(x, packed, scale=None, shift=None) -> str:
    """The form of the fp32 kernel that takes these operands: ``sm90`` for
    C % 16 == 0 and Co % 8 == 0 with every operand on a 16-byte boundary (a
    tensor map needs 16-byte aligned bases and strides; the activation reads
    scale and shift 4 channels at a time; the epilogue stores channel
    pairs), else ``simt``."""
    ops = [t for t in (x, packed, scale, shift) if t is not None]
    if (x.shape[-1] % F32_SM90_CHUNK == 0 and packed.shape[-2] % 8 == 0
            and aligned16(*ops)):
        return "sm90"
    return "simt"


def launch_f32_form(form: str, x, packed, scale, shift, fuse_act: bool):
    """Launch one fp32 form on checked operands (the wrapper passes
    ``conv_f32_form``'s choice; a benchmark may time ``simt`` on the same
    inputs). Returns y [B, H, W, Co]."""
    B, H, W, C = x.shape
    Co = packed.shape[-2]
    Cp = -(-C // K_CHUNK) * K_CHUNK
    if not fuse_act:
        scale = shift = x                    # not read by the kernels
    y = torch.empty(B, H, W, Co, dtype=x.dtype, device=x.device)
    args = [ptr(x), ptr(packed), ptr(scale), ptr(shift), ptr(y),
            *(ctypes.c_int(v) for v in (B, H, W, C, Cp, Co, int(bool(fuse_act))))]
    if form == "simt":
        args += [ctypes.c_int(0), ctypes.c_int(0)]     # is_bf16, vec
    launch("fused_conv3x3_f32", "conv3x3", F32_FORMS[form], x.device, *args, form=form)
    return y


def fused_conv3x3(x, w, scale=None, shift=None, fuse_act: bool = False,
                  packed=None):
    """conv3x3(silu(x * scale + shift)) ('same' padding) on NHWC x with HWIO
    w; ``packed``: ``pack_conv3x3_weight(w)``, packed now when not given.
    Returns [B, H, W, Co]."""
    if x.device.type == "cpu":
        return fused_conv3x3_plain(x, w, scale, shift, fuse_act)
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
    want = packed_shape(C, Co, x.dtype)
    if (tuple(packed.shape) != want or packed.dtype != x.dtype
            or packed.device != x.device or not packed.is_contiguous()):
        raise ValueError(f"fused_conv3x3: packed weight must be a contiguous "
                         f"{list(want)} {x.dtype} tensor on {x.device}, got "
                         f"{packed.dtype} {tuple(packed.shape)} on {packed.device}")
    if fuse_act:
        for n, t in (("scale", scale), ("shift", shift)):
            if (t is None or t.device != x.device or t.dtype != torch.float32
                    or tuple(t.shape) != (B, C) or not t.is_contiguous()):
                raise ValueError(f"fused_conv3x3: {n} must be a contiguous fp32 "
                                 f"[{B}, {C}] tensor on {x.device}")
    ops = (x, packed, scale, shift) if fuse_act else (x, packed)
    if x.dtype == torch.bfloat16:
        return launch_form(conv_form(*ops), x, packed, scale, shift, fuse_act)
    return launch_f32_form(conv_f32_form(*ops), x, packed, scale, shift, fuse_act)
