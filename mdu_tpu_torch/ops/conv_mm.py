"""A 3x3 'same' stride-1 convolution as matrix products (counterpart of
``mdu_tpu/ops/conv_mm.py``, ``MDU_CONV_MM=9mm|im2col``).

A 3x3 conv is 9 shifted [B*H*W, C] x [C, O] products (``9mm``), or one
[B*H*W, 9*C] x [9*C, O] product over the stacked taps (``im2col``). The JAX
package keeps this as an experiment against XLA's convolution; the port
keeps it for the same A/B against cuDNN. These are plain products, which the
JAX package computes outside any Pallas kernel, so ``torch.mm`` computes them
here.

Every product accumulates in fp32 and the result is rounded to the input's
dtype once, as JAX's ``preferred_element_type=float32`` does. A bf16
``torch.mm`` would round each tap to bf16 before the sum. On the card a bf16
product is ``torch.mm(..., out_dtype=torch.float32)`` (the card's PyTorch
has that overload; the chip check names the route). The CPU build lacks it,
so there the bf16 operands are widened to fp32 first, which is exact (a
product of two bf16 values fits fp32's mantissa) and differs from the card
only in the order of the sums.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["conv3x3_mm", "mm_route"]


def mm_route(device_type: str, dtype: torch.dtype) -> str:
    """How a product of ``dtype`` operands on ``device_type`` accumulates in
    fp32: ``fp32`` (fp32 operands), ``out_dtype`` (the card) or ``widened``."""
    if dtype == torch.float32:
        return "fp32"
    return "out_dtype" if device_type == "cuda" else "widened"


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] accumulated and returned in fp32."""
    if a.dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _taps(xp: torch.Tensor, H: int, W: int):
    """The 9 shifted windows of a padded NHWC tensor, dy-major, dx-minor: the
    order of ``w.permute(2, 3, 1, 0).reshape(9 * C, O)``'s rows."""
    for dy in range(3):
        for dx in range(3):
            yield dy, dx, xp[:, dy:dy + H, dx:dx + W, :]


def conv3x3_mm(x: torch.Tensor, w: torch.Tensor, mode: str = "9mm",
               layout: str = "NHWC") -> torch.Tensor:
    """conv3x3(x, w), 'same' padding, stride 1, as products.

    x: [B, H, W, C] (``layout='NHWC'``) or [B, C, H, W] (``'NCHW'``);
    w: OIHW [O, C, 3, 3] in x's dtype. Returns [B, H, W, O] or [B, O, H, W]
    in x's dtype."""
    if mode not in ("9mm", "im2col"):
        raise ValueError(f"unknown conv-mm mode {mode!r}")
    O = w.shape[0]
    if layout == "NHWC":
        B, H, W, C = x.shape
        wt = w.permute(2, 3, 1, 0)                           # HWIO
        xp = F.pad(x, (0, 0, 1, 1, 1, 1))
        if mode == "im2col":
            xc = torch.cat([xs for _, _, xs in _taps(xp, H, W)], dim=-1)
            y = _mm_f32(xc.reshape(B * H * W, 9 * C), wt.reshape(9 * C, O))
            return y.to(x.dtype).reshape(B, H, W, O)
        acc = torch.zeros(B * H * W, O, dtype=torch.float32, device=x.device)
        for dy, dx, xs in _taps(xp, H, W):
            acc += _mm_f32(xs.reshape(B * H * W, C), wt[dy, dx])
        return acc.to(x.dtype).reshape(B, H, W, O)
    if layout != "NCHW":
        raise ValueError(f"unknown layout {layout!r}")
    B, C, H, W = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    if mode == "im2col":
        # taps on a leading axis: one [O, 9C] x [9C, BHW] product, its rows
        # tap-major and channel-minor, as OIHW's (h, w, i)
        cols = torch.stack([xp[:, :, dy:dy + H, dx:dx + W]
                            for dy in range(3) for dx in range(3)], 0)
        xc = cols.permute(0, 2, 1, 3, 4).reshape(9 * C, B * H * W)
        wf = w.permute(2, 3, 1, 0).reshape(9 * C, O)
        y = _mm_f32(wf.t().contiguous(), xc)                # [O, BHW]
        return y.reshape(O, B, H, W).permute(1, 0, 2, 3).to(x.dtype).contiguous()
    acc = torch.zeros(O, B * H * W, dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            xs = xp[:, :, dy:dy + H, dx:dx + W].permute(1, 0, 2, 3).reshape(C, B * H * W)
            acc += _mm_f32(w[:, :, dy, dx].contiguous(), xs)
    return acc.reshape(O, B, H, W).permute(1, 0, 2, 3).to(x.dtype).contiguous()
