"""The backward of the flash kernels: its CUDA kernel and its plain version.

``csrc/flash_attention_bwd.cu`` computes dQ, dK and dV of
softmax(Q K^T * scale) V on [B, H, L, D] from q, k, v, the forward's output
O and dO, recomputing each query row's log-sum-exp. It replaces no TPU
kernel: the Pallas kernels of ``mdu_tpu/ops/pallas/flash_attention.py``
have no backward. ``flash.py`` makes #1, #2 and #3 autograd functions whose
backward is this kernel (``flash_attention_bwd``), so that a train step on
the card keeps the gradient of every long self-attention.

The gradient is that of exact softmax attention: the fixed shift of #1
cancels, and the rounding of p to v's dtype in the forward is taken as the
identity (as autograd through a plain version takes its ``.to(v.dtype)``).
fp32 and bf16 inputs, fp32 accumulation, gradients in the inputs' dtype;
1 <= D <= 160. Each call launches three kernels and counts one under
``LAUNCHES["flash_attention_bwd"]`` and ``["flash_attention_bwd.f32|bf16"]``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .launch import launch, ptr

__all__ = ["BWD_MAX_D", "flash_attention_bwd", "flash_attention_bwd_plain"]

BWD_MAX_D = 160   # widest head of the backward kernel (every UNet head)
_ROWS = 1024      # query rows per chunk of the plain version (bounds memory)


def flash_attention_bwd_plain(q, k, v, o, do, scale: Optional[float] = None):
    """dQ, dK, dV of softmax(q k^T * scale) v on [B, H, L, D] in fp32,
    query rows in chunks: P = exp(S - lse), delta = rowsum(dO * O),
    dS = P * (dO v^T - delta); returned in the inputs' dtypes."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    qf, kf, vf = q.float(), k.float(), v.float()
    gf = do.float()
    delta = (gf * o.float()).sum(-1, keepdim=True)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    dqs = []
    for i in range(0, q.shape[2], _ROWS):
        qi, gi = qf[:, :, i:i + _ROWS], gf[:, :, i:i + _ROWS]
        s = torch.matmul(qi, kf.transpose(-1, -2)) * scale
        p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
        dv += torch.matmul(p.transpose(-1, -2), gi)
        ds = p * (torch.matmul(gi, vf.transpose(-1, -2)) - delta[:, :, i:i + _ROWS])
        dqs.append(torch.matmul(ds, kf) * scale)
        dk += torch.matmul(ds.transpose(-1, -2), qi) * scale
    return torch.cat(dqs, dim=2).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q, k, v, o, do, scale: Optional[float] = None):
    """dQ, dK, dV of flash attention; the kernel on a CUDA tensor, the plain
    version on a CPU tensor. Raises on anything the kernel does not take
    (``NotImplementedError`` for D > 160, ROADMAP item 28)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, scale)
    name = "flash_attention_bwd"
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    for n, x, want in (("q", q, (B, H, Lq, D)), ("k", k, (B, H, Lk, D)),
                       ("v", v, (B, H, Lk, D)), ("o", o, (B, H, Lq, D)),
                       ("do", do, (B, H, Lq, D))):
        if x.device != q.device or x.dtype != q.dtype or tuple(x.shape) != want:
            raise ValueError(f"{name}: {n} must be a {list(want)} {q.dtype} tensor on "
                             f"{q.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {n} must be contiguous")
    if q.device.type != "cuda" or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: needs CUDA fp32 or bf16 tensors, got {q.dtype} on "
                         f"{q.device}")
    if D > BWD_MAX_D:
        raise NotImplementedError(f"{name}: heads wider than {BWD_MAX_D} (D = {D}) have no "
                                  f"backward kernel yet (ROADMAP item 28)")
    if Lq == 0 or Lk == 0 or D == 0:
        raise ValueError(f"{name}: empty input {tuple(q.shape)} / {tuple(k.shape)}")
    scale = D ** -0.5 if scale is None else scale
    stats = torch.empty(2, B * H * Lq, device=q.device, dtype=torch.float32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    bf16 = q.dtype == torch.bfloat16
    launch(name, name, "mdu_flash_attention_bwd", q.device, ptr(q), ptr(k), ptr(v), ptr(o),
           ptr(do), ptr(dq), ptr(dk), ptr(dv), ptr(stats[0]), ptr(stats[1]),
           ctypes.c_int(B * H), ctypes.c_int(Lq), ctypes.c_int(Lk), ctypes.c_int(D),
           ctypes.c_float(scale), ctypes.c_int(int(bf16)), form="bf16" if bf16 else "f32")
    return dq, dk, dv
