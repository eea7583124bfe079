"""The backward of the flash kernels: its CUDA kernels and their plain version.

The kernels compute dQ, dK and dV of softmax(Q K^T * scale) V on [B, H, L, D]
from q, k, v, the forward's output O and dO, recomputing each query row's
log-sum-exp. They replace no TPU kernel: the Pallas kernels of
``mdu_tpu/ops/pallas/flash_attention.py`` have no backward. ``flash.py``
makes #1, #2 and #3 autograd functions whose backward is
``flash_attention_bwd``, so that a train step on the card keeps the gradient
of every long self-attention.

The gradient is that of exact softmax attention: the fixed shift of #1
cancels, and the rounding of p to v's dtype in the forward is taken as the
identity (as autograd through a plain version takes its ``.to(v.dtype)``).
fp32 and bf16 inputs, fp32 accumulation, gradients in the inputs' dtype;
1 <= D <= 160. Four forms, chosen by ``bwd_form`` on dtype, D and alignment
alone (never on a failure):

* ``f32_sm90`` (``csrc/flash_attention_bwd_f32.cu``): wgmma in TF32, each
  product as three passes, for fp32 with D % 4 == 0, D <= 160 and 16-byte
  aligned q, k, v, dO (a tensor map needs 16-byte strides and bases);
* ``bf16_sm90`` (``csrc/flash_attention_bwd_bf16.cu``): wgmma in bf16, P and
  dS each as two bf16 passes (big and small parts), for bf16 with D % 8 ==
  0, 16 <= D <= 160 and the same alignment;
* ``f32_simt`` and ``bf16_simt`` (``csrc/flash_attention_bwd.cu``): the CUDA
  cores, for anything else (D = 13, an unaligned view).

The tensor-core forms (``csrc/flash_attention_bwd_sm90.cuh``) launch two
kernels a call, the CUDA-core form three. Each call counts one under
``LAUNCHES["flash_attention_bwd"]`` and one under
``LAUNCHES["flash_attention_bwd.<form>"]``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .launch import aligned16, launch, ptr

__all__ = ["BWD_MAX_D", "BWD_FORMS", "bwd_form", "launch_bwd_form", "flash_attention_bwd",
           "flash_attention_bwd_plain"]

BWD_MAX_D = 160   # widest head of the backward kernels (every UNet head)
# (library, C function) of each form
BWD_FORMS = {
    "f32_sm90": ("flash_attention_bwd_f32", "mdu_flash_attention_bwd_f32_sm90"),
    "bf16_sm90": ("flash_attention_bwd_bf16", "mdu_flash_attention_bwd_bf16_sm90"),
    "f32_simt": ("flash_attention_bwd", "mdu_flash_attention_bwd"),
    "bf16_simt": ("flash_attention_bwd", "mdu_flash_attention_bwd"),
}
_ROWS = 1024      # query rows per chunk of the plain version (bounds memory)
_PAD = 64         # the lse and delta scratch holds Lq rounded up to this


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


def bwd_form(q, k, v, do) -> str:
    """The form of the backward that takes these inputs: ``f32_sm90`` for fp32
    with D % 4 == 0 and D <= 160, ``bf16_sm90`` for bf16 with D % 8 == 0 and
    16 <= D <= 160, each with q, k, v and dO on 16-byte boundaries; else
    ``f32_simt`` or ``bf16_simt``."""
    D = q.shape[-1]
    aligned = aligned16(q, k, v, do)
    if q.dtype == torch.bfloat16:
        sm90 = D % 8 == 0 and 16 <= D <= BWD_MAX_D
        return "bf16_sm90" if sm90 and aligned else "bf16_simt"
    sm90 = D % 4 == 0 and D <= BWD_MAX_D
    return "f32_sm90" if sm90 and aligned else "f32_simt"


def launch_bwd_form(form: str, q, k, v, o, do, scale: Optional[float] = None):
    """Launch one form of the backward on checked inputs (``flash_attention_bwd``
    passes ``bwd_form``'s choice; a test or a benchmark may run another form
    that takes the same inputs, such as the simt one). Returns dQ, dK, dV."""
    B, H, Lq, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    pad = -(-Lq // _PAD) * _PAD
    stats = torch.empty(2, B * H * pad, device=q.device, dtype=torch.float32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    library, fn_name = BWD_FORMS[form]
    args = [ptr(q), ptr(k), ptr(v), ptr(o), ptr(do), ptr(dq), ptr(dk), ptr(dv), ptr(stats[0]),
            ptr(stats[1]), ctypes.c_int(B * H), ctypes.c_int(Lq), ctypes.c_int(k.shape[2]),
            ctypes.c_int(D), ctypes.c_float(scale)]
    if form.endswith("simt"):
        args.append(ctypes.c_int(int(q.dtype == torch.bfloat16)))
    launch("flash_attention_bwd", library, fn_name, q.device, *args, form=form)
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, do, scale: Optional[float] = None):
    """dQ, dK, dV of flash attention; the form ``bwd_form`` picks on a CUDA
    tensor, the plain version on a CPU tensor. Raises on anything the kernels
    do not take (``NotImplementedError`` for D > 160, ROADMAP item 28)."""
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
    return launch_bwd_form(bwd_form(q, k, v, do), q, k, v, o, do, scale)
