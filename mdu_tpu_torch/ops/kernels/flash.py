"""Flash attention: the CUDA kernels and their plain PyTorch versions.

* ``flash_attention_fm`` replaces
  ``mdu_tpu.ops.pallas.flash_attention.flash_attention_t_fm``: a fixed shift
  ``smax`` in place of a running max, p rounded to v's dtype, and a
  denominator that sums the rounded p over the real kv columns; with
  ``bf16_exp`` the shifted score is rounded to bf16 before the exp.
* ``flash_attention`` replaces
  ``mdu_tpu.ops.pallas.flash_attention.flash_attention``: online softmax with
  an fp32 denominator of the unrounded p.
* ``flash_attention_t`` replaces
  ``mdu_tpu.ops.pallas.flash_attention.flash_attention_t``: the same online
  softmax as ``flash_attention``, with D padded only to a multiple of 16.

Each takes bf16 (tensor-core kernels ``csrc/flash_attention_fm.cu``,
``csrc/flash_attention.cu``, ``csrc/flash_attention_t.cu``) or fp32
(``csrc/flash_attention_f32.cu``), as the TPU kernels took either. Each
wrapper launches a kernel for a CUDA tensor and raises on anything the
kernels do not take; it runs the plain version only for a CPU tensor. Every
kernel launch adds one to ``LAUNCHES[name]``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .launch import LAUNCHES, aligned16, launch, ptr, reset_launches

__all__ = ["LAUNCHES", "reset_launches", "flash_attention_fm", "flash_attention",
           "flash_attention_t", "flash_attention_fm_plain", "flash_attention_plain",
           "flash_attention_t_plain"]

MAX_D = {"flash_attention_fm": 160, "flash_attention": 512, "flash_attention_t": 512,
         "flash_attention_fm_f32": 512, "flash_attention_f32": 512,
         "flash_attention_t_f32": 512}
T_MAX_D = 160    # widest head of csrc/flash_attention_t.cu; wider goes to #2
_ROWS = 1024     # query rows per chunk of the plain versions (bounds memory)


# ------------------------------------------------------------ plain versions


def flash_attention_fm_plain(q, k, v, scale: Optional[float] = None,
                             smax: float = 30.0, clamp: bool = False,
                             bf16_exp: bool = False):
    """The fixed-shift kernel's arithmetic on [B, H, L, D] tensors: fp32
    scores, p = exp(min(s, smax) - smax) cast to v's dtype (with
    ``bf16_exp``: p = bf16(exp(bf16(min(s, smax) - smax)))), fp32 products,
    denominator = sum of the cast p floored at 1e-30."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    kf, vf = k.float(), v.float()
    outs = []
    for i in range(0, q.shape[2], _ROWS):
        s = torch.matmul(q[:, :, i:i + _ROWS].float(), kf.transpose(-1, -2)) * scale
        if clamp:
            s = s.clamp(max=smax)
        if bf16_exp:
            p = torch.exp((s - smax).to(torch.bfloat16).float()).to(torch.bfloat16)
        else:
            p = torch.exp(s - smax)
        p = p.to(v.dtype).float()
        den = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
        outs.append((torch.matmul(p, vf) / den).to(q.dtype))
    return torch.cat(outs, dim=2)


def flash_attention_plain(q, k, v, scale: Optional[float] = None):
    """The online-softmax kernel's arithmetic on [B, H, L, D] tensors: fp32
    scores and softmax denominator, p cast to v's dtype for the product."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    kf, vf = k.float(), v.float()
    outs = []
    for i in range(0, q.shape[2], _ROWS):
        s = torch.matmul(q[:, :, i:i + _ROWS].float(), kf.transpose(-1, -2)) * scale
        p = torch.exp(s - s.amax(-1, keepdim=True))
        den = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
        pv = torch.matmul(p.to(v.dtype).float(), vf)
        outs.append((pv / den).to(q.dtype))
    return torch.cat(outs, dim=2)


def flash_attention_t_plain(q, k, v, scale: Optional[float] = None):
    """``flash_attention_t``'s function, which is ``flash_attention``'s: the
    TPU kernel differs from it only in its block layout."""
    return flash_attention_plain(q, k, v, scale)


# ------------------------------------------------------------------ wrappers


def _check(name: str, q, k, v) -> None:
    for n, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda":
            raise ValueError(f"{name}: {n} is on {x.device}, the kernel needs CUDA")
        if x.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"{name}: {n} is {x.dtype}, the kernels take "
                             f"bfloat16 or float32")
        if x.dim() != 4:
            raise ValueError(f"{name}: {n} must be [B, H, L, D], got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {n} must be contiguous")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"{name}: q, k, v have different dtypes")
    B, H, Lq, D = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not agree")
    max_d = MAX_D[name if q.dtype == torch.bfloat16 else name + "_f32"]
    if not (1 <= D <= max_d) or Lq == 0 or k.shape[2] == 0:
        raise ValueError(f"{name}: needs 1 <= D <= {max_d} for {q.dtype} and "
                         f"nonempty sequences, got {tuple(q.shape)} / {tuple(k.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k, v are on different devices")


def _vec_ok(q, k, v) -> ctypes.c_int:
    """16-byte copies: whole 16-byte chunks per row and aligned bases."""
    D = q.shape[-1]
    return ctypes.c_int(int(D * q.element_size() % 16 == 0 and aligned16(q, k, v)))


def _launch(name: str, library: str, fn_name: str, q, k, v, *extra):
    """Launch ``fn_name`` of ``library`` on (q, k, v, out, bh, Lq, Lk, D,
    *extra); ``extra`` holds ctypes values. Counts under ``name``."""
    B, H, Lq, D = q.shape
    out = torch.empty_like(q)
    launch(name, library, fn_name, q.device, ptr(q), ptr(k), ptr(v), ptr(out),
           ctypes.c_int(B * H), ctypes.c_int(Lq), ctypes.c_int(k.shape[2]),
           ctypes.c_int(D), *extra)
    return out


def flash_attention_fm(q, k, v, scale: Optional[float] = None,
                       smax: float = 30.0, clamp: bool = False,
                       bf16_exp: bool = False):
    """Fixed-shift flash attention on [B, H, L, D] (non-causal). In bf16 the
    kernel takes D <= 160 and raises NotImplementedError on a wider head."""
    if q.device.type == "cpu":
        return flash_attention_fm_plain(q, k, v, scale, smax, clamp, bf16_exp)
    if q.dtype == torch.bfloat16 and q.dim() == 4 and q.shape[-1] > MAX_D["flash_attention_fm"]:
        raise NotImplementedError(
            f"flash_attention_fm: D = {q.shape[-1]} in bf16 waits for ROADMAP queue 2 "
            f"(fm kernel at D > 160 in bf16)")
    _check("flash_attention_fm", q, k, v)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    args = (ctypes.c_float(scale), ctypes.c_float(smax), ctypes.c_int(int(bool(clamp))),
            ctypes.c_int(int(bool(bf16_exp))), _vec_ok(q, k, v))
    if q.dtype == torch.float32:
        return _launch("flash_attention_fm_f32", "flash_attention_f32",
                       "mdu_flash_attention_fm_f32", q, k, v, *args)
    return _launch("flash_attention_fm", "flash_attention_fm", "mdu_flash_attention_fm",
                   q, k, v, *args)


def flash_attention(q, k, v, scale: Optional[float] = None):
    """Online-softmax flash attention on [B, H, L, D] (non-causal)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    _check("flash_attention", q, k, v)
    scale = ctypes.c_float(q.shape[-1] ** -0.5 if scale is None else scale)
    if q.dtype == torch.float32:
        return _launch("flash_attention_f32", "flash_attention_f32",
                       "mdu_flash_attention_f32", q, k, v, scale, _vec_ok(q, k, v))
    return _launch("flash_attention", "flash_attention", "mdu_flash_attention",
                   q, k, v, scale, _vec_ok(q, k, v))


def flash_attention_t(q, k, v, scale: Optional[float] = None):
    """Online-softmax flash attention on [B, H, L, D] with D padded to a
    multiple of 16 (non-causal); what ``MDU_FLASH=trans`` selects.

    bf16 with D <= 160 launches ``csrc/flash_attention_t.cu`` (counted under
    ``flash_attention_t``). Two inputs go to kernels that compute the very
    same function, and count under their names: bf16 with 160 < D <= 512
    (the VAE's D = 512, where padding to 16 and to 128 coincide) launches
    ``flash_attention``'s kernel; fp32 launches ``csrc/flash_attention_f32.cu``
    (``flash_attention_f32``)."""
    if q.device.type == "cpu":
        return flash_attention_t_plain(q, k, v, scale)
    _check("flash_attention_t", q, k, v)
    if q.dtype == torch.float32 or q.shape[-1] > T_MAX_D:
        return flash_attention(q, k, v, scale)
    scale = ctypes.c_float(q.shape[-1] ** -0.5 if scale is None else scale)
    return _launch("flash_attention_t", "flash_attention_t", "mdu_flash_attention_t",
                   q, k, v, scale, _vec_ok(q, k, v))
