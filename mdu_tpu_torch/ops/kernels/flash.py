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

In bf16, each of the three has more than one form, chosen by ``bf16_form``
on shape and alignment alone (never on a failure), each counted also under
``LAUNCHES["<name>.<form>"]``:

* ``sm90`` (``flash_attention_fm``, ``flash_attention_t``): the warpgroup
  kernel (``csrc/flash_attention_sm90.cuh``: wgmma, TMA, ping-pong
  consumers) for D % 8 == 0, 16 <= D <= 160 and 16-byte aligned q, k, v (a
  tensor map needs 16-byte strides and bases);
* ``wide`` (``flash_attention_fm``, ``flash_attention``): the warpgroup
  kernel of wide heads (``csrc/flash_attention_wide_sm90.cuh``: wgmma, TMA,
  two consumers splitting D) for D % 8 == 0, 160 < D <= 512 and 16-byte
  aligned q, k, v;
* ``mma``: the ``mma.sync`` kernels for any other input: of #1 and #3 up to
  D = 160, and ``flash_attention``'s split-D kernel up to D = 512;
* ``wide_mma`` (``flash_attention_fm``): the fixed shift on that split-D
  kernel, for any other input with 160 < D <= 512.

In fp32, ``flash_attention_fm`` and ``flash_attention`` (and through it
``flash_attention_t``) have three forms each, chosen by ``f32_form`` in the
same way and counted under ``LAUNCHES["flash_attention_fm_f32.<form>"]`` and
``LAUNCHES["flash_attention_f32.<form>"]``; the two tensor-core forms run
every product as three TF32 products (big.small + small.big + big.big), which
keeps fp32's precision (``csrc/flash_attention_f32_sm90.cuh``):

* ``sm90``: wgmma and TMA, for D % 4 == 0, D <= 160 and 16-byte aligned q,
  k, v (a tensor map needs 16-byte strides and bases);
* ``wide``: mma.sync in TF32 on a split-D layout, the same alignment with
  160 < D <= 512;
* ``simt``: anything else, on the CUDA cores (``csrc/flash_attention_f32.cu``).

PyTorch's own fp32 matmuls stay out of TF32 in the parity runs (a reference
sets ``allow_tf32`` False); these kernels are held to 1e-4 of the fp32 plain
version instead.

Gradients: where grad mode is on and q, k or v requires grad, each wrapper
runs its forward kernel inside a ``torch.autograd.Function`` that saves q,
k, v and the output, and whose backward launches the form of the backward
that ``flash_bwd.bwd_form`` picks (``flash_bwd.py``: f32_sm90 and bf16_sm90
on the tensor cores, f32_simt and bf16_simt on the CUDA cores): the gradient
of exact softmax attention, for D <= 160. Without grad the forward runs as
it is.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .flash_bwd import BWD_MAX_D, flash_attention_bwd, flash_attention_bwd_plain
from .launch import LAUNCHES, aligned16, launch, ptr, reset_launches

__all__ = ["LAUNCHES", "reset_launches", "flash_attention_fm", "flash_attention",
           "flash_attention_t", "flash_attention_fm_plain", "flash_attention_plain",
           "flash_attention_t_plain", "bf16_form", "launch_form", "f32_form",
           "launch_f32_form", "flash_attention_bwd", "flash_attention_bwd_plain"]

MAX_D = {"flash_attention_fm": 512, "flash_attention": 512, "flash_attention_t": 512,
         "flash_attention_fm_f32": 512, "flash_attention_f32": 512,
         "flash_attention_t_f32": 512}
MMA_MAX_D = 160  # widest head of the mma.sync and warpgroup forms of #1 and #3
# (library, C function) of each bf16 form of each kernel
FORMS = {
    "flash_attention_fm": {
        "sm90": ("flash_attention_fm", "mdu_flash_attention_fm_sm90"),
        "mma": ("flash_attention_fm", "mdu_flash_attention_fm"),
        "wide": ("flash_attention", "mdu_flash_attention_fm_wide"),
        "wide_mma": ("flash_attention", "mdu_flash_attention_fm_wide_mma")},
    "flash_attention": {
        "wide": ("flash_attention", "mdu_flash_attention_wide"),
        "mma": ("flash_attention", "mdu_flash_attention")},
    "flash_attention_t": {
        "sm90": ("flash_attention_t", "mdu_flash_attention_t_sm90"),
        "mma": ("flash_attention_t", "mdu_flash_attention_t")},
}
WARPGROUP_FORMS = ("sm90", "wide")  # the forms that take no ``vec`` argument
# C function of each fp32 form of the two fp32 kernels (library flash_attention_f32)
F32_FORMS = {
    "flash_attention_fm_f32": {"sm90": "mdu_flash_attention_fm_f32_sm90",
                               "wide": "mdu_flash_attention_fm_f32_wide",
                               "simt": "mdu_flash_attention_fm_f32"},
    "flash_attention_f32": {"sm90": "mdu_flash_attention_f32_sm90",
                            "wide": "mdu_flash_attention_f32_wide",
                            "simt": "mdu_flash_attention_f32"},
}
F32_SM90_MAX_D = 160  # widest head of the fp32 warpgroup form
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


class _WithBackward(torch.autograd.Function):
    """A forward kernel's output whose gradient comes from the backward
    kernel (``flash_attention_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, run, scale):
        o = run(q, k, v)
        ctx.save_for_backward(q, k, v, o)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(), ctx.scale)
        return dq, dk, dv, None, None


def _differentiable(name: str, run, q, k, v, scale: Optional[float], clamp: bool = False):
    """``run(q, k, v)``, inside ``_WithBackward`` where autograd needs its
    gradient. Refuses what the backward kernel does not compute: heads wider
    than 160 (ROADMAP item 28) and the clamped shift."""
    if not (torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)):
        return run(q, k, v)
    if q.shape[-1] > BWD_MAX_D:
        raise NotImplementedError(f"{name}: heads wider than {BWD_MAX_D} (D = "
                                  f"{q.shape[-1]}) have no backward kernel yet (ROADMAP "
                                  f"item 28)")
    if clamp:
        raise NotImplementedError(f"{name}: the clamped shift has no backward kernel")
    return _WithBackward.apply(q, k, v, run, q.shape[-1] ** -0.5 if scale is None else scale)



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


def _launch(name: str, library: str, fn_name: str, q, k, v, *extra,
            form: Optional[str] = None):
    """Launch ``fn_name`` of ``library`` on (q, k, v, out, bh, Lq, Lk, D,
    *extra); ``extra`` holds ctypes values. Counts under ``name`` (and
    ``name.form``)."""
    B, H, Lq, D = q.shape
    out = torch.empty_like(q)
    launch(name, library, fn_name, q.device, ptr(q), ptr(k), ptr(v), ptr(out),
           ctypes.c_int(B * H), ctypes.c_int(Lq), ctypes.c_int(k.shape[2]),
           ctypes.c_int(D), *extra, form=form)
    return out


def bf16_form(name: str, q, k, v) -> str:
    """The form of kernel ``name`` that takes bf16 q, k, v. With D % 8 == 0
    and 16-byte aligned bases: ``sm90`` for 16 <= D <= 160 (#1, #3), ``wide``
    for 160 < D <= 512 (#1, #2). Otherwise ``mma``, which for #1 above D =
    160 is ``wide_mma``."""
    D = q.shape[-1]
    if D % 8 == 0 and aligned16(q, k, v):
        if D > MMA_MAX_D:
            return "wide"
        if D >= 16 and name != "flash_attention":
            return "sm90"
    return "wide_mma" if name == "flash_attention_fm" and D > MMA_MAX_D else "mma"


def launch_form(name: str, form: str, q, k, v, scale: Optional[float] = None,
                smax: float = 30.0, clamp: bool = False, bf16_exp: bool = False):
    """Launch one bf16 form of ``name`` on checked inputs (the wrappers pass
    ``bf16_form``'s choice; a benchmark may time another form that takes the
    same inputs)."""
    library, fn_name = FORMS[name][form]
    args = [ctypes.c_float(q.shape[-1] ** -0.5 if scale is None else scale)]
    if name == "flash_attention_fm":
        args += [ctypes.c_float(smax), ctypes.c_int(int(bool(clamp))),
                 ctypes.c_int(int(bool(bf16_exp)))]
    if form not in WARPGROUP_FORMS:
        args.append(_vec_ok(q, k, v))
    return _launch(name, library, fn_name, q, k, v, *args, form=form)


def f32_form(name: str, q, k, v) -> str:
    """The form of fp32 kernel ``name`` (``flash_attention_fm_f32`` or
    ``flash_attention_f32``) that takes q, k, v: ``sm90`` for D % 4 == 0, D <=
    160 and 16-byte aligned bases; ``wide`` for the same with D > 160; else
    ``simt``."""
    D = q.shape[-1]
    if D % 4 == 0 and aligned16(q, k, v):
        return "sm90" if D <= F32_SM90_MAX_D else "wide"
    return "simt"


def launch_f32_form(name: str, form: str, q, k, v, scale: Optional[float] = None,
                    smax: float = 30.0, clamp: bool = False, bf16_exp: bool = False):
    """Launch one form of fp32 kernel ``name`` on checked inputs (the wrappers
    pass ``f32_form``'s choice; a benchmark may time another form that takes
    the same inputs, such as ``simt``)."""
    args = [ctypes.c_float(q.shape[-1] ** -0.5 if scale is None else scale)]
    if name == "flash_attention_fm_f32":
        args += [ctypes.c_float(smax), ctypes.c_int(int(bool(clamp))),
                 ctypes.c_int(int(bool(bf16_exp)))]
    if form == "simt":
        args.append(_vec_ok(q, k, v))
    return _launch(name, "flash_attention_f32", F32_FORMS[name][form], q, k, v, *args,
                   form=form)


def flash_attention_fm(q, k, v, scale: Optional[float] = None,
                       smax: float = 30.0, clamp: bool = False,
                       bf16_exp: bool = False):
    """Fixed-shift flash attention on [B, H, L, D] (non-causal), D <= 512.
    bf16 launches the form ``bf16_form`` picks; fp32 the form ``f32_form``
    picks."""
    if q.device.type == "cpu":
        return flash_attention_fm_plain(q, k, v, scale, smax, clamp, bf16_exp)
    _check("flash_attention_fm", q, k, v)

    def run(q, k, v):
        if q.dtype == torch.float32:
            name = "flash_attention_fm_f32"
            return launch_f32_form(name, f32_form(name, q, k, v), q, k, v, scale, smax,
                                   clamp, bf16_exp)
        return launch_form("flash_attention_fm", bf16_form("flash_attention_fm", q, k, v),
                           q, k, v, scale, smax, clamp, bf16_exp)

    return _differentiable("flash_attention_fm", run, q, k, v, scale, clamp)


def flash_attention(q, k, v, scale: Optional[float] = None):
    """Online-softmax flash attention on [B, H, L, D] (non-causal). bf16
    launches the form ``bf16_form`` picks; fp32 the form ``f32_form``
    picks."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    _check("flash_attention", q, k, v)

    def run(q, k, v):
        if q.dtype == torch.float32:
            name = "flash_attention_f32"
            return launch_f32_form(name, f32_form(name, q, k, v), q, k, v, scale)
        return launch_form("flash_attention", bf16_form("flash_attention", q, k, v),
                           q, k, v, scale)

    return _differentiable("flash_attention", run, q, k, v, scale)


def flash_attention_t(q, k, v, scale: Optional[float] = None):
    """Online-softmax flash attention on [B, H, L, D] with D padded to a
    multiple of 16 (non-causal); what ``MDU_FLASH=trans`` selects.

    bf16 with D <= 160 launches ``csrc/flash_attention_t.cu``, the form
    ``bf16_form`` picks (counted under ``flash_attention_t``). Two inputs go
    to kernels that compute the very same function, and count under their
    names: bf16 with 160 < D <= 512
    (the VAE's D = 512, where padding to 16 and to 128 coincide) launches
    the form of ``flash_attention`` that ``bf16_form`` picks; fp32 launches
    the fp32 form of ``flash_attention`` that ``f32_form`` picks
    (``flash_attention_f32``)."""
    if q.device.type == "cpu":
        return flash_attention_t_plain(q, k, v, scale)
    _check("flash_attention_t", q, k, v)
    if q.dtype == torch.float32 or q.shape[-1] > MMA_MAX_D:   # #2's kernel
        return flash_attention(q, k, v, scale)
    return _differentiable(
        "flash_attention_t",
        lambda q, k, v: launch_form("flash_attention_t", bf16_form("flash_attention_t", q, k, v),
                                    q, k, v, scale),
        q, k, v, scale)
