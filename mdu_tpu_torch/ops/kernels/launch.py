"""Launch counts of the port's CUDA kernels, and the one place that calls a
kernel library's C function.

Every wrapper launches its kernel through ``launch``, which adds one to
``LAUNCHES[name]`` for each launch and raises when the launch was refused.
A run resets the counts with ``reset_launches()`` and reads ``LAUNCHES``
after it, to show which kernels its path went through. Where a kernel has
more than one form, ``LAUNCHES["<name>.<form>"]`` also counts the launches of
that form (``.sm90``: the warpgroup kernels; ``.mma``: the mma.sync kernels,
of #1, #2, #3 and #6; ``flash_attention.wide`` and
``flash_attention_fm.wide``: the bf16 warpgroup kernel of heads wider than
160, and ``flash_attention_fm.wide_mma``: the fixed shift on #2's split-D
mma.sync kernel; ``flash_attention_fm_f32``, ``flash_attention_f32`` and
``fused_conv3x3_f32`` (the fp32 kernels of #1, #2 and #6): ``.sm90`` (wgmma,
three TF32 passes), ``.wide`` (mma.sync in TF32 at D > 160) and ``.simt``
(the CUDA cores)).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

LAUNCHES = {
    "flash_attention_fm": 0, "flash_attention": 0,
    "flash_attention_fm_f32": 0, "flash_attention_f32": 0,
    "flash_attention_t": 0, "fused_group_norm": 0, "fused_tile_blend": 0,
    "fused_conv3x3": 0, "fused_conv3x3_f32": 0,
    "flash_attention_fm.sm90": 0, "flash_attention_fm.mma": 0,
    "flash_attention_fm.wide": 0, "flash_attention_t.sm90": 0,
    "flash_attention_t.mma": 0, "fused_conv3x3.sm90": 0, "fused_conv3x3.mma": 0,
    "flash_attention_fm_f32.sm90": 0, "flash_attention_fm_f32.wide": 0,
    "flash_attention_fm_f32.simt": 0, "flash_attention_f32.sm90": 0,
    "flash_attention_f32.wide": 0, "flash_attention_f32.simt": 0,
    "flash_attention.wide": 0, "flash_attention.mma": 0, "flash_attention_fm.wide_mma": 0,
    "fused_conv3x3_f32.sm90": 0, "fused_conv3x3_f32.simt": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def launch(name: str, library: str, fn_name: str, device: torch.device, *args,
           form: Optional[str] = None) -> None:
    """Call ``fn_name`` of ``library`` with ``args`` (ctypes values) and the
    current stream of ``device``; counts the launch under ``name`` and, with
    ``form``, under ``name.form``."""
    from .build import load

    fn = getattr(load(library), fn_name)
    fn.argtypes = [type(a) for a in args] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    LAUNCHES[name] += 1
    if form is not None:
        LAUNCHES[f"{name}.{form}"] += 1
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")


def aligned16(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)
