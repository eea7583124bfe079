"""Launch counts of the port's CUDA kernels, and the one place that calls a
kernel library's C function.

Every wrapper launches its kernel through ``launch``, which adds one to
``LAUNCHES[name]`` for each launch and raises when the launch was refused.
A run resets the counts with ``reset_launches()`` and reads ``LAUNCHES``
after it, to show which kernels its path went through.
"""
from __future__ import annotations

import ctypes

import torch

LAUNCHES = {
    "flash_attention_fm": 0, "flash_attention": 0,
    "flash_attention_fm_f32": 0, "flash_attention_f32": 0,
    "flash_attention_t": 0, "fused_group_norm": 0, "fused_tile_blend": 0,
    "fused_conv3x3": 0, "fused_conv3x3_f32": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def launch(name: str, library: str, fn_name: str, device: torch.device, *args) -> None:
    """Call ``fn_name`` of ``library`` with ``args`` (ctypes values) and the
    current stream of ``device``; counts the launch under ``name``."""
    from .build import load

    fn = getattr(load(library), fn_name)
    fn.argtypes = [type(a) for a in args] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    LAUNCHES[name] += 1
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")


def aligned16(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)
