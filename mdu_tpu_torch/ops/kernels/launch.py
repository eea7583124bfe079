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
(the CUDA cores); ``fused_group_norm``: ``.cluster`` and ``.two_read``).
``flash_attention_bwd`` counts the calls of the attention backward, and
``.f32_sm90`` / ``.bf16_sm90`` (the tensor-core forms, two kernels a call) and
``.f32_simt`` / ``.bf16_simt`` (the CUDA cores, three) the calls of each form.
``fused_tile_blend_floor`` counts the empty kernel that measures #5's launch
floor (never on a pipeline's path).

The host's part of a launch is most of the time of the small kernels (#4 at
config 2's narrow levels, #5), so ``launch`` resolves each C function and
its argument types once, per loaded library, and enters a device context
only for a tensor off the current device.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from . import build

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
    "fused_group_norm.cluster": 0, "fused_group_norm.two_read": 0,
    "fused_tile_blend_floor": 0,
    "flash_attention_bwd": 0, "flash_attention_bwd.f32_sm90": 0,
    "flash_attention_bwd.bf16_sm90": 0, "flash_attention_bwd.f32_simt": 0,
    "flash_attention_bwd.bf16_simt": 0,
}
# (loaded library, C function name) -> the function, its argtypes set
_FNS: Dict[Tuple[ctypes.CDLL, str], ctypes._CFuncPtr] = {}
# the counts are read-modify-writes, and the tile shards' threads launch
# kernels together
_COUNT_LOCK = threading.Lock()


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _function(library: str, fn_name: str, args) -> ctypes._CFuncPtr:
    """``fn_name`` of the loaded ``library`` with its argtypes (those of
    ``args`` and the stream) and restype set, on its first call only."""
    lib = build.load(library)
    fn = _FNS.get((lib, fn_name))
    if fn is None:
        fn = getattr(lib, fn_name)
        fn.argtypes = [type(a) for a in args] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[lib, fn_name] = fn
    return fn


def _raw_stream(index: int) -> int:
    """The current stream of device ``index`` as a cudaStream_t."""
    return torch._C._cuda_getCurrentRawStream(index)


def launch(name: str, library: str, fn_name: str, device: torch.device, *args,
           form: Optional[str] = None) -> None:
    """Call ``fn_name`` of ``library`` with ``args`` (ctypes values) and the
    current stream of ``device``; counts the launch under ``name`` and, with
    ``form``, under ``name.form``."""
    fn = _function(library, fn_name, args)
    if device.index == torch.cuda.current_device():
        err = fn(*args, _raw_stream(device.index))
    else:
        with torch.cuda.device(device):
            err = fn(*args, _raw_stream(device.index))
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        if form is not None:
            LAUNCHES[f"{name}.{form}"] += 1
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")


def refuse_grad(name: str, why: str, *tensors) -> None:
    """Raise where autograd would need a gradient through kernel ``name``,
    which has no backward kernel: its output would carry none."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(f"{name} has no backward kernel, and an input requires "
                                  f"grad: {why}")


def aligned16(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)
