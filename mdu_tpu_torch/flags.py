"""The JAX package's opt-in kernel and experiment flags, read from the
environment at call time (the JAX package reads them at trace time). Every
flag is off unless set, as in ``mdu_tpu``:

* ``MDU_FUSED_GN=1``    fused GroupNorm (``ops/kernels/group_norm.py``);
* ``MDU_FUSED_CONV=1``  fused GroupNorm affine + SiLU + conv3x3 in the UNet's
                        ResBlocks (``ops/kernels/conv3x3.py``);
* ``MDU_FUSED_BLEND=1`` fused tile blend (``ops/kernels/tile_blend.py``);
* ``MDU_FLASH=lane|trans|fm|fm16`` the flash kernel of every attention that
  takes one (``ops/attention.py::_flash_variant``);
* ``MDU_GN=fold|chanreduce`` the plain GroupNorm's formulation where no tile
  context pools its statistics (``ops/tile_context.py``);
* ``MDU_CONV_MM=9mm|im2col`` every 'same' stride-1 3x3 conv outside the
  fused kernel as matrix products (``ops/conv_mm.py``);
* ``MDU_UNET_LAYOUT=NCHW|NHWC`` the memory format of a UNet the loaders
  build (``models/unet.py::default_unet_layout``); any other value raises.

``interp`` (the JAX package's interpret mode for CPU tests) means the same as
``1``: on a CPU tensor every wrapper runs its plain version, which is what
interpret mode stands for; on a CUDA tensor it launches its kernel.
"""
from __future__ import annotations

import os
from typing import Optional

ON = ("1", "interp")


def fused_group_norm() -> bool:
    return os.environ.get("MDU_FUSED_GN") in ON


def fused_conv() -> bool:
    return os.environ.get("MDU_FUSED_CONV") in ON


def fused_blend() -> bool:
    return os.environ.get("MDU_FUSED_BLEND") in ON


def flash_override() -> Optional[str]:
    return os.environ.get("MDU_FLASH")


def gn_mode() -> Optional[str]:
    """``fold`` or ``chanreduce``; anything else is the plain GroupNorm."""
    v = os.environ.get("MDU_GN")
    return v if v in ("fold", "chanreduce") else None


def conv_mm_mode() -> Optional[str]:
    """``9mm`` or ``im2col``; anything else keeps the convolution."""
    v = os.environ.get("MDU_CONV_MM")
    return v if v in ("9mm", "im2col") else None


def unet_layout() -> str:
    """``NCHW`` (the default) or ``NHWC``, case-insensitive; raises on any
    other value, as the JAX package does."""
    v = os.environ.get("MDU_UNET_LAYOUT", "NCHW").upper()
    if v not in ("NCHW", "NHWC"):
        raise ValueError(f"MDU_UNET_LAYOUT must be NCHW or NHWC, got {v!r}")
    return v
