"""The JAX package's opt-in kernel flags, read from the environment at call
time (the JAX package reads them at trace time). Every flag is off unless
set, as in ``mdu_tpu``:

* ``MDU_FUSED_GN=1``    fused GroupNorm (``ops/kernels/group_norm.py``);
* ``MDU_FUSED_CONV=1``  fused GroupNorm affine + SiLU + conv3x3 in the UNet's
                        ResBlocks (``ops/kernels/conv3x3.py``);
* ``MDU_FUSED_BLEND=1`` fused tile blend (``ops/kernels/tile_blend.py``);
* ``MDU_FLASH=lane|trans|fm|fm16`` the flash kernel of every attention that
  takes one (``ops/attention.py::_flash_variant``).

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
