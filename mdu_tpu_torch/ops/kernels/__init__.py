"""Hand-written CUDA kernels of the port, with their plain PyTorch versions
and launch counts (``launch.py``; built by ``build.py``)."""
from .conv3x3 import (conv3x3_plan_fits, fused_conv3x3, fused_conv3x3_plain,
                      pack_conv3x3_weight)
from .flash import (flash_attention, flash_attention_fm, flash_attention_fm_plain,
                    flash_attention_plain, flash_attention_t, flash_attention_t_plain)
from .flash_bwd import flash_attention_bwd, flash_attention_bwd_plain
from .group_norm import fused_group_norm, fused_group_norm_plain
from .launch import LAUNCHES, reset_launches
from .tile_blend import BlendTable, fused_tile_blend, fused_tile_blend_plain

__all__ = ["LAUNCHES", "reset_launches", "flash_attention", "flash_attention_fm",
           "flash_attention_fm_plain", "flash_attention_plain", "flash_attention_t",
           "flash_attention_t_plain", "flash_attention_bwd", "flash_attention_bwd_plain",
           "fused_group_norm", "fused_group_norm_plain",
           "BlendTable", "fused_tile_blend", "fused_tile_blend_plain",
           "conv3x3_plan_fits", "fused_conv3x3", "fused_conv3x3_plain",
           "pack_conv3x3_weight"]
