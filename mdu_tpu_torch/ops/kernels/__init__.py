"""Hand-written CUDA kernels of the port, with their plain PyTorch versions
and launch counts (see ``flash.py``; built by ``build.py``)."""
from .flash import (LAUNCHES, flash_attention, flash_attention_fm,
                    flash_attention_fm_plain, flash_attention_plain,
                    reset_launches)

__all__ = ["LAUNCHES", "flash_attention", "flash_attention_fm",
           "flash_attention_fm_plain", "flash_attention_plain",
           "reset_launches"]
