"""mdu_tpu_torch: the PyTorch / CUDA port of mdu_tpu for one NVIDIA H100.

The JAX package ``mdu_tpu`` is the reference. This package mirrors its module
layout and ports, slice by slice, what it does; kernels that ``mdu_tpu``
wrote in Pallas are hand-written CUDA kernels here (``csrc/``,
``ops/kernels/``). It imports neither JAX nor ``mdu_tpu``.
"""
from .config import (DemoFusionConfig, Method, SamplerConfig, TiledDiffusionConfig,
                     TiledVAEConfig)
from .device import resolve_device
from .pipeline import (DiffusionPipeline, GenerationResult, NoiseInverseCache,
                       cond_fingerprint)
from .upscale import get_upscaler, list_upscalers, register_upscaler

__all__ = ["DemoFusionConfig", "Method", "SamplerConfig", "TiledDiffusionConfig", "TiledVAEConfig",
           "resolve_device", "DiffusionPipeline", "GenerationResult", "NoiseInverseCache",
           "cond_fingerprint", "get_upscaler", "list_upscalers", "register_upscaler"]
