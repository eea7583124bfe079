"""Init-image pre-upscalers of img2img (the port's copy of
``mdu_tpu/upscale.py``): a registry of callables ``(image [B, 3, H, W] in
[-1, 1], scale) -> [B, 3, int(H * scale), int(W * scale)]`` with the
built-in resamplers. An ESRGAN checkpoint joins it through
``models/esrgan.py::register_esrgan_upscaler``."""
from __future__ import annotations

from typing import Callable, Dict

import torch

from .ops.resize import resize_nchw

Upscaler = Callable[[torch.Tensor, float], torch.Tensor]

_REGISTRY: Dict[str, Upscaler] = {}


def register_upscaler(name: str, fn: Upscaler) -> None:
    _REGISTRY[name] = fn


def get_upscaler(name: str) -> Upscaler:
    if name not in _REGISTRY:
        raise KeyError(f"unknown upscaler '{name}'; available: {list(_REGISTRY)}")
    return _REGISTRY[name]


def list_upscalers():
    return list(_REGISTRY)


def _resize_upscaler(method: str) -> Upscaler:
    def fn(x: torch.Tensor, scale: float) -> torch.Tensor:
        H, W = x.shape[-2], x.shape[-1]
        return resize_nchw(x, (int(H * scale), int(W * scale)), method)
    return fn


register_upscaler("None", lambda x, s: x)
register_upscaler("Nearest", _resize_upscaler("nearest"))
register_upscaler("Bilinear", _resize_upscaler("linear"))
register_upscaler("Bicubic", _resize_upscaler("cubic"))
register_upscaler("Lanczos", _resize_upscaler("lanczos"))
