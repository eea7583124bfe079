"""Tensor to image conversion."""
from __future__ import annotations

import numpy as np
import torch


def tensor_to_image(x) -> np.ndarray:
    """[B, 3, H, W] in [-1, 1] (tensor or array) -> uint8 [B, H, W, 3]."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    arr = np.asarray(x, dtype=np.float32)
    arr = np.clip((arr + 1.0) / 2.0, 0.0, 1.0)
    return (arr.transpose(0, 2, 3, 1) * 255.0 + 0.5).astype(np.uint8)
