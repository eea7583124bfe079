"""Gaussian blur of DemoFusion's global views (counterpart of
``mdu_tpu/ops/blur.py``; ref tile_methods/demofusion.py:164-178).

Two separable depthwise 1-D convolutions in fp32 with zero padding, which
equal the reference's single 2-D conv with the outer product of the taps.
No Pallas kernel computes it in the JAX package either.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def gaussian_kernel_1d(kernel_size: int, sigma) -> torch.Tensor:
    """Normalised 1-D gaussian taps [kernel_size] in fp32 on sigma's device
    (ref demofusion.py:164-171)."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32)
    x = torch.arange(kernel_size, dtype=torch.float32, device=sigma.device)
    g = torch.exp(-((x - (kernel_size - 1) / 2.0) ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def gaussian_blur_nchw(x: torch.Tensor, kernel_size: int, sigma) -> torch.Tensor:
    """Separable depthwise gaussian blur with zero ('same') padding; the
    result has x's dtype."""
    C = x.shape[1]
    k1 = gaussian_kernel_1d(kernel_size, torch.as_tensor(sigma, device=x.device))
    pad = kernel_size // 2
    out = F.conv2d(x.float(), k1.reshape(1, 1, kernel_size, 1).repeat(C, 1, 1, 1),
                   padding=(pad, 0), groups=C)
    out = F.conv2d(out, k1.reshape(1, 1, 1, kernel_size).repeat(C, 1, 1, 1),
                   padding=(0, pad), groups=C)
    return out.to(x.dtype)
