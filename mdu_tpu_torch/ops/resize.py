"""Separable resize as two products with host-built interpolation matrices
(the port's copy of ``mdu_tpu/ops/resize.py``), following torch's
half-pixel conventions:

* ``nearest``: nearest-exact, src = floor((i + 0.5) * n_in / n_out);
* ``linear``:  half-pixel centres, align_corners=False;
* ``cubic``:   the Keys kernel with a = -0.75, border replicate;
* ``lanczos``: Lanczos-3, border replicate.

The matrices are built in float64 numpy and applied in fp32 on the tensor's
device: ``out = W_h @ x @ W_w^T``.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    at = np.abs(t)
    return np.where(
        at <= 1.0,
        (a + 2) * at**3 - (a + 3) * at**2 + 1,
        np.where(at < 2.0, a * at**3 - 5 * a * at**2 + 8 * a * at - 4 * a, 0.0),
    )


@lru_cache(maxsize=256)
def resize_matrix(n_in: int, n_out: int, method: str) -> np.ndarray:
    """[n_out, n_in] row-stochastic interpolation matrix (float32)."""
    W = np.zeros((n_out, n_in), dtype=np.float64)
    if n_in == n_out:
        np.fill_diagonal(W, 1.0)
        return W.astype(np.float32)
    scale = n_in / n_out
    if method == "nearest":
        src = np.floor((np.arange(n_out) + 0.5) * scale).astype(np.int64)
        W[np.arange(n_out), np.clip(src, 0, n_in - 1)] = 1.0
    elif method == "linear":
        src = (np.arange(n_out) + 0.5) * scale - 0.5
        lo = np.floor(src).astype(np.int64)
        frac = src - lo
        for i in range(n_out):
            W[i, min(max(lo[i], 0), n_in - 1)] += 1 - frac[i]
            W[i, min(max(lo[i] + 1, 0), n_in - 1)] += frac[i]
    elif method == "cubic":
        src = (np.arange(n_out) + 0.5) * scale - 0.5
        lo = np.floor(src).astype(np.int64)
        frac = src - lo
        for i in range(n_out):
            taps = _cubic_kernel(np.array([1 + frac[i], frac[i], 1 - frac[i], 2 - frac[i]]))
            taps = taps / taps.sum()
            for k in range(4):
                W[i, min(max(lo[i] - 1 + k, 0), n_in - 1)] += taps[k]
    elif method == "lanczos":
        a = 3
        src = (np.arange(n_out) + 0.5) * scale - 0.5
        lo = np.floor(src).astype(np.int64)
        frac = src - lo
        offs = np.arange(-a + 1, a + 1)
        for i in range(n_out):
            t = offs - frac[i]
            taps = np.sinc(t) * np.sinc(t / a)
            taps = taps / taps.sum()
            for k, o in enumerate(offs):
                W[i, min(max(lo[i] + o, 0), n_in - 1)] += taps[k]
    else:
        raise ValueError(f"unknown resize method: {method}")
    return W.astype(np.float32)


def resize_nchw(x: torch.Tensor, size: Tuple[int, int], method: str = "linear"):
    """Resize the trailing (H, W) of an NCHW tensor; the result has x's dtype."""
    H_out, W_out = size
    H_in, W_in = x.shape[-2], x.shape[-1]
    if (H_in, W_in) == (H_out, W_out):
        return x
    wh = torch.as_tensor(resize_matrix(H_in, H_out, method), device=x.device)
    ww = torch.as_tensor(resize_matrix(W_in, W_out, method), device=x.device)
    return torch.matmul(torch.matmul(wh, x.float()), ww.t()).to(x.dtype)
