"""Tile fusion weight maps (the port's copy of ``mdu_tpu/utils/weights.py``):
the gaussian of Mixture of Diffusers and the feather mask, in numpy, cached
per size (ref tile_utils/utils.py:180-214)."""
from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=64)
def _gaussian_weights_np(tile_w: int, tile_h: int) -> np.ndarray:
    # separable 1-D gaussians, var 0.01, normalised by tile_w^2 on both axes,
    # x midpoint (tile_w - 1) / 2, y midpoint tile_h / 2 (ref utils.py:189-191)
    var = 0.01
    denom = float(tile_w * tile_w) * (2.0 * var)
    norm = 1.0 / np.sqrt(2.0 * np.pi * var)
    x = np.arange(tile_w, dtype=np.float64)
    y = np.arange(tile_h, dtype=np.float64)
    x_probs = np.exp(-((x - (tile_w - 1) / 2.0) ** 2) / denom) * norm
    y_probs = np.exp(-((y - tile_h / 2.0) ** 2) / denom) * norm
    return np.outer(y_probs, x_probs).astype(np.float32)


def gaussian_weights(tile_w: int, tile_h: int) -> np.ndarray:
    """[tile_h, tile_w] float32 gaussian fusion weights."""
    return _gaussian_weights_np(tile_w, tile_h)


@lru_cache(maxsize=64)
def _feather_mask_np(w: int, h: int, ratio: float) -> np.ndarray:
    # (dist / feather_radius)^2 with dist the min(row, col) distance from the
    # nearest corner, mirrored into the four quadrants
    mask = np.ones((h, w), dtype=np.float32)
    feather_radius = int(min(w // 2, h // 2) * ratio)
    if feather_radius <= 0:
        return mask
    i = np.arange(h // 2, dtype=np.float64)
    j = np.arange(w // 2, dtype=np.float64)
    dist = np.minimum.outer(i, j)
    weight = (dist / feather_radius) ** 2
    quad = np.where(dist < feather_radius, weight, 1.0).astype(np.float32)
    hh, hw = h // 2, w // 2
    mask[:hh, :hw] = quad
    mask[:hh, w - hw:] = quad[:, ::-1]
    mask[h - hh:, :hw] = quad[::-1, :]
    mask[h - hh:, w - hw:] = quad[::-1, ::-1]
    return mask


def feather_mask(w: int, h: int, ratio: float) -> np.ndarray:
    """[h, w] float32 edge-feather mask."""
    return _feather_mask_np(w, h, float(ratio))
