"""Guided-filter retouch mask of noise inversion (the port's copy of
``mdu_tpu/utils/guided_filter.py``; ref tile_utils/utils.py:216-247): a
guided filter of a grayscale image against itself with a k x k box blur,
whose residual ``|gf - img|`` marks the detail where fresh noise goes back
in. Host-side numpy, run once per img2img call."""
from __future__ import annotations

import numpy as np


def _box_blur(img: np.ndarray, k: int) -> np.ndarray:
    """k x k normalised box filter with reflect-101 borders (cv2.blur): the
    window of output i covers input [i - k//2, i - k//2 + k - 1]; an
    integral image makes it O(pixels)."""
    if k <= 1:
        return img.astype(np.float64)
    lo = k // 2
    hi = k - lo - 1
    padded = np.pad(img.astype(np.float64), ((lo, hi), (lo, hi)), mode="reflect")
    sat = np.zeros((padded.shape[0] + 1, padded.shape[1] + 1), dtype=np.float64)
    np.cumsum(padded, axis=0, out=sat[1:, 1:])
    np.cumsum(sat[1:, 1:], axis=1, out=sat[1:, 1:])
    h, w = img.shape
    s = sat[k:k + h, k:k + w] - sat[0:h, k:k + w] - sat[k:k + h, 0:w] + sat[0:h, 0:w]
    return s / float(k * k)


def get_retouch_mask(img_u8: np.ndarray, kernel_size: int) -> np.ndarray:
    """Guided-filter detail mask in [0, 1] (float32) from a grayscale uint8
    image: mean and variance by box blur, ridge 0.01, and the residual
    quantised to uint8 as the reference does."""
    img = img_u8.astype(np.float64) / 255.0
    mean_i = _box_blur(img, kernel_size)
    mean_ii = _box_blur(img * img, kernel_size)
    var_i = mean_ii - mean_i * mean_i
    a = var_i / (var_i + 0.01)
    b = mean_i - a * mean_i
    gf = (a * img + b - img) * 255.0
    gf = np.clip(gf, 0, 255).astype(np.uint8)
    return gf.astype(np.float32) / 255.0
