"""Image <-> tensor conversions and the latent RGB preview (the port's copy
of ``mdu_tpu/utils/image.py``)."""
from __future__ import annotations

import numpy as np
import torch

# SD-1.x latent -> RGB linear approximation (A1111 cheap_approximation coefs)
_LATENT_RGB = np.array([
    [0.298, 0.207, 0.208],
    [0.187, 0.286, 0.173],
    [-0.158, 0.189, 0.264],
    [-0.184, -0.271, -0.473],
], dtype=np.float32)


def image_to_tensor(img_u8: np.ndarray) -> torch.Tensor:
    """uint8 [H, W, 3] (or [H, W, 4], alpha flattened on white, or [H, W]
    grey) -> fp32 [1, 3, H, W] in [-1, 1] on the CPU."""
    img = np.asarray(img_u8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.shape[-1] == 4:
        alpha = img[..., 3:4].astype(np.float32) / 255.0
        rgb = img[..., :3].astype(np.float32)
        img = rgb * alpha + 255.0 * (1 - alpha)
    x = img.astype(np.float32) / 255.0 * 2.0 - 1.0
    return torch.from_numpy(np.ascontiguousarray(x.transpose(2, 0, 1)[None]))


def tensor_to_image(x) -> np.ndarray:
    """[B, 3, H, W] in [-1, 1] (tensor or array) -> uint8 [B, H, W, 3]."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    arr = np.asarray(x, dtype=np.float32)
    arr = np.clip((arr + 1.0) / 2.0, 0.0, 1.0)
    return (arr.transpose(0, 2, 3, 1) * 255.0 + 0.5).astype(np.uint8)


def cheap_latent_preview(z: torch.Tensor) -> torch.Tensor:
    """[B, 4, h, w] latents -> [B, 3, h, w] rough RGB in [-1, 1] (no VAE)."""
    coefs = torch.as_tensor(_LATENT_RGB, device=z.device)
    return torch.einsum("bchw,cd->bdhw", z.float(), coefs)


def grayscale_u8(img_u8: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] -> uint8 [H, W] luma (PIL 'L' convention)."""
    img = np.asarray(img_u8)
    if img.ndim == 2:
        return img
    f = img[..., :3].astype(np.float32)
    return (f @ np.array([0.299, 0.587, 0.114], np.float32)).astype(np.uint8)


def hint_to_tensor(img_u8: np.ndarray) -> torch.Tensor:
    """uint8 [H, W, 3] (or [H, W] grey) -> fp32 [1, 3, H, W] in [0, 1] on the
    CPU: the ControlNet hint range."""
    img = np.asarray(img_u8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    x = img[..., :3].astype(np.float32) / 255.0
    return torch.from_numpy(np.ascontiguousarray(x.transpose(2, 0, 1)[None]))
