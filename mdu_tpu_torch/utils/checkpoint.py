"""Weight checkpoints and the NaN guard (counterpart of
``mdu_tpu/utils/checkpoint.py``).

The JAX package saves parameter trees with orbax; the port saves a
``state_dict`` as one ``.safetensors`` file through its own writer
(``models/safetensors.py``). An orbax checkpoint directory is not readable
here: export the JAX parameters to ``.safetensors`` first
(``scripts/export_params.py``).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from ..models.safetensors import load_file, save_file


def save_params(path: str, params: Union[Mapping[str, torch.Tensor], nn.Module]) -> None:
    """Write a ``state_dict`` (or a module's) to ``path``, bit for bit."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    save_file(dict(params), path)


def load_params(path: str, like: Optional[Union[Mapping[str, torch.Tensor], nn.Module]] = None
                ) -> Dict[str, torch.Tensor]:
    """The tensors of ``path`` on the CPU; with ``like`` (a ``state_dict`` or
    a module) the same names are required, each tensor of ``like``'s shape,
    and each is returned on ``like``'s device in its dtype."""
    loaded = load_file(path)
    if like is None:
        return loaded
    if isinstance(like, nn.Module):
        like = like.state_dict()
    if set(loaded) != set(like):
        missing, extra = sorted(set(like) - set(loaded)), sorted(set(loaded) - set(like))
        raise KeyError(f"{path}: missing {missing[:3]}, unexpected {extra[:3]}")
    out = {}
    for k, ref in like.items():
        if tuple(loaded[k].shape) != tuple(ref.shape):
            raise ValueError(f"{path}: {k} has shape {tuple(loaded[k].shape)}, "
                             f"expected {tuple(ref.shape)}")
        out[k] = loaded[k].to(ref.device, ref.dtype)
    return out


def check_finite(x, label: str = "tensor"):
    """Host-side NaN/Inf abort (ref devices.test_for_nans, tilevae.py:625):
    raises with a clear message instead of letting a black image through.
    Returns ``x``."""
    arr = x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if not np.isfinite(arr).all():
        n_nan = int(np.isnan(arr).sum())
        n_inf = int(np.isinf(arr).sum())
        raise FloatingPointError(
            f"NaN/Inf detected in {label}: {n_nan} NaNs, {n_inf} Infs "
            f"(shape {arr.shape}) — for fp16-style overflows use bf16 weights "
            "or fp32 GroupNorm stats (enabled by default)")
    return x
