"""Weights for the port's modules.

* ``state_dict_from_jax`` carries a JAX parameter tree across: the JAX
  package already keeps torch names and layouts (conv OIHW, linear
  [out, in]), so a ``/``-path becomes a ``.``-path and no array is
  transposed.
* ``random_state_dict`` draws random weights on the device, in the scheme of
  the JAX package's ``random_params``: zero biases, unit norm scales, zero
  ControlNet gates (every ``zero*`` module and ``cond_embedding.conv_out``),
  and uniform +-sqrt(3 / fan_in) for every other weight.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..device import resolve_device

def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(_flatten(val, name))
        else:
            out[name] = np.asarray(val)
    return out


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params": {...}}`` of numpy arrays -> a torch ``state_dict``; every
    name must exist in the target module, which
    ``load_state_dict(strict=True)`` checks."""
    tree = params["params"] if "params" in params else params
    return {name: torch.from_numpy(np.array(arr, dtype=np.float32))
            for name, arr in _flatten(tree).items()}


def load_jax_params(module: nn.Module, params: Mapping) -> nn.Module:
    """Load a JAX parameter tree into ``module`` with ``strict=True``."""
    module.load_state_dict(state_dict_from_jax(params), strict=True)
    return module


def random_state_dict(module: nn.Module, seed: int, dtype: torch.dtype = torch.float32,
                      device=None) -> Dict[str, torch.Tensor]:
    """Random weights for every entry of ``module.state_dict()``, drawn with a
    ``torch.Generator`` on ``device`` (the card unless the caller names
    another device). The module may live on the meta device; load the result
    with ``load_state_dict(..., assign=True)``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for name, ref in module.state_dict().items():
        shape = tuple(ref.shape)
        last = name.rsplit(".", 1)[-1]
        if (any(seg.startswith("zero") for seg in name.split("."))
                or "cond_embedding.conv_out" in name):
            val = torch.zeros(shape, device=device)
        elif last == "bias":
            val = torch.zeros(shape, device=device)
        elif last == "weight" and len(shape) == 1:
            val = torch.ones(shape, device=device)
        else:
            fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else int(shape[0])
            bound = float(np.sqrt(3.0 / max(fan_in, 1)))
            val = torch.rand(shape, generator=gen, device=device) * (2 * bound) - bound
        out[name] = val.to(dtype)
    return out
