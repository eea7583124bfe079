"""Weights for the port's modules.

* ``state_dict_from_jax`` carries a JAX parameter tree across: the JAX
  package already keeps torch names and layouts (conv OIHW, linear
  [out, in]), so a ``/``-path becomes a ``.``-path and no array is
  transposed.
* ``random_state_dict`` draws random weights on the device, in the scheme of
  the JAX package's ``random_params``: zero biases, unit norm scales, and
  uniform +-sqrt(3 / fan_in) for every other weight.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from ..device import resolve_device

# parts of the JAX AutoencoderKL tree that the decode-only port does not hold
VAE_ENCODER_PREFIXES = ("encoder.", "quant_conv.")


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(_flatten(val, name))
        else:
            out[name] = np.asarray(val)
    return out


def state_dict_from_jax(params: Mapping,
                        drop_prefixes: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """``{"params": {...}}`` of numpy arrays -> a torch ``state_dict``.

    Entries whose name starts with one of ``drop_prefixes`` are left out
    (``VAE_ENCODER_PREFIXES`` for the decode-only VAE); any other name must
    exist in the target module, which ``load_state_dict(strict=True)``
    checks.
    """
    tree = params["params"] if "params" in params else params
    out: Dict[str, torch.Tensor] = {}
    for name, arr in _flatten(tree).items():
        if any(name.startswith(p) for p in drop_prefixes):
            continue
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return out


def load_jax_params(module: nn.Module, params: Mapping,
                    drop_prefixes: Sequence[str] = ()) -> nn.Module:
    """Load a JAX parameter tree into ``module`` with ``strict=True``."""
    module.load_state_dict(state_dict_from_jax(params, drop_prefixes), strict=True)
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
        if last == "bias":
            val = torch.zeros(shape, device=device)
        elif last == "weight" and len(shape) == 1:
            val = torch.ones(shape, device=device)
        else:
            fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else int(shape[0])
            bound = float(np.sqrt(3.0 / max(fan_in, 1)))
            val = torch.rand(shape, generator=gen, device=device) * (2 * bound) - bound
        out[name] = val.to(dtype)
    return out
