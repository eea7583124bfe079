"""LoRA merging (counterpart of ``mdu_tpu/models/lora.py``).

A LoRA checkpoint (kohya ``lora_unet_*`` / ``lora_te_*``, or diffusers / peft
``*.lora_A`` / ``*.lora_B``) merges into a module's ``state_dict`` as
``W += scale * (alpha / r) * up @ down``, for linear and conv weights alike,
in fp32 on the weight's device and cast back to its dtype. Per-region LoRA
(ref multidiffusion.py:180-182) is a merged ``state_dict`` per region, given
to the pipeline as ``region_unet_params`` (run through
``torch.func.functional_call`` on the same UNet).
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, Sequence, Tuple

import torch

from .loader import translate_unet_name


def _norm(name: str) -> str:
    return name.replace(".", "_")


def _collect_lora_modules(state: Mapping[str, torch.Tensor], prefix: str):
    """-> {module key (underscores): (down, up, alpha or None)}."""
    mods: Dict[str, Dict[str, torch.Tensor]] = {}
    for k, v in state.items():
        if not k.startswith(prefix):
            continue
        m = re.match(r"(.+?)\.(lora_down|lora_up|lora_A|lora_B|alpha)(?:\.weight)?$",
                     k[len(prefix):])
        if not m:
            continue
        part = {"lora_A": "lora_down", "lora_B": "lora_up"}.get(m.group(2), m.group(2))
        mods.setdefault(_norm(m.group(1)), {})[part] = torch.as_tensor(v)
    return {mod: (p["lora_down"], p["lora_up"], p.get("alpha"))
            for mod, p in mods.items() if "lora_down" in p and "lora_up" in p}


def merge_lora(state_dict: Mapping[str, torch.Tensor], lora_state: Mapping[str, torch.Tensor],
               scale: float = 1.0, prefix: str = "lora_unet_",
               translate: Callable[[str], str] = translate_unet_name) -> Dict[str, torch.Tensor]:
    """A new ``state_dict`` with the LoRA deltas merged into the weights they
    name (``state_dict`` itself when none matches); the other entries are
    the same tensors."""
    mods = _collect_lora_modules(lora_state, prefix)
    if not mods:
        return state_dict
    out = dict(state_dict)
    for name, w in state_dict.items():
        if not name.endswith(".weight"):
            continue
        base = translate(name.replace(".", "/"))
        key = _norm(base[:-len(".weight")] if base.endswith(".weight") else base)
        if key not in mods:
            continue
        down, up, alpha = mods[key]
        r = down.shape[0]
        eff = scale * (float(alpha) / r if alpha is not None else 1.0)
        dev = w.device
        delta = (up.to(dev, torch.float32).reshape(up.shape[0], -1)
                 @ down.to(dev, torch.float32).reshape(r, -1)).reshape(w.shape)
        out[name] = (w.float() + eff * delta).to(w.dtype)
    return out


def merge_loras(state_dict: Mapping[str, torch.Tensor],
                loras: Sequence[Tuple[Mapping[str, torch.Tensor], float]],
                **kw) -> Dict[str, torch.Tensor]:
    """``merge_lora`` of each (lora state, scale) in turn."""
    for lora_state, scale in loras:
        state_dict = merge_lora(state_dict, lora_state, scale, **kw)
    return state_dict
