"""Samplers as Python loops over a descending sigma sequence ending in 0
(counterpart of the ``lax.scan`` samplers of ``mdu_tpu/samplers/samplers.py``,
in the same step order). Each takes ``denoised_fn(x, sigma, step)``."""
from __future__ import annotations

from typing import Callable

import torch

DenoisedStepFn = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]


def sample_euler(denoised_fn: DenoisedStepFn, x: torch.Tensor,
                 sigmas: torch.Tensor) -> torch.Tensor:
    """Euler without churn: x += (x - den) / s * (s_next - s)."""
    for i in range(sigmas.shape[0] - 1):
        s, sn = sigmas[i], sigmas[i + 1]
        den = denoised_fn(x, s, i)
        d = (x - den) / s
        x = x + d * (sn - s)
    return x


def sample_ddim(denoised_fn: DenoisedStepFn, x: torch.Tensor,
                sigmas: torch.Tensor) -> torch.Tensor:
    """Deterministic DDIM (eta 0) in VE coordinates: x = den + s_next * eps."""
    for i in range(sigmas.shape[0] - 1):
        s, sn = sigmas[i], sigmas[i + 1]
        den = denoised_fn(x, s, i)
        eps = (x - den) / s
        x = den + sn * eps
    return x


SAMPLERS = {"Euler": sample_euler, "DDIM": sample_ddim}


def get_sampler(name: str):
    if name not in SAMPLERS:
        raise NotImplementedError(
            f"sampler {name!r} waits for ROADMAP queue 1, item 14; "
            f"ported: {sorted(SAMPLERS)}")
    return SAMPLERS[name]
