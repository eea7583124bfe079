"""Raw model output -> k-diffusion 'denoised' space, and CFG (counterpart of
``mdu_tpu/samplers/denoiser.py``)."""
from __future__ import annotations

from typing import Any, Callable

import torch

from .schedule import NoiseSchedule

# model_fn(x, t, cond) -> raw prediction
ModelFn = Callable[[torch.Tensor, torch.Tensor, Any], torch.Tensor]


def scalings(sigma: torch.Tensor, prediction_type: str):
    """k-diffusion c_skip / c_out / c_in for the discrete schedule."""
    s = sigma.float()
    c_in = 1.0 / torch.sqrt(s * s + 1.0)
    if prediction_type == "v_prediction":
        c_skip = 1.0 / (s * s + 1.0)
        c_out = -s * c_in
    else:
        c_skip = torch.ones_like(s)
        c_out = -s
    return c_skip, c_out, c_in


def _append_dims(x: torch.Tensor, ndim: int) -> torch.Tensor:
    x = torch.atleast_1d(x)
    return x.reshape(x.shape + (1,) * (ndim - x.dim()))


def denoised_from_model(model_fn: ModelFn, schedule: NoiseSchedule):
    """Wrap a raw model into sigma space: (x, sigma, cond) -> denoised."""

    def denoise(x, sigma, cond):
        c_skip, c_out, c_in = scalings(sigma, schedule.prediction_type)
        t = schedule.t_for_sigma(sigma)
        t_b = torch.atleast_1d(t).expand(x.shape[0])
        raw = model_fn(x * _append_dims(c_in, x.dim()), t_b, cond)
        return x * _append_dims(c_skip, x.dim()) + raw * _append_dims(c_out, x.dim())

    return denoise


def cfg_combine(den_uncond, den_cond, scale):
    return den_uncond + scale * (den_cond - den_uncond)
