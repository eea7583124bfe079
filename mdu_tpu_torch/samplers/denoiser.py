"""Raw model output -> k-diffusion 'denoised' space, and CFG (counterpart of
``mdu_tpu/samplers/denoiser.py``).

DeepCache (``denoised_from_model_cached``): a cached call either runs the
full UNet and returns its deep feature as the new cache, or runs the shallow
pass from the cache it is given. The JAX package picks the branch with
``lax.cond`` and threads the caches through the samplers' scans; here the
pipeline's denoiser keeps them (one per tile batch) and decides from the
step index the samplers pass, so the samplers' bodies stay as they are. A
denoised function that keeps such state says so with ``deepcache = True``
(``mark_deepcache``), which the samplers that split their schedule on the
host refuse.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from ..tiling.conds import concat_conds
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


def denoised_from_model_cached(model_fn, schedule: NoiseSchedule, cache_branch: int = 1):
    """``denoise(x, sigma, cond, cache, is_cached) -> (denoised, cache)``:
    ``is_cached`` runs the shallow pass from ``cache``; otherwise the full
    UNet runs and its feature, in ``cache``'s dtype, is the new cache. A
    feature of another shape than ``cache`` raises."""

    def denoise(x, sigma, cond, cache, is_cached: bool):
        c_skip, c_out, c_in = scalings(sigma, schedule.prediction_type)
        t = schedule.t_for_sigma(sigma)
        t_b = torch.atleast_1d(t).expand(x.shape[0])
        xin = x * _append_dims(c_in, x.dim())
        if is_cached:
            raw = model_fn(xin, t_b, cond, cache=cache, cache_mode="read",
                           cache_branch=cache_branch)
        else:
            raw, f = model_fn(xin, t_b, cond, cache_mode="write", cache_branch=cache_branch)
            if tuple(f.shape) != tuple(cache.shape):
                raise ValueError(f"DeepCache feature of shape {tuple(f.shape)} for a cache of "
                                 f"shape {tuple(cache.shape)}")
            cache = f.to(cache.dtype)
        den = x * _append_dims(c_skip, x.dim()) + raw * _append_dims(c_out, x.dim())
        return den, cache

    return denoise


def mark_deepcache(fn):
    """``fn`` marked as a denoised function that keeps DeepCache state."""
    fn.deepcache = True
    return fn


def cfg_combine(den_uncond, den_cond, scale):
    return den_uncond + scale * (den_cond - den_uncond)


@dataclass
class GuidedDenoiser:
    """Classifier-free-guided denoiser in sigma space: ``__call__`` batches
    [uncond; cond] into one model call and combines; ``denoise_with_cond``
    evaluates one cond."""

    model_fn: ModelFn
    schedule: NoiseSchedule
    cond: Any
    uncond: Optional[Any]
    cfg_scale: float = 7.0

    def __post_init__(self):
        self._denoise = denoised_from_model(self.model_fn, self.schedule)

    def denoise_with_cond(self, x, sigma, cond):
        return self._denoise(x, sigma, cond)

    def __call__(self, x, sigma):
        if self.uncond is None or self.cfg_scale == 1.0:
            return self._denoise(x, sigma, self.cond)
        s2 = torch.atleast_1d(sigma).expand(x.shape[0])
        den = self._denoise(torch.cat([x, x]), torch.cat([s2, s2]),
                            concat_conds(self.uncond, self.cond))
        den_u, den_c = den.chunk(2)
        return cfg_combine(den_u, den_c, self.cfg_scale)
