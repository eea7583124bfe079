"""Noise schedule and sigma tables (counterpart of
``mdu_tpu/samplers/schedule.py``): k-diffusion's discrete VE wrapping of the
DDPM schedule, sigma_t = sqrt((1 - abar_t) / abar_t)."""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class NoiseSchedule:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"          # epsilon | v_prediction

    @property
    def alphas_cumprod(self) -> np.ndarray:
        return _alphas_cumprod(self.num_train_timesteps, self.beta_start,
                               self.beta_end, self.beta_schedule)

    @property
    def sigmas(self) -> np.ndarray:
        """Per-timestep sigma table [T], ascending with t."""
        ac = self.alphas_cumprod
        return np.sqrt((1.0 - ac) / ac)

    def t_for_sigma(self, sigma: torch.Tensor) -> torch.Tensor:
        """Fractional timestep for a sigma: linear interpolation of log sigma
        into the table, clamped at both ends like ``jnp.interp``."""
        table = torch.as_tensor(np.log(self.sigmas), dtype=torch.float32,
                                device=sigma.device)
        log_s = torch.log(torch.clamp(sigma.float(), min=1e-10)).reshape(-1)
        n = table.shape[0]
        hi = torch.searchsorted(table, log_s).clamp(1, n - 1)
        lo = hi - 1
        x0, x1 = table[lo], table[hi]
        idx = lo.float() + (log_s - x0) / (x1 - x0)
        idx = torch.where(log_s <= table[0], torch.zeros_like(idx), idx)
        idx = torch.where(log_s >= table[-1], torch.full_like(idx, n - 1.0), idx)
        return idx.reshape(sigma.shape)

    def sampling_sigmas(self, steps: int, schedule: str = "automatic") -> np.ndarray:
        """[steps + 1] descending sigmas ending at 0. ``"karras"`` is the
        Karras et al. rho = 7 ramp between the table's ends; any other name,
        as in the JAX package, gives k-diffusion's discrete schedule: evenly
        spaced fractional timesteps from T-1 down to 0, log-interpolated into
        the table."""
        table = self.sigmas
        if schedule == "karras":
            return sigmas_karras(steps, float(table[-1]), float(table[0]))
        t = np.linspace(len(table) - 1, 0, steps)
        log_t = np.interp(t, np.arange(len(table)), np.log(table))
        return np.append(np.exp(log_t), 0.0).astype(np.float32)

    def img2img_steps(self, steps: int, strength: float) -> Tuple[int, int]:
        """(total_steps, t_enc): A1111's setup_img2img_steps, as the JAX
        package has it: run the last ``t_enc + 1`` sigmas of a
        ``steps``-long schedule."""
        t_enc = int(min(strength, 0.999) * steps)
        return steps, t_enc


@lru_cache(maxsize=8)
def _alphas_cumprod(T: int, b0: float, b1: float, kind: str) -> np.ndarray:
    if kind == "scaled_linear":
        betas = np.linspace(b0**0.5, b1**0.5, T, dtype=np.float64) ** 2
    elif kind == "linear":
        betas = np.linspace(b0, b1, T, dtype=np.float64)
    else:
        raise ValueError(f"unknown beta schedule {kind}")
    return np.cumprod(1.0 - betas).astype(np.float32)


def sigmas_karras(n: int, sigma_max: float, sigma_min: float, rho: float = 7.0) -> np.ndarray:
    """Karras et al. (2022) noise schedule, descending, with a trailing 0."""
    ramp = np.linspace(0, 1, n)
    min_inv = sigma_min ** (1 / rho)
    max_inv = sigma_max ** (1 / rho)
    sig = (max_inv + ramp * (min_inv - max_inv)) ** rho
    return np.append(sig, 0.0).astype(np.float32)


def ddim_timesteps(num_train_timesteps: int, steps: int) -> np.ndarray:
    """Uniform DDIM timestep subset (leading spacing), descending."""
    step_ratio = num_train_timesteps // steps
    return (np.arange(steps) * step_ratio).round()[::-1].astype(np.int32)
