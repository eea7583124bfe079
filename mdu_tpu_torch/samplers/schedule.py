"""Noise schedule and sigma tables (counterpart of
``mdu_tpu/samplers/schedule.py``): k-diffusion's discrete VE wrapping of the
DDPM schedule, sigma_t = sqrt((1 - abar_t) / abar_t)."""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

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
        """[steps + 1] descending sigmas ending at 0: evenly spaced fractional
        timesteps from T-1 down to 0, log-interpolated into the table."""
        if schedule != "automatic":
            raise NotImplementedError(
                f"the {schedule!r} sigma schedule waits for ROADMAP queue 1, item 14")
        table = self.sigmas
        t = np.linspace(len(table) - 1, 0, steps)
        log_t = np.interp(t, np.arange(len(table)), np.log(table))
        return np.append(np.exp(log_t), 0.0).astype(np.float32)


@lru_cache(maxsize=8)
def _alphas_cumprod(T: int, b0: float, b1: float, kind: str) -> np.ndarray:
    if kind == "scaled_linear":
        betas = np.linspace(b0**0.5, b1**0.5, T, dtype=np.float64) ** 2
    elif kind == "linear":
        betas = np.linspace(b0, b1, T, dtype=np.float64)
    else:
        raise ValueError(f"unknown beta schedule {kind}")
    return np.cumprod(1.0 - betas).astype(np.float32)
