"""The 15 samplers as Python loops over a descending sigma sequence ending in
0 (counterpart of the ``lax.scan`` samplers of ``mdu_tpu/samplers/samplers.py``,
in the same step order). Each takes ``denoised_fn(x, sigma, step)``.

Scalar arithmetic (sigma splits, step sizes, coefficients) runs on 0-d fp32
tensors on the device of the sigmas, as the JAX package runs it in the graph;
the branches that JAX takes with ``lax.cond`` (``sn > 0``, ``down > 0``, the
first step) are decided on the host from a CPU copy of the sigmas, so that no
step waits for the card. DPM adaptive reads its error on the host once an
iteration to accept or reject the step.

Randomness comes from ``noise(like)``, which returns a standard normal tensor
of ``like``'s shape, dtype and device (``generator_noise`` draws it from a
``torch.Generator``; the parity tests replay the JAX package's draws). A
sampler draws in the JAX package's order and shapes: ``_churn`` every step
while churn is on, Euler a / DPM++ 2S a / DPM2 a once every step, DPM++ SDE
twice on each step with ``sn > 0``, DPM++ 2M SDE once on each step with
``sn > 0``, Restart once a restart cycle.

Restart, DPM fast and DPM adaptive split their schedule on the host and
refuse a denoised function that keeps DeepCache state (``deepcache = True``,
``samplers/denoiser.py``), as the JAX package refuses their ``aux``.

Every sampler takes ``step_callback(step_index, x)`` and calls it where the
JAX package's ``_notify`` does (16 call sites): after each step, with that
step's index and the new ``x``; DPM fast after each of its leading order-3
segments and after the final jump; DPM adaptive after every iteration,
accepted or not; Restart in each of its Heun passes. The loops run on the
host, so it is a plain call (the JAX package needs ``jax.debug.callback``).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

DenoisedStepFn = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]
NoiseFn = Callable[[torch.Tensor], torch.Tensor]
StepCallback = Callable[[int, torch.Tensor], None]


def _notify(cb: Optional[StepCallback], i: int, x: torch.Tensor) -> None:
    if cb is not None:
        cb(int(i), x)


def generator_noise(gen: torch.Generator) -> NoiseFn:
    """``noise(like)`` drawing from ``gen`` on the generator's device and
    moving the draw to ``like``'s (a CPU generator gives a card run the
    CPU's draws)."""

    def draw(like: torch.Tensor) -> torch.Tensor:
        return torch.randn(like.shape, generator=gen, dtype=like.dtype,
                           device=gen.device).to(like.device)

    return draw


def _refuse_deepcache(denoised_fn) -> None:
    if getattr(denoised_fn, "deepcache", False):
        raise ValueError("DeepCache (stateful denoised_fn) is not supported by this sampler: "
                         "its schedule is segmented host-side")


def _t_of(s):
    return -torch.log(torch.clamp(s, min=1e-10))


def _host(sigmas: torch.Tensor) -> torch.Tensor:
    """A CPU copy of the sigmas, for the host's branch decisions."""
    return sigmas.detach().to("cpu", torch.float32)


def _churn(x, s, i, noise, n_steps, s_churn, s_tmin, s_tmax, s_noise):
    """Karras sigma churn (k-diffusion sample_euler/heun gamma logic): bump
    sigma and add matched noise. Draws every step, even where gamma is 0."""
    inside = ((s >= s_tmin) & (s <= s_tmax)).to(s.dtype)
    gamma = inside * min(s_churn / max(n_steps - 1, 1), 2**0.5 - 1)
    s_hat = s * (1.0 + gamma)
    eps = noise(x) * s_noise
    x = x + eps * torch.sqrt(torch.clamp(s_hat**2 - s**2, min=0.0))
    return x, s_hat


def _ancestral_step(s, sn, eta=1.0):
    """k-diffusion get_ancestral_step: split sigma_next into a deterministic
    sigma_down and an injected-noise sigma_up."""
    up = torch.minimum(sn, eta * torch.sqrt(torch.clamp(sn**2 * (s**2 - sn**2) / s**2, min=0.0)))
    down = torch.sqrt(torch.clamp(sn**2 - up**2, min=0.0))
    return down, up


def sample_euler(denoised_fn: DenoisedStepFn, x, sigmas, noise: Optional[NoiseFn] = None,
                 s_churn: float = 0.0, s_tmin: float = 0.0, s_tmax: float = float("inf"),
                 s_noise: float = 1.0, step_callback: Optional[StepCallback] = None):
    """Euler, with Karras churn when ``s_churn > 0`` and a noise source is given."""
    n = sigmas.shape[0] - 1
    use_churn = s_churn > 0 and noise is not None
    for i in range(n):
        s, sn = sigmas[i], sigmas[i + 1]
        if use_churn:
            x, s = _churn(x, s, i, noise, n, s_churn, s_tmin, s_tmax, s_noise)
        den = denoised_fn(x, s, i)
        d = (x - den) / s
        x = x + d * (sn - s)
        _notify(step_callback, i, x)
    return x


def sample_euler_ancestral(denoised_fn: DenoisedStepFn, x, sigmas, noise: NoiseFn,
                           eta: float = 1.0, step_callback: Optional[StepCallback] = None):
    for i in range(sigmas.shape[0] - 1):
        s, sn = sigmas[i], sigmas[i + 1]
        den = denoised_fn(x, s, i)
        down, up = _ancestral_step(s, sn, eta)
        d = (x - den) / s
        x = x + d * (down - s)
        x = x + noise(x) * up
        _notify(step_callback, i, x)
    return x


def sample_heun(denoised_fn: DenoisedStepFn, x, sigmas, noise: Optional[NoiseFn] = None,
                s_churn: float = 0.0, s_tmin: float = 0.0, s_tmax: float = float("inf"),
                s_noise: float = 1.0, step_callback: Optional[StepCallback] = None):
    n = sigmas.shape[0] - 1
    host = _host(sigmas)
    use_churn = s_churn > 0 and noise is not None
    for i in range(n):
        s, sn = sigmas[i], sigmas[i + 1]
        if use_churn:
            x, s = _churn(x, s, i, noise, n, s_churn, s_tmin, s_tmax, s_noise)
        den = denoised_fn(x, s, i)
        d = (x - den) / s
        x_euler = x + d * (sn - s)
        if host[i + 1] > 0:
            den2 = denoised_fn(x_euler, sn, i)
            x = x + 0.5 * (d + (x_euler - den2) / sn) * (sn - s)
        else:
            x = x_euler
        _notify(step_callback, i, x)
    return x


def sample_dpmpp_2m(denoised_fn: DenoisedStepFn, x, sigmas,
                    step_callback: Optional[StepCallback] = None):
    """DPM-Solver++(2M), k-diffusion formulation."""
    host = _host(sigmas)
    old_den = None
    for i in range(sigmas.shape[0] - 1):
        s, sn = sigmas[i], sigmas[i + 1]
        den = denoised_fn(x, s, i)
        t, tn = _t_of(s), _t_of(sn)
        h = tn - t
        ratio = sn / s
        if host[i + 1] > 0 and old_den is not None:
            h_last = t - _t_of(sigmas[i - 1])
            r = h_last / h
            den_d = (1 + 1 / (2 * r)) * den - (1 / (2 * r)) * old_den
            x = ratio * x - torch.expm1(-h) * den_d
        elif host[i + 1] > 0:
            x = ratio * x - torch.expm1(-h) * den
        else:
            x = den
        old_den = den
        _notify(step_callback, i, x)
    return x


def sample_ddim(denoised_fn: DenoisedStepFn, x, sigmas, noise: Optional[NoiseFn] = None,
                eta: float = 0.0, step_callback: Optional[StepCallback] = None):
    """DDIM in VE coordinates: x = den + s_next * eps. With ``eta > 0`` and a
    noise source it is Euler a at that eta, as in the JAX package; the
    pipeline, like the JAX package's, calls it with neither."""
    if eta > 0.0 and noise is not None:
        return sample_euler_ancestral(denoised_fn, x, sigmas, noise, eta,
                                      step_callback=step_callback)
    for i in range(sigmas.shape[0] - 1):
        s, sn = sigmas[i], sigmas[i + 1]
        den = denoised_fn(x, s, i)
        eps = (x - den) / s
        x = den + sn * eps
        _notify(step_callback, i, x)
    return x


def _lms_coeffs(host: torch.Tensor, i: int, cur_order: int,
                points: int = 64) -> List[float]:
    """The JAX package's in-graph LMS coefficients: each Lagrange basis
    polynomial over the last ``cur_order`` sigmas, integrated over
    [sigma_i, sigma_{i+1}] by a ``points``-point trapezoid in fp32 (not
    k-diffusion's ``scipy.integrate.quad``)."""
    n = host.shape[0] - 1
    sig = host[:-1]
    t = torch.linspace(float(host[i]), float(host[i + 1]), points, dtype=torch.float32)
    out = []
    for j in range(cur_order):
        prod = torch.ones_like(t)
        node_j = sig[min(max(i - j, 0), n - 1)]
        for k in range(cur_order):
            if k == j:
                continue
            node_k = sig[min(max(i - k, 0), n - 1)]
            prod = prod * ((t - node_k) / (node_j - node_k + 1e-20))
        out.append(float(torch.trapezoid(prod, t)))
    return out


def sample_lms(denoised_fn: DenoisedStepFn, x, sigmas, order: int = 4,
               step_callback: Optional[StepCallback] = None):
    """Linear multistep (k-diffusion LMS, order 4) with the JAX package's
    trapezoid coefficients (``_lms_coeffs``)."""
    host = _host(sigmas)
    hist: List[torch.Tensor] = []               # most recent first
    for i in range(sigmas.shape[0] - 1):
        s = sigmas[i]
        den = denoised_fn(x, s, i)
        hist = [(x - den) / s] + hist[:order - 1]
        upd = torch.zeros_like(x)
        for c, d in zip(_lms_coeffs(host, i, min(i + 1, order)), hist):
            upd = upd + c * d
        x = x + upd
        _notify(step_callback, i, x)
    return x


def sample_dpmpp_2s_ancestral(denoised_fn: DenoisedStepFn, x, sigmas, noise: NoiseFn,
                              eta: float = 1.0, step_callback: Optional[StepCallback] = None):
    """DPM-Solver++(2S) ancestral: a midpoint model call every step (also the
    last), then ancestral noise."""
    host = _host(sigmas)
    for i in range(sigmas.shape[0] - 1):
        s, sn = sigmas[i], sigmas[i + 1]
        den = denoised_fn(x, s, i)
        down, up = _ancestral_step(s, sn, eta)
        down_c = torch.clamp(down, min=1e-10)
        t, tn = _t_of(s), _t_of(down_c)
        h = tn - t
        sig_mid = torch.exp(-(t + 0.5 * h))
        x2 = (sig_mid / s) * x - torch.expm1(-0.5 * h) * den
        den2 = denoised_fn(x2, sig_mid, i)
        x_second = (down_c / s) * x - torch.expm1(-h) * den2
        x = x_second if _ancestral_step(host[i], host[i + 1], eta)[0] > 0 else den
        x = x + noise(x) * up
        _notify(step_callback, i, x)
    return x


def sample_dpm2(denoised_fn: DenoisedStepFn, x, sigmas, noise: Optional[NoiseFn] = None,
                s_churn: float = 0.0, s_tmin: float = 0.0, s_tmax: float = float("inf"),
                s_noise: float = 1.0, step_callback: Optional[StepCallback] = None):
    """DPM-Solver-2: a midpoint step at the geometric-mean sigma."""
    n = sigmas.shape[0] - 1
    host = _host(sigmas)
    use_churn = s_churn > 0 and noise is not None
    for i in range(n):
        s, sn = sigmas[i], sigmas[i + 1]
        if use_churn:
            x, s = _churn(x, s, i, noise, n, s_churn, s_tmin, s_tmax, s_noise)
        den = denoised_fn(x, s, i)
        d = (x - den) / s
        if host[i + 1] > 0:
            s_mid = torch.exp(0.5 * (torch.log(s) + torch.log(torch.clamp(sn, min=1e-10))))
            x_2 = x + d * (s_mid - s)
            den_2 = denoised_fn(x_2, s_mid, i)
            x = x + (x_2 - den_2) / s_mid * (sn - s)
        else:
            x = x + d * (sn - s)
        _notify(step_callback, i, x)
    return x


def sample_dpm2_ancestral(denoised_fn: DenoisedStepFn, x, sigmas, noise: NoiseFn,
                          eta: float = 1.0, step_callback: Optional[StepCallback] = None):
    host = _host(sigmas)
    for i in range(sigmas.shape[0] - 1):
        s, sn = sigmas[i], sigmas[i + 1]
        den = denoised_fn(x, s, i)
        down, up = _ancestral_step(s, sn, eta)
        d = (x - den) / s
        if _ancestral_step(host[i], host[i + 1], eta)[0] > 0:
            s_mid = torch.exp(0.5 * (torch.log(s) + torch.log(torch.clamp(down, min=1e-10))))
            x_2 = x + d * (s_mid - s)
            den_2 = denoised_fn(x_2, s_mid, i)
            x = x + (x_2 - den_2) / s_mid * (down - s)
        else:
            x = x + d * (down - s)
        x = x + noise(x) * up
        _notify(step_callback, i, x)
    return x


def sample_dpmpp_sde(denoised_fn: DenoisedStepFn, x, sigmas, noise: NoiseFn,
                     eta: float = 1.0, s_noise: float = 1.0, r: float = 0.5,
                     step_callback: Optional[StepCallback] = None):
    """DPM-Solver++ SDE with plain per-step noise (not k-diffusion's Brownian
    tree), as in the JAX package: on each step with ``sn > 0`` a draw at the
    midpoint and one at the endpoint."""
    host = _host(sigmas)
    for i in range(sigmas.shape[0] - 1):
        s, sn = sigmas[i], sigmas[i + 1]
        den = denoised_fn(x, s, i)
        if not host[i + 1] > 0:
            x = x + (x - den) / s * (sn - s)
            _notify(step_callback, i, x)
            continue
        t, t_next = _t_of(s), _t_of(sn)
        h = t_next - t
        s_mid = torch.exp(-(t + h * r))
        fac = 1.0 / (2.0 * r)
        sd1, su1 = _ancestral_step(s, s_mid, eta)
        x_2 = (sd1 / s) * x - torch.expm1(t - _t_of(sd1)) * den
        x_2 = x_2 + noise(x) * s_noise * su1
        den_2 = denoised_fn(x_2, s_mid, i)
        sd2, su2 = _ancestral_step(s, sn, eta)
        den_d = (1.0 - fac) * den + fac * den_2
        x_out = (sd2 / s) * x - torch.expm1(t - _t_of(sd2)) * den_d
        x = x_out + noise(x) * s_noise * su2
        _notify(step_callback, i, x)
    return x


def sample_plms(denoised_fn: DenoisedStepFn, x, sigmas,
                step_callback: Optional[StepCallback] = None):
    """PLMS: Adams-Bashforth over eps on the timestep grid, primed by a
    second evaluation on the first step (CompVis p_sample_plms in VE
    coordinates)."""
    hist: List[torch.Tensor] = []               # newest first
    for i in range(sigmas.shape[0] - 1):
        s, sn = sigmas[i], sigmas[i + 1]
        den = denoised_fn(x, s, i)
        eps = (x - den) / s
        if not hist:
            sn_c = torch.clamp(sn, min=1e-10)
            x1 = (x - s * eps) + sn * eps
            den2 = denoised_fn(x1, sn_c, i)
            eps_prime = (eps + (x1 - den2) / sn_c) / 2.0
        elif len(hist) == 1:
            eps_prime = (3 * eps - hist[0]) / 2
        elif len(hist) == 2:
            eps_prime = (23 * eps - 16 * hist[0] + 5 * hist[1]) / 12
        else:
            eps_prime = (55 * eps - 59 * hist[0] + 37 * hist[1] - 9 * hist[2]) / 24
        x = (x - s * eps) + sn * eps_prime
        hist = [eps] + hist[:2]
        _notify(step_callback, i, x)
    return x


def _dpm_eps(denoised_fn, x, t, i):
    """eps in DPM-Solver t-coordinates (t = -log sigma)."""
    s = torch.exp(-t)
    return (x - denoised_fn(x, s, i)) / s


def _dpm1(denoised_fn, x, t, t_next, i, eps=None):
    h = t_next - t
    if eps is None:
        eps = _dpm_eps(denoised_fn, x, t, i)
    return x - torch.exp(-t_next) * torch.expm1(h) * eps


def _dpm2(denoised_fn, x, t, t_next, i, r1=0.5, eps=None, eps_r1=None):
    h = t_next - t
    if eps is None:
        eps = _dpm_eps(denoised_fn, x, t, i)
    s1 = t + r1 * h
    if eps_r1 is None:
        u1 = x - torch.exp(-s1) * torch.expm1(r1 * h) * eps
        eps_r1 = _dpm_eps(denoised_fn, u1, s1, i)
    return (x - torch.exp(-t_next) * torch.expm1(h) * eps
            - torch.exp(-t_next) / (2 * r1) * torch.expm1(h) * (eps_r1 - eps))


def _dpm3(denoised_fn, x, t, t_next, i, r1=1 / 3, r2=2 / 3, eps=None, eps_r1=None):
    h = t_next - t
    if eps is None:
        eps = _dpm_eps(denoised_fn, x, t, i)
    s1, s2 = t + r1 * h, t + r2 * h
    if eps_r1 is None:
        u1 = x - torch.exp(-s1) * torch.expm1(r1 * h) * eps
        eps_r1 = _dpm_eps(denoised_fn, u1, s1, i)
    u2 = (x - torch.exp(-s2) * torch.expm1(r2 * h) * eps
          - torch.exp(-s2) * (r2 / r1) * (torch.expm1(r2 * h) / (r2 * h) - 1) * (eps_r1 - eps))
    eps_r2 = _dpm_eps(denoised_fn, u2, s2, i)
    return (x - torch.exp(-t_next) * torch.expm1(h) * eps
            - torch.exp(-t_next) / r2 * (torch.expm1(h) / h - 1) * (eps_r2 - eps))


def sample_dpm_fast(denoised_fn: DenoisedStepFn, x, sigmas,
                    step_callback: Optional[StepCallback] = None):
    """DPM-Solver-Fast (k-diffusion sample_dpm_fast): a uniform grid in
    t = -log sigma from sigma_max to the smallest nonzero sigma, order-3
    segments and an order-(2, 1 | n % 3) tail, then an exact jump to
    sigma 0 (x = denoised). The grid is built on the host with numpy, as the
    JAX package builds it, then cast to fp32."""
    _refuse_deepcache(denoised_fn)
    sig_np = _host(sigmas).numpy()
    n = len(sig_np) - 1
    m = n // 3 + 1
    ts_np = np.linspace(-np.log(sig_np[0]), -np.log(sig_np[-2]), m + 1)
    orders = ([3] * (m - 2) + [2, 1]) if n % 3 == 0 else [3] * (m - 1) + [n % 3]
    ts = torch.as_tensor(ts_np, dtype=torch.float32, device=sigmas.device)
    n3 = orders.count(3)                      # the leading order-3 segments
    i = 0
    for j, o in enumerate(orders):
        x = {1: _dpm1, 2: _dpm2, 3: _dpm3}[o](denoised_fn, x, ts[j], ts[j + 1], i)
        if j < n3:
            _notify(step_callback, i, x)
        i += o
    x = denoised_fn(x, sigmas[-2], i)
    _notify(step_callback, i, x)
    return x


def sample_dpm_adaptive(denoised_fn: DenoisedStepFn, x, sigmas, order: int = 3,
                        rtol: float = 0.05, atol: float = 0.0078, h_init: float = 0.05,
                        pcoeff: float = 0.0, icoeff: float = 1.0, dcoeff: float = 0.0,
                        accept_safety: float = 0.81, max_iters: int = 128,
                        decisions: Optional[List[bool]] = None,
                        factors: Optional[List[float]] = None,
                        step_callback: Optional[StepCallback] = None):
    """DPM-Solver-12/23 adaptive (k-diffusion dpm_solver_adaptive): embedded
    (order-1, 2 | 2, 3) pairs estimate the local error, which drives a PID
    step-size controller with the atan limiter. A host loop of at most
    ``max_iters`` iterations: each reads the step's accept decision on the
    host (appended to ``decisions`` when given, and the controller's factor
    that decided it, held against ``accept_safety``, to ``factors``).
    ``sigmas`` gives only the endpoints. Ends with the exact jump to sigma 0,
    as DPM fast."""
    _refuse_deepcache(denoised_fn)
    sig_np = _host(sigmas).numpy()
    t_end = float(-np.log(sig_np[-2]))
    stop = torch.tensor(t_end - 1e-5, dtype=torch.float32)
    b1 = (pcoeff + icoeff + dcoeff) / order
    b2 = -(pcoeff + 2 * dcoeff) / order
    b3 = dcoeff / order
    f32 = dict(dtype=torch.float32, device=sigmas.device)
    t_end_d = torch.tensor(t_end, **f32)
    r1 = 1.0 / 3.0 if order == 3 else 0.5

    def solve_pair(x, s, t, i):
        eps = _dpm_eps(denoised_fn, x, s, i)
        h = t - s
        s1 = s + r1 * h
        u1 = x - torch.exp(-s1) * torch.expm1(r1 * h) * eps
        eps_r1 = _dpm_eps(denoised_fn, u1, s1, i)
        if order == 3:
            return (_dpm2(denoised_fn, x, s, t, i, r1=r1, eps=eps, eps_r1=eps_r1),
                    _dpm3(denoised_fn, x, s, t, i, eps=eps, eps_r1=eps_r1))
        return (_dpm1(denoised_fn, x, s, t, i, eps=eps),
                _dpm2(denoised_fn, x, s, t, i, r1=r1, eps=eps, eps_r1=eps_r1))

    x_prev = x
    s = torch.tensor(float(-np.log(sig_np[0])), **f32)
    h = torch.tensor(h_init, **f32)
    errs = torch.zeros(3, **f32)
    i = 0
    for _ in range(max_iters):
        if not bool(s.cpu() < stop):
            break
        t = torch.minimum(t_end_d, s + h)
        x_low, x_high = solve_pair(x, s, t, i)
        delta = torch.clamp(rtol * torch.maximum(x_low.abs(), x_prev.abs()), min=atol)
        err = torch.linalg.vector_norm(((x_low - x_high) / delta).reshape(-1)) / (x.numel() ** 0.5)
        e0 = 1.0 / (err + 1e-8)
        e1 = torch.where(errs[1] > 0, errs[1], e0)
        e2 = torch.where(errs[2] > 0, errs[2], e0)
        factor = e0 ** b1 * e1 ** b2 * e2 ** b3
        factor = 1 + torch.atan(factor - 1)
        factor_host = factor.cpu()
        accept = bool(factor_host >= accept_safety)
        if decisions is not None:
            decisions.append(accept)
        if factors is not None:
            factors.append(float(factor_host))
        if accept:
            x, x_prev, s = x_high, x_low, t
            errs = torch.stack([e0, e0, e1])
        else:
            errs = torch.stack([e0, errs[1], errs[2]])
        _notify(step_callback, i, x)
        h = h * factor
        i += 3 if order == 3 else 2
    return denoised_fn(x, sigmas[-2], i)


def sample_dpmpp_2m_sde(denoised_fn: DenoisedStepFn, x, sigmas, noise: NoiseFn,
                        eta: float = 1.0, s_noise: float = 1.0,
                        step_callback: Optional[StepCallback] = None):
    """DPM-Solver++(2M) SDE, midpoint type, with plain per-step noise on each
    step with ``sn > 0`` (the JAX package's stand-in for the Brownian tree)."""
    host = _host(sigmas)
    old_den, h_last = None, torch.ones((), dtype=x.dtype, device=x.device)
    for i in range(sigmas.shape[0] - 1):
        s, sn = sigmas[i], sigmas[i + 1]
        den = denoised_fn(x, s, i)
        if host[i + 1] > 0:
            h = _t_of(sn) - _t_of(s)
            eta_h = eta * h
            x_new = (sn / s) * torch.exp(-eta_h) * x - torch.expm1(-h - eta_h) * den
            if old_den is not None:
                r = h_last / h
                x_new = x_new + 0.5 * (-torch.expm1(-h - eta_h)) * (1.0 / r) * (den - old_den)
            if eta > 0:
                x_new = x_new + noise(x) * sn * torch.sqrt(-torch.expm1(-2 * eta_h)) * s_noise
            x, h_last = x_new, h
        else:
            x = den
        old_den = den
        _notify(step_callback, i, x)
    return x


def sample_restart(denoised_fn: DenoisedStepFn, x, sigmas, noise: NoiseFn,
                   s_noise: float = 1.0,
                   restart_info: Optional[Tuple[float, float, int, int]] = None,
                   step_callback: Optional[StepCallback] = None):
    """Restart sampling (Xu et al. 2023; A1111's 'Restart'): Heun down the
    main schedule to sigma_min_r, then K cycles that re-noise up to
    sigma_max_r and descend again over an exp-spaced segment, then the tail.
    ``restart_info`` = (sigma_min_r, sigma_max_r, n_seg_steps, k_restarts),
    by default A1111's {0.1: [10, 2]}. The schedule is split on the host."""
    _refuse_deepcache(denoised_fn)
    sig_np = _host(sigmas).numpy()
    s_min_r, s_max_r, n_seg, k_restarts = restart_info or (0.1, 2.0, 10, 2)
    lo = max(float(s_min_r), float(sig_np[-2]))
    cut = int(np.searchsorted(-sig_np, -lo, side="right"))
    cut = max(2, min(cut, len(sig_np) - 1))
    upper = sigmas[:cut]
    lower = sigmas[cut - 1:]
    x = sample_heun(denoised_fn, x, upper, step_callback=step_callback)
    ends = torch.log(torch.tensor([s_max_r, float(sig_np[cut - 1])], dtype=torch.float32))
    seg = torch.exp(torch.linspace(float(ends[0]), float(ends[1]), n_seg,
                                   dtype=torch.float32)).to(sigmas.device)
    for _ in range(k_restarts):
        bump = torch.sqrt(torch.clamp(seg[0] ** 2 - seg[-1] ** 2, min=0.0))
        x = x + noise(x) * s_noise * bump
        x = sample_heun(denoised_fn, x, seg, step_callback=step_callback)
    return sample_heun(denoised_fn, x, lower, step_callback=step_callback)


SAMPLERS = {
    "Euler": sample_euler,
    "Euler a": sample_euler_ancestral,
    "Heun": sample_heun,
    "DPM2": sample_dpm2,
    "DPM2 a": sample_dpm2_ancestral,
    "DPM++ 2M": sample_dpmpp_2m,
    "DPM++ 2S a": sample_dpmpp_2s_ancestral,
    "DPM++ SDE": sample_dpmpp_sde,
    "DPM++ 2M SDE": sample_dpmpp_2m_sde,
    "DPM fast": sample_dpm_fast,
    "DPM adaptive": sample_dpm_adaptive,
    "DDIM": sample_ddim,
    "LMS": sample_lms,
    "PLMS": sample_plms,
    "Restart": sample_restart,
}

# samplers whose updates draw fresh noise (the pipeline passes them a noise
# source); churn applies to these three
STOCHASTIC_SAMPLERS = {"Euler a", "DPM++ 2S a", "DPM2 a", "DPM++ SDE", "DPM++ 2M SDE",
                       "Restart"}
CHURN_SAMPLERS = ("Euler", "Heun", "DPM2")

# samplers that derive their schedule from the sigmas on the host (the JAX
# package bakes their sigmas into the program)
STATIC_SIGMA_SAMPLERS = {"Restart", "DPM fast", "DPM adaptive"}


def base_name(name: str) -> str:
    """A1111's '<name> Karras' is <name> on the Karras schedule."""
    return name.replace(" Karras", "")


def get_sampler(name: str):
    base = base_name(name)
    if base not in SAMPLERS:
        raise ValueError(f"unknown sampler '{name}'; available: {list(SAMPLERS)}")
    return SAMPLERS[base]
