"""Port parity for the 15 samplers, the Karras schedule and sigma churn:
each sampler of ``mdu_tpu_torch`` against ``mdu_tpu``'s on the same inputs,
through an analytic denoiser defined once in numpy and written out in jnp and
in torch (no UNet is compiled). The stochastic samplers get the JAX
package's own draws: the JAX sampler runs under ``jax.disable_jit()`` with
``jax.random.normal`` wrapped to record every draw, and the port's noise
function replays them in order, checking each shape, and must use them all.
Tolerance: atol 1e-5 x max|ref| (fp32 on both sides)."""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdu_tpu.pipeline import DiffusionPipeline as JaxPipeline
from mdu_tpu.samplers import samplers as jsamplers
from mdu_tpu.samplers import schedule as jschedule
from mdu_tpu_torch import DiffusionPipeline, SamplerConfig
from mdu_tpu_torch.samplers import samplers
from mdu_tpu_torch.samplers import schedule

torch.set_num_threads(2)

# the data's mean: the denoiser is the posterior mean of N(MU, 1) plus a
# small nonlinear term
MU = np.random.default_rng(3).normal(size=(1, 4, 6, 6)).astype(np.float32)
X0 = np.random.default_rng(4).normal(size=(1, 4, 6, 6)).astype(np.float32)
NAMES = list(jsamplers.SAMPLERS)


def den_jax(x, s, i):
    return (x + MU * s**2) / (1 + s**2) + 0.05 * jnp.tanh(x) / (1 + s)


def den_torch(x, s, i):
    mu = torch.from_numpy(MU)
    return (x + mu * s**2) / (1 + s**2) + 0.05 * torch.tanh(x) / (1 + s)


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def run_jax(fn, *args, **kw):
    """``fn(den_jax, *args, **kw)`` op by op, with every draw of
    ``jax.random.normal`` recorded: (result, draws)."""
    draws = []
    normal = jax.random.normal

    def recording(key, shape=(), dtype=jnp.float32):
        out = normal(key, shape, dtype)
        draws.append(np.array(out))
        return out

    jax.random.normal = recording
    try:
        with jax.disable_jit():
            out = np.asarray(fn(den_jax, *args, **kw))
    finally:
        jax.random.normal = normal
    return out, draws


class Replay:
    """The port's noise function: JAX's draws in order, shapes checked."""

    def __init__(self, draws):
        self.draws = list(draws)

    def __call__(self, like):
        d = self.draws.pop(0)
        assert d.shape == tuple(like.shape) and like.dtype == torch.float32
        return torch.from_numpy(d)


def _sigmas(steps, sched):
    sig = jschedule.NoiseSchedule().sampling_sigmas(steps, sched)
    np.testing.assert_array_equal(schedule.NoiseSchedule().sampling_sigmas(steps, sched), sig)
    return sig


# 6 automatic steps; 7 Karras steps (DPM fast then ends in an order-1 segment
# after two of order 3, where 6 steps end in orders 3, 2, 1)
@pytest.mark.parametrize("sched,steps", [("automatic", 6), ("karras", 7)])
@pytest.mark.parametrize("name", NAMES)
def test_sampler_matches_jax(name, sched, steps):
    sig = _sigmas(steps, sched)
    x = X0 * sig[0]
    key = (jax.random.PRNGKey(0),) if name in jsamplers.STOCHASTIC_SAMPLERS else ()
    want, draws = run_jax(jsamplers.SAMPLERS[name], jnp.asarray(x), jnp.asarray(sig), *key)
    noise = Replay(draws)
    args = (noise,) if name in samplers.STOCHASTIC_SAMPLERS else ()
    got = samplers.get_sampler(name)(den_torch, torch.from_numpy(x), torch.from_numpy(sig),
                                     *args)
    _close(got, want)
    assert noise.draws == []                   # every draw of JAX's used, in order
    if name == "DPM++ SDE":
        assert len(draws) == 2 * (steps - 1)   # twice on each step with sn > 0
    if name in ("Euler a", "DPM2 a", "DPM++ 2S a"):
        assert len(draws) == steps             # once every step
    if name == "Restart":
        assert len(draws) == 2                 # once a restart cycle


@pytest.mark.parametrize("name", ["Euler", "Heun", "DPM2"])
def test_churn_matches_jax(name):
    """Churn draws every step, also where gamma is 0 (sigmas outside
    [s_tmin, s_tmax])."""
    sig = _sigmas(6, "automatic")
    x = X0 * sig[0]
    kw = dict(s_churn=1.5, s_tmin=0.3, s_tmax=5.0, s_noise=1.003)
    want, draws = run_jax(jsamplers.SAMPLERS[name], jnp.asarray(x), jnp.asarray(sig),
                          jax.random.PRNGKey(2), **kw)
    assert len(draws) == 6
    noise = Replay(draws)
    got = samplers.SAMPLERS[name](den_torch, torch.from_numpy(x), torch.from_numpy(sig),
                                  noise, **kw)
    _close(got, want)
    assert noise.draws == []


def test_ddim_with_eta_called_directly_matches_jax():
    """Eta-DDIM is reachable only by calling the sampler with a noise source
    and an eta: it is Euler a at that eta."""
    sig = _sigmas(6, "automatic")
    x = X0 * sig[0]
    want, draws = run_jax(jsamplers.sample_ddim, jnp.asarray(x), jnp.asarray(sig),
                          jax.random.PRNGKey(5), eta=0.6)
    assert len(draws) == 6
    noise = Replay(draws)
    got = samplers.sample_ddim(den_torch, torch.from_numpy(x), torch.from_numpy(sig), noise,
                               eta=0.6)
    _close(got, want)
    assert noise.draws == []


def test_pipeline_ignores_eta_like_jax():
    """The JAX pipeline never reads ``SamplerConfig.eta`` and calls DDIM
    without a key; the port's dispatch does the same: DDIM at eta 0.7 gives
    deterministic DDIM and draws nothing."""
    assert "sp.eta" not in inspect.getsource(JaxPipeline)
    assert "DDIM" not in jsamplers.STOCHASTIC_SAMPLERS
    sig = torch.from_numpy(_sigmas(6, "automatic"))
    x = torch.from_numpy(X0) * sig[0]

    def no_draw(like):
        raise AssertionError("DDIM drew noise in the pipeline's dispatch")

    got = DiffusionPipeline._sample(SamplerConfig(name="DDIM", eta=0.7), den_torch, x, sig,
                                    no_draw)
    _close(got, samplers.sample_ddim(den_torch, x, sig))


@pytest.mark.parametrize("name", ["Euler a Karras", "DPM++ SDE Karras", "Euler Karras"])
def test_karras_names_dispatch_as_their_sampler(name):
    """A " Karras" name selects the Karras schedule and dispatches as its
    sampler: "Euler a Karras" and "DPM++ SDE Karras" get their noise (the
    JAX package keys its stochastic set on the full name and calls them
    without a key), "Euler Karras" its churn."""
    sp = DiffusionPipeline._resolve_sampler(SamplerConfig(name=name, steps=5, s_churn=1.0))
    assert sp.schedule == "karras" and sp.name == name
    sig = _sigmas(5, "karras")
    base = name.replace(" Karras", "")
    kw = dict(s_churn=1.0, s_tmin=0.0, s_tmax=float("inf"), s_noise=1.0) if base == "Euler" \
        else {}
    want, draws = run_jax(jsamplers.SAMPLERS[base], jnp.asarray(X0 * sig[0]), jnp.asarray(sig),
                          jax.random.PRNGKey(1), **kw)
    assert draws
    noise = Replay(draws)
    got = DiffusionPipeline._sample(sp, den_torch, torch.from_numpy(X0 * sig[0]),
                                    torch.from_numpy(sig), noise)
    _close(got, want)
    assert noise.draws == []


def test_dpm_adaptive_records_its_decisions():
    """The accept / reject decisions of DPM adaptive: 8 iterations of which
    one is rejected on this input, the same on the Karras schedule; the
    result matches JAX's (``test_sampler_matches_jax``)."""
    for sched, steps in (("automatic", 6), ("karras", 7)):
        sig = torch.from_numpy(_sigmas(steps, sched))
        decisions = []
        samplers.sample_dpm_adaptive(den_torch, torch.from_numpy(X0) * sig[0], sig,
                                     decisions=decisions)
        assert decisions == [True] * 5 + [False] + [True] * 2


def test_dpm_adaptive_records_the_factor_of_each_decision():
    """``factors`` gets the controller's factor of every decision: a step is
    accepted exactly where its factor reaches the 0.81 safety."""
    sig = torch.from_numpy(_sigmas(6, "automatic"))
    decisions, factors = [], []
    samplers.sample_dpm_adaptive(den_torch, torch.from_numpy(X0) * sig[0], sig,
                                 decisions=decisions, factors=factors)
    assert len(factors) == len(decisions) == 8
    assert decisions == [f >= 0.81 for f in factors]
    assert all(np.isfinite(factors))


@pytest.mark.parametrize("steps", [1, 2, 20, 37])
def test_karras_and_ddim_timesteps_match_jax(steps):
    np.testing.assert_array_equal(schedule.sigmas_karras(steps, 14.6146, 0.0292),
                                  jschedule.sigmas_karras(steps, 14.6146, 0.0292))
    np.testing.assert_array_equal(schedule.sigmas_karras(steps, 80.0, 0.002, rho=5.0),
                                  jschedule.sigmas_karras(steps, 80.0, 0.002, rho=5.0))
    np.testing.assert_array_equal(schedule.ddim_timesteps(1000, steps),
                                  jschedule.ddim_timesteps(1000, steps))
    ps, js = schedule.NoiseSchedule(), jschedule.NoiseSchedule()
    for sched in ("karras", "automatic", "exponential"):       # unknown names: automatic
        np.testing.assert_array_equal(ps.sampling_sigmas(steps, sched),
                                      js.sampling_sigmas(steps, sched))


def test_sampler_names_and_errors_match_jax():
    assert list(samplers.SAMPLERS) == list(jsamplers.SAMPLERS)
    assert samplers.STOCHASTIC_SAMPLERS == jsamplers.STOCHASTIC_SAMPLERS
    assert samplers.STATIC_SIGMA_SAMPLERS == jsamplers.STATIC_SIGMA_SAMPLERS
    for name in NAMES:
        assert samplers.get_sampler(name + " Karras") is samplers.SAMPLERS[name]
        assert jsamplers.get_sampler(name + " Karras") is jsamplers.SAMPLERS[name]
    for bad in ("UniPC", "euler", "Karras", "DPM++ 3M SDE"):
        with pytest.raises(ValueError, match="unknown sampler"):
            jsamplers.get_sampler(bad)
        with pytest.raises(ValueError, match="unknown sampler"):
            samplers.get_sampler(bad)
