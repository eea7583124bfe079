"""Port parity for step callbacks, cooperative interruption, ``reset``,
telemetry and checkpoints against ``mdu_tpu``.

* Each sampler's sequence of ``(i, x)`` callbacks against the JAX sampler's
  ``_notify`` calls, on an analytic denoiser (JAX run op by op under
  ``jax.disable_jit()``, its draws replayed), for Euler, Heun, DPM++ SDE,
  DPM fast, DPM adaptive (every iteration, accepted or not) and Restart
  (its inner Heun passes), and the call-site count of every sampler.
* The pipeline's callbacks (txt2img, tiled, with and without DeepCache), an
  interruption set from a callback after step k (the port's latents JAX's
  x at step k), both pipelines interrupted before the first step, and
  DemoFusion interrupted before it starts (phase 1 returns its start, no later phase
  runs), on the stand-in UNet of ``test_torch_deepcache.py`` so that each
  JAX program compiles in about a second. The JAX package's DemoFusion takes
  no step callback, and neither does the port's.
* ``perfcount``'s line, ``save_params`` / ``load_params`` bit for bit, and
  ``check_finite``'s message, each against the JAX package's.

Tolerance: samplers atol 1e-5 x max|ref|, pipelines 1e-4 x max|ref| (fp32 on
both sides, JAX at 'highest')."""
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdu_tpu.config as jcfg
from mdu_tpu.samplers import samplers as jsamplers
from mdu_tpu.samplers import schedule as jschedule
from mdu_tpu.utils import checkpoint as jcheckpoint
from mdu_tpu.utils import telemetry as jtelemetry
from mdu_tpu_torch import DemoFusionConfig, SamplerConfig, TiledDiffusionConfig
from mdu_tpu_torch.samplers import samplers
from mdu_tpu_torch.utils import checkpoint, telemetry
from test_torch_deepcache import TD, jax_cond, standin_pipes, to_jax

torch.set_num_threads(2)

MU = np.random.default_rng(3).normal(size=(1, 4, 6, 6)).astype(np.float32)
X0 = np.random.default_rng(4).normal(size=(1, 4, 6, 6)).astype(np.float32)


def den_jax(x, s, i):
    return (x + MU * s**2) / (1 + s**2) + 0.05 * jnp.tanh(x) / (1 + s)


def den_torch(x, s, i):
    mu = torch.from_numpy(MU)
    return (x + mu * s**2) / (1 + s**2) + 0.05 * torch.tanh(x) / (1 + s)


def _close(got, want, rel):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _jax_callbacks(name, x, sig, key):
    """The JAX sampler ``name`` op by op, recording its draws and its
    callbacks: (result, draws, [(i, x), ...])."""
    draws, seen = [], []
    normal = jax.random.normal

    def recording(k, shape=(), dtype=jnp.float32):
        out = normal(k, shape, dtype)
        draws.append(np.array(out))
        return out

    jax.random.normal = recording
    try:
        with jax.disable_jit():
            out = np.asarray(jsamplers.SAMPLERS[name](
                den_jax, jnp.asarray(x), jnp.asarray(sig), *key,
                step_callback=lambda i, xx: seen.append((int(i), np.array(xx)))))
    finally:
        jax.random.normal = normal
    return out, draws, seen


@pytest.mark.parametrize("name", ["Euler", "Heun", "DPM++ SDE", "DPM fast", "DPM adaptive",
                                  "Restart"])
def test_sampler_callbacks_match_jax(name):
    """Every callback in order, its step index and its x; DPM adaptive's on
    accepted and rejected iterations alike; Restart's in each Heun pass."""
    sig = jschedule.NoiseSchedule().sampling_sigmas(6, "automatic")
    x = X0 * sig[0]
    key = (jax.random.PRNGKey(0),) if name in jsamplers.STOCHASTIC_SAMPLERS else ()
    want, draws, jseen = _jax_callbacks(name, x, sig, key)
    seen = []
    draws = list(draws)
    args = ((lambda like: torch.from_numpy(draws.pop(0))),) \
        if name in samplers.STOCHASTIC_SAMPLERS else ()
    decisions = []
    kw = {"decisions": decisions} if name == "DPM adaptive" else {}
    got = samplers.get_sampler(name)(den_torch, torch.from_numpy(x), torch.from_numpy(sig),
                                     *args, step_callback=lambda i, xx: seen.append(
                                         (i, xx.clone())), **kw)
    _close(got, want, 1e-5)
    assert [i for i, _ in seen] == [i for i, _ in jseen]
    assert all(isinstance(i, int) for i, _ in seen)
    for (_, a), (_, b) in zip(seen, jseen):
        _close(a, b, 1e-5)
    if name == "DPM adaptive":
        assert len(seen) == len(decisions) and not all(decisions)   # a rejected step too
    if name == "Restart":
        assert len(seen) > 5                    # the main schedule's and the restarts'


def test_every_sampler_takes_step_callback():
    """Every sampler calls back at least once a step and, but for DPM
    adaptive (whose final jump to sigma 0 calls back in neither package),
    last on its result."""
    sig = jschedule.NoiseSchedule().sampling_sigmas(5, "automatic")
    x = torch.from_numpy(X0 * sig[0])
    for name in samplers.SAMPLERS:
        gen = torch.Generator().manual_seed(0)
        args = ((lambda like: torch.randn(like.shape, generator=gen)),) \
            if name in samplers.STOCHASTIC_SAMPLERS else ()
        seen = []
        out = samplers.get_sampler(name)(den_torch, x, torch.from_numpy(sig), *args,
                                         step_callback=lambda i, xx: seen.append((i, xx)))
        assert seen, name
        if name not in ("DPM fast", "DPM adaptive"):
            assert len(seen) >= len(sig) - 1, name
        if name != "DPM adaptive":
            torch.testing.assert_close(seen[-1][1], out, rtol=0, atol=0, msg=name)


# ---------------------------------------------------------------- the pipeline


@pytest.fixture(scope="module")
def pipes():
    return standin_pipes()


def _collect(store, stop_after=None, pipe=None):
    """A step callback that records (i, x) and sets ``pipe.interrupted``
    after step ``stop_after``."""

    def cb(i, x):
        store.append((int(i), np.array(x, dtype=np.float32) if not isinstance(x, torch.Tensor)
                      else x.detach().cpu().numpy()))
        if stop_after is not None and int(i) == stop_after:
            pipe.interrupted = True

    return cb


@pytest.mark.parametrize("deepcache", [1, 2])
def test_pipeline_callbacks_and_interruption_match_jax(pipes, deepcache):
    """Tiled txt2img (16 x 32 latent, 3 tiles), Euler 5 steps at CFG 7: the
    callbacks of a whole run against JAX's (``jax.debug.callback`` runs its
    callbacks unordered and possibly after the program returns: flushed by
    ``jax.effects_barrier`` and put in step order). Then the port
    interrupted by its callback after step 2: steps 3 and 4 leave x as it is
    (under DeepCache the caches too), so its latents are JAX's x after step
    2. Then both pipelines interrupted before the first step: each returns
    its start, noise x sigma_0."""
    jpipe, port = pipes
    c, u = jax_cond(0), jax_cond(1)
    sp = dict(name="Euler", steps=5, deepcache=deepcache)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (1, 4, 16, 32)))

    def run_jax(**kw):
        return jpipe.txt2img(to_jax(c), to_jax(u), 256, 128, jcfg.SamplerConfig(**sp), seed=4,
                             tiled_diffusion=jcfg.TiledDiffusionConfig(**TD), decode=False,
                             **kw).latents

    def run_port(**kw):
        return port._txt2img_from_noise(noise, c, u, SamplerConfig(**sp), 4,
                                        TiledDiffusionConfig(**TD), decode=False, **kw).latents

    jseen, seen = [], []
    want = run_jax(step_callback=_collect(jseen))
    jax.effects_barrier()
    jseen.sort(key=lambda t: t[0])
    got = run_port(step_callback=_collect(seen))
    _close(got, want, 1e-4)
    assert [i for i, _ in seen] == [i for i, _ in jseen] == list(range(5))
    for (_, a), (_, b) in zip(seen, jseen):
        _close(a, b, 1e-4)

    stopped = []
    try:
        got = run_port(step_callback=_collect(stopped, 2, port))
        assert port.interrupted
    finally:
        port.interrupted = False
    assert [i for i, _ in stopped] == list(range(5))
    _close(got, jseen[2][1], 1e-4)
    for _, a in stopped[3:]:
        np.testing.assert_array_equal(a, stopped[2][1])

    jpipe.interrupted = port.interrupted = True
    try:
        want0, got0 = run_jax(), run_port()
    finally:
        jpipe.interrupted = port.interrupted = False
    sigma0 = port.schedule.sampling_sigmas(5)[0]
    _close(got0, want0, 1e-4)
    _close(got0, noise * sigma0, 1e-6)


def test_interrupted_img2img_with_mask_matches_jax(pipes):
    """The masked-redraw denoiser wraps the interruptible one, as in JAX: an
    interrupted step blends the init latent with x itself."""
    jpipe, port = pipes
    c, u = jax_cond(0), jax_cond(1)
    init = np.random.default_rng(5).normal(size=(1, 4, 16, 16)).astype(np.float32)
    yy, xx = np.mgrid[0:128, 0:128]
    mask = ((yy + xx) / 255.0).astype(np.float32)
    sp = dict(name="Euler", steps=6, denoising_strength=0.7)
    jpipe.interrupted = port.interrupted = True
    try:
        want = jpipe.img2img(None, to_jax(c), to_jax(u), jcfg.SamplerConfig(**sp), seed=2,
                             init_latents=jnp.asarray(init), mask=mask, decode=False).latents
        noise = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (1, 4, 16, 16)))
        got = port._img2img_from_noise(None, None, noise, c, u, SamplerConfig(**sp), 2,
                                       init_latents=init, mask=mask, decode=False).latents
    finally:
        jpipe.interrupted = port.interrupted = False
    _close(got, want, 1e-4)


def test_interrupted_demofusion_matches_jax(pipes):
    """DemoFusion x2 interrupted before it starts: phase 1's denoiser leaves
    x as it is (the result is its start, noise x sigma_0) and phase 2 never
    runs, as in JAX."""
    jpipe, port = pipes
    c, u = jax_cond(0), jax_cond(1)
    cfg = dict(scale_factor=2, window_size=8, overlap=4, tile_bs=2, tile_bs_g=2)
    jpipe.interrupted = port.interrupted = True
    try:
        want = jpipe.demofusion(to_jax(c), to_jax(u), 128, 128,
                                jcfg.DemoFusionConfig(**cfg),
                                jcfg.SamplerConfig(name="Euler", steps=4), seed=3,
                                decode=False).latents
        base = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (1, 4, 16, 16)))
        phase2 = np.zeros((1, 4, 32, 32), np.float32)
        res = port._demofusion_from_noise(base, [phase2], c, u, 128, 128,
                                          DemoFusionConfig(**cfg),
                                          SamplerConfig(name="Euler", steps=4), 3,
                                          decode=False)
    finally:
        jpipe.interrupted = port.interrupted = False
    assert len(res.phase_latents) == 1 and tuple(res.latents.shape) == (1, 4, 16, 16)
    _close(res.latents, want, 1e-4)
    sigma0 = port.schedule.sampling_sigmas(4)[0]
    _close(res.latents, base * sigma0, 1e-6)


def test_reset_reports_memory(pipes, capsys):
    """``reset`` drops the noise-inversion cache and reports the device
    memory (None on the CPU), as the JAX package's reports HBM."""
    _, port = pipes
    port.noise_inverse_cache = object()
    report = port.reset(clear_compiled=True)
    assert port.noise_inverse_cache is None
    assert report == {"device_in_use_mb": None, "device_peak_mb": None}
    assert "reset: device memory in use None MB" in capsys.readouterr().err


# ------------------------------------------------------ telemetry, checkpoints


def test_perfcount_prints_its_line():
    """The JAX package's line with "device" in place of "HBM"; no peak on
    the CPU, as the JAX package prints none where the device has no
    memory statistics."""
    out, jout = io.StringIO(), io.StringIO()
    with telemetry.perfcount("Tiled VAE", stream=out):
        torch.ones(3).sum()
    with jtelemetry.perfcount("Tiled VAE", stream=jout):
        jnp.ones(3).sum()
    pattern = r"\[Tiled VAE\]: Done in \d+\.\d{3}s(, peak device \d+\.\d MB)?\n"
    assert re.fullmatch(pattern, out.getvalue())
    jline = re.sub(r"\d+\.\d{3}s", "", jout.getvalue().replace("HBM", "device"))
    line = re.sub(r"\d+\.\d{3}s", "", out.getvalue())
    if "peak" not in jline:
        assert line == jline
    assert telemetry.device_memory_mb() is None if not torch.cuda.is_available() else True


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    import json

    with telemetry.profile_trace(str(tmp_path / "trace")) as d:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(f"{d}/trace.json", encoding="utf-8") as f:
        assert "traceEvents" in json.load(f)


def test_save_and_load_params_bit_equal(tmp_path):
    """A UNet's ``state_dict`` in fp32 and bf16 back bit for bit; with
    ``like`` on its device and in its dtype; a wrong shape or name raises."""
    from mdu_tpu_torch.models import UNet2DCondition, random_state_dict, tiny_unet_config

    unet = UNet2DCondition(tiny_unet_config())
    unet.load_state_dict(random_state_dict(unet, 0, device="cpu"))
    sd = unet.state_dict()
    path = str(tmp_path / "unet.safetensors")
    for dtype in (torch.float32, torch.bfloat16):
        ref = {k: v.to(dtype) for k, v in sd.items()}
        checkpoint.save_params(path, ref)
        got = checkpoint.load_params(path)
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].dtype == dtype
            torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0)
    checkpoint.save_params(path, unet)
    got = checkpoint.load_params(path, like=unet)
    for k, v in sd.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    bad = dict(sd)
    bad["conv_in.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="conv_in.weight"):
        checkpoint.load_params(path, like=bad)
    with pytest.raises(KeyError):
        checkpoint.load_params(path, like={"x": torch.zeros(1)})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_check_finite_message_matches_jax(dtype):
    x = np.ones((2, 3), np.float32)
    x[0, 1], x[1, 2] = np.nan, np.inf
    with pytest.raises(FloatingPointError) as jerr:
        jcheckpoint.check_finite(jnp.asarray(x).astype(
            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32), "latents")
    with pytest.raises(FloatingPointError) as err:
        checkpoint.check_finite(torch.from_numpy(x).to(dtype), "latents")
    assert str(err.value) == str(jerr.value)
    ok = torch.ones(2)
    assert checkpoint.check_finite(ok) is ok
