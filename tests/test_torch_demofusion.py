"""Port parity for DemoFusion: the phase plan, the jitter draws, the
gaussian blur, the window and dilated-view cond slicing of a ControlNet
hint, the denoiser over a stand-in model, and ``demofusion_generate`` at x2
on the tiny SDXL UNet + ControlNet (random gates) fed the JAX package's base
and phase noise, against ``mdu_tpu``. Tolerance: atol 1e-6 x max|ref| for
the blur and the cond slicing, 1e-5 x max|ref| for the denoiser (its mean
and std reduce in another order), 1e-4 x max|ref| for the pipeline (fp32 on
both sides, JAX at 'highest')."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdu_tpu import config as jcfg
from mdu_tpu.models import AutoencoderKL as JaxVAE
from mdu_tpu.models import random_params
from mdu_tpu.models import tiny_vae_config as jax_tiny_vae
from mdu_tpu.models.unet import tiny_sdxl_unet_config as jax_tiny_sdxl
from mdu_tpu.ops import blur as jblur
from mdu_tpu.pipeline import DiffusionPipeline as JaxPipeline
from mdu_tpu.tiling import demofusion as jdf
from mdu_tpu_torch import DemoFusionConfig, DiffusionPipeline, Method, SamplerConfig
from mdu_tpu_torch import config as pcfg
from mdu_tpu_torch.models import AutoencoderKL, load_jax_params, tiny_vae_config
from mdu_tpu_torch.ops import blur
from mdu_tpu_torch.tiling import demofusion as pdf
from mdu_tpu_torch.tiling.schedulers import plan_tiled_diffusion
from test_torch_sdxl import CTX, build_tiny_sdxl

torch.set_num_threads(2)
CFG = dict(window_size=16, overlap=8, tile_bs=4, tile_bs_g=4, scale_factor=2)


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _plan_fields(plan):
    return (plan.scale, plan.h, plan.w, plan.tile, plan.jitter,
            [(b.x, b.y, b.w, b.h) for b in plan.windows], plan.window_batches,
            plan.jitter_lo, plan.jitter_hi, plan.global_offsets, plan.global_batches)


# (h, w, scale, knobs): config 5's phases 2 and 3 first
PLANS = [(256, 256, 2, dict(window_size=128, overlap=64, tile_bs=2, tile_bs_g=2)),
         (384, 384, 3, dict(window_size=128, overlap=64, tile_bs=2, tile_bs_g=2)),
         (32, 48, 2, {}), (32, 32, 2, dict(mixture=True)), (24, 40, 3, dict(overlap=2)),
         (12, 12, 2, dict(random_jitter=False)), (40, 24, 4, dict(window_size=100))]


@pytest.mark.parametrize("h,w,scale,knobs", PLANS)
def test_plan_and_jitter_match_jax(h, w, scale, knobs):
    """Windows, jitter ranges (edge windows inward only), offsets with and
    without mixture, batches; then the jitter of two phases drawn from one
    seeded generator, in order."""
    cfg = dataclasses.replace(DemoFusionConfig(**CFG), **knobs)
    jc = dataclasses.replace(jcfg.DemoFusionConfig(**CFG), **knobs)
    plan, jplan = pdf.plan_demofusion_phase(h, w, scale, cfg), jdf.plan_demofusion_phase(
        h, w, scale, jc)
    assert _plan_fields(plan) == _plan_fields(jplan)
    rng, jrng = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(2):
        np.testing.assert_array_equal(pdf.draw_jitter(plan, rng), jdf.draw_jitter(jplan, jrng))


def test_config_five_plan_counts():
    """Config 5's phases: 9 windows in 5 batches and 4 views in 2 at 256^2; 25
    windows in 13 batches and 9 views in 5 at 384^2 (18 calls a step)."""
    cfg = DemoFusionConfig(window_size=128, overlap=64, scale_factor=3, tile_bs=2, tile_bs_g=2)
    p2, p3 = (pdf.plan_demofusion_phase(128 * s, 128 * s, s, cfg) for s in (2, 3))
    assert (len(p2.windows), len(p2.window_batches), len(p2.global_batches)) == (9, 5, 2)
    assert (len(p3.windows), len(p3.window_batches), len(p3.global_batches)) == (25, 13, 5)


@pytest.mark.parametrize("k,sigma,shape", [(3, 0.6, (1, 4, 16, 20)), (5, 0.25, (2, 3, 9, 7)),
                                           (1, 0.5, (1, 2, 5, 5))])
def test_gaussian_blur_matches_jax(rng, k, sigma, shape):
    x = rng.normal(size=shape).astype(np.float32)
    _close(blur.gaussian_kernel_1d(k, sigma), jblur.gaussian_kernel_1d(k, jnp.float32(sigma)),
           rel=1e-6)
    _close(blur.gaussian_blur_nchw(torch.from_numpy(x), k, sigma),
           jblur.gaussian_blur_nchw(jnp.asarray(x), k, sigma), rel=1e-6)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert blur.gaussian_blur_nchw(xb, k, sigma).dtype == torch.bfloat16


def _conds(rng, H, W):
    """A cond with a latent-canvas leaf, a pixel-space hint and a vector leaf,
    numpy -> (jax cond, port cond)."""
    leaves = {"crossattn": rng.normal(size=(1, 7, CTX)).astype(np.float32),
              "concat": rng.normal(size=(1, 2, H, W)).astype(np.float32)}
    hint = rng.uniform(size=(1, 3, H * 8, W * 8)).astype(np.float32)
    jc = {**{k: jnp.asarray(v) for k, v in leaves.items()}, "control": [jnp.asarray(hint)]}
    pc = {**{k: torch.from_numpy(v) for k, v in leaves.items()},
          "control": [torch.from_numpy(hint)]}
    return jc, pc


def _cmp_cond(got, want, rel=1e-6):
    assert set(got) == set(want)
    for key in want:
        if key == "control":
            assert len(got[key]) == len(want[key])
            for g, w in zip(got[key], want[key]):
                _close(g, w, rel)
        else:
            _close(got[key], want[key], rel)


def test_cond_slicing_matches_jax(rng):
    """_pad_spatial, _window_cond at jittered offsets, _dilated_cond (strided
    latent leaves, the hint resized to the view) and resize_spatial_conds."""
    H, W, jr, tile, s = 16, 24, 3, 8, 2
    jc, pc = _conds(rng, H, W)
    jpad, ppad = jdf._pad_spatial(jc, jr, (H, W)), pdf._pad_spatial(pc, jr, (H, W))
    _cmp_cond(ppad, jpad, rel=0)
    offs = [(0, 5), (7, 1), (3, 3)]
    _cmp_cond(pdf._window_cond(ppad, offs, tile, (H, W), jr),
              jdf._window_cond(jpad, [(jnp.int32(a), jnp.int32(b)) for a, b in offs], tile,
                               (H, W), jr), rel=0)
    views = ((0, 1), (1, 0), (1, 1))
    _cmp_cond(pdf._dilated_cond(pc, views, s, (H, W)), jdf._dilated_cond(jc, views, s, (H, W)))
    _cmp_cond(pdf.resize_spatial_conds(pc, (H, W), (2 * H, 2 * W)),
              jdf.resize_spatial_conds(jc, (H, W), (2 * H, 2 * W)))
    assert pdf.resize_spatial_conds(pc, (H, W), (H, W)) is pc


@pytest.mark.parametrize("knobs", [dict(), dict(mixture=True), dict(gaussian_filter=False)])
def test_denoiser_matches_jax(rng, knobs):
    """The combinator over a stand-in model that reads its batch's hint, so
    that each window's and view's cut shows (as tests/test_demofusion.py:81
    drives JAX's with an identity)."""
    cfg = dataclasses.replace(DemoFusionConfig(**CFG), **knobs)
    jc_ = dataclasses.replace(jcfg.DemoFusionConfig(**CFG), **knobs)
    H = W = 32
    plan, jplan = pdf.plan_demofusion_phase(H, W, 2, cfg), jdf.plan_demofusion_phase(H, W, 2, jc_)
    jitter = pdf.draw_jitter(plan, np.random.default_rng(1))
    lat0 = rng.normal(size=(1, 4, H, W)).astype(np.float32)
    noise = rng.normal(size=(1, 4, H, W)).astype(np.float32)
    x = rng.normal(size=(1, 4, H, W)).astype(np.float32)
    jcond, pcond = _conds(rng, H, W)
    jun, pun = _conds(rng, H, W)

    def guided(views, sigma, c, u):
        m = c["control"][0].mean(axis=(1, 2, 3)) - u["control"][0].mean(axis=(1, 2, 3))
        return views * 0.5 + m.reshape(-1, 1, 1, 1) * sigma

    fn = pdf.make_demofusion_denoiser(plan, cfg, lambda dev: (guided, None), pcond, pun,
                                      torch.from_numpy(lat0), torch.from_numpy(noise), 4,
                                      jitter, pdf.windows_walk(None, plan, cfg),
                                      pdf.views_walk(None, plan, cfg))
    jfn = jdf.make_demofusion_denoiser(jplan, jc_, guided, jcond, jun, jnp.asarray(lat0),
                                       jnp.asarray(noise), t_enc=4, jitter=jnp.asarray(jitter))
    for step, sigma in ((0, 3.0), (3, 0.7)):
        got = fn(torch.from_numpy(x), torch.tensor(sigma), step)
        want = jfn(jnp.asarray(x), jnp.float32(sigma), jnp.int32(step))
        _close(got, want, rel=1e-5)


@pytest.fixture(scope="module")
def sdxl_pipes():
    # a two-level SDXL UNet and ControlNet (the tiny config's first two
    # levels): JAX compiles the DemoFusion programs in about half the time
    unet, up, cn, cp, port_unet, port_cn = build_tiny_sdxl(dataclasses.replace(
        jax_tiny_sdxl(), block_out_channels=(8, 16), transformer_layers=(0, 1)))
    vae = JaxVAE(jax_tiny_vae())
    vp = random_params(vae, 1, jnp.zeros((1, 3, 32, 32)), jax.random.PRNGKey(0))
    jpipe = JaxPipeline(unet, up, vae, vp, controlnet=cn, controlnet_params=cp)
    pvae = load_jax_params(AutoencoderKL(tiny_vae_config()), jax.tree.map(np.asarray, vp))
    return jpipe, DiffusionPipeline(port_unet, pvae, device="cpu", controlnet=port_cn)


def _sdxl_conds(seed):
    """cond and uncond with crossattn, vector and a nonzero 128 x 128 hint."""
    rng = np.random.default_rng(seed)
    ctx = (rng.normal(size=(1, 7, CTX)) * 0.5).astype(np.float32)
    vec = rng.normal(size=(1, 16)).astype(np.float32)
    hint = rng.uniform(size=(1, 3, 96, 96)).astype(np.float32)      # fitted to 128 x 128
    c = {"crossattn": ctx, "vector": vec, "control": [hint]}
    u = {"crossattn": np.zeros_like(ctx), "vector": vec, "control": [hint]}

    def to(d, f):
        return {k: ([f(h) for h in v] if k == "control" else f(v)) for k, v in d.items()}

    return (to(c, jnp.asarray), to(u, jnp.asarray)), (to(c, torch.from_numpy),
                                                      to(u, torch.from_numpy))


@pytest.mark.parametrize("knobs", [dict(), dict(mixture=True)])
def test_demofusion_generate_matches_jax(sdxl_pipes, knobs):
    """x2 from a 16 x 16 latent with the gaussian filter on (and once with
    mixture): both phases' latents and the info block, read back through
    demofusion_from_png_info. One window batch and one view batch a step."""
    jpipe, pipe = sdxl_pipes
    (jc, ju), (pc, pu) = _sdxl_conds(4)
    df = dict(window_size=16, overlap=8, tile_bs=9, tile_bs_g=8, scale_factor=2, **knobs)
    sp = dict(steps=3, denoising_strength=0.6)
    seed = 5
    want = jpipe.demofusion(jc, ju, 128, 128, jcfg.DemoFusionConfig(**df),
                            jcfg.SamplerConfig(**sp), seed=seed, decode=False)
    want_base = jpipe.txt2img(jc, ju, 128, 128, sampler=jcfg.SamplerConfig(**sp), seed=seed,
                              decode=False).latents
    base = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (1, 4, 16, 16)))
    phase = np.asarray(jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(seed), 102),
                                         (1, 4, 32, 32)))
    got = pipe._demofusion_from_noise(torch.from_numpy(base), [torch.from_numpy(phase)], pc, pu,
                                      128, 128, DemoFusionConfig(**df), SamplerConfig(**sp),
                                      seed=seed, decode=False)
    assert len(got.phase_latents) == 2
    _close(got.phase_latents[0], want_base)
    _close(got.latents, want.latents)
    assert got.info == want.info
    back, bsp = pcfg.demofusion_from_png_info(got.info)
    jback, jsp = jcfg.demofusion_from_png_info(want.info)
    assert back == DemoFusionConfig(**df)
    assert dataclasses.asdict(back) == dataclasses.asdict(jback)
    assert (bsp.name, bsp.steps, bsp.cfg_scale) == (jsp.name, jsp.steps, jsp.cfg_scale)


def test_demofusion_entry_points_run_on_cpu(sdxl_pipes):
    """pipe.demofusion draws its own noise; keep_intermediate off keeps the
    last phase; DeepCache runs on the views (test_torch_deepcache.py holds it
    against the JAX package); the tile planner points DemoFusion to its entry
    point."""
    _, pipe = sdxl_pipes
    _, (pc, pu) = _sdxl_conds(6)
    cfg = DemoFusionConfig(**{**CFG, "keep_intermediate": False})
    res = pipe.demofusion(pc, pu, 64, 64, cfg, SamplerConfig(steps=2), seed=3, decode=True)
    assert res.latents.shape == (1, 4, 16, 16) and len(res.phase_latents) == 2
    assert len(res.images) == 1 and res.images[0].shape == (1, 128, 128, 3)
    assert res.info["DemoFusion"]["Phase sizes"] == [[64, 64], [128, 128]]
    again = pipe.demofusion(pc, pu, 64, 64, cfg, SamplerConfig(steps=2), seed=3, decode=False)
    torch.testing.assert_close(again.latents, res.latents, rtol=0, atol=0)
    cached = pipe.demofusion(pc, pu, 64, 64, cfg, SamplerConfig(steps=2, deepcache=2),
                             decode=False)
    assert cached.latents.shape == res.latents.shape and torch.isfinite(cached.latents).all()
    with pytest.raises(NotImplementedError, match="DiffusionPipeline.demofusion"):
        plan_tiled_diffusion(Method.DEMO_FU, 32, 32)


# ----------------------------------------------- the mesh and the scan (stand-in UNet)


@pytest.fixture(scope="module")
def standin_meshes():
    """The stand-in UNet's pipelines (``test_torch_deepcache.py``): JAX and
    the port on one device, and each on a mesh of two (JAX's
    ``make_tile_mesh(2)``, the port's ``["cpu"] * 2``)."""
    from mdu_tpu.parallel import make_tile_mesh as jax_tile_mesh
    from mdu_tpu_torch.parallel import make_tile_mesh
    from test_torch_deepcache import standin_pipes

    return (standin_pipes(),
            standin_pipes(jax_kw={"mesh": jax_tile_mesh(2)},
                          mesh=make_tile_mesh(devices=["cpu"] * 2)))


# window 16 at overlap 8 on the 32 x 32 phase: 9 windows (2 shards: 5 and 4,
# padded to 5 and 5), 4 views (8 with mixture)
STAND_DF = dict(window_size=16, overlap=8, tile_bs=2, tile_bs_g=3, scale_factor=2)
DF_CASES = {"plain": ({}, dict(name="Euler", steps=4, denoising_strength=0.7)),
            "deepcache_mixture": (dict(mixture=True),
                                  dict(name="Euler", steps=6, denoising_strength=0.7,
                                       deepcache=2)),
            "scan": (dict(scan_windows=True), dict(name="Euler", steps=4,
                                                   denoising_strength=0.7)),
            "scan_deepcache": (dict(scan_windows=True, mixture=True),
                               dict(name="Euler", steps=6, denoising_strength=0.7,
                                    deepcache=2))}


def _standin_demofusion(pipes, knobs, sp, seed=5):
    from test_torch_deepcache import jax_cond, to_jax

    jpipe, port = pipes
    df = dict(STAND_DF, **knobs)
    c, u = jax_cond(0), jax_cond(1)
    want = jpipe.demofusion(to_jax(c), to_jax(u), 128, 128, jcfg.DemoFusionConfig(**df),
                            jcfg.SamplerConfig(**sp), seed=seed, decode=False).latents
    base = np.array(jax.random.normal(jax.random.PRNGKey(seed), (1, 4, 16, 16)))
    phase = np.array(jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(seed), 102),
                                       (1, 4, 32, 32)))
    got = port._demofusion_from_noise(torch.from_numpy(base), [torch.from_numpy(phase)], c, u,
                                      128, 128, DemoFusionConfig(**df), SamplerConfig(**sp),
                                      seed=seed, decode=False).latents
    return got, want


@pytest.mark.parametrize("case", ["plain", "deepcache_mixture"])
def test_demofusion_on_a_mesh_matches_jax(standin_meshes, case):
    """DemoFusion x2 on a 2-shard mesh, the windows and views sharded (under
    DeepCache one cache a chunk on its shard), against JAX's on its 2-device
    mesh within 1e-4 x max; and against the port's one device to the bit:
    the stand-in is elementwise per sample, so another batch composition
    changes nothing."""
    single, mesh = standin_meshes
    knobs, sp = DF_CASES[case]
    got, want = _standin_demofusion(mesh, knobs, sp)
    _close(got, want)
    one, _ = _standin_demofusion(single, knobs, sp)
    torch.testing.assert_close(got, one, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["scan", "scan_deepcache"])
def test_demofusion_scan_matches_jax(standin_meshes, case):
    """``scan_windows`` on one device: the port runs the window and view
    batches unrolled, within 1e-5 x max of JAX's ``lax.scan`` (the batches
    padded to the widest at weight 0, under DeepCache one uniform cache a
    view batch)."""
    single, _ = standin_meshes
    knobs, sp = DF_CASES[case]
    got, want = _standin_demofusion(single, knobs, sp)
    _close(got, want, rel=1e-5)


@pytest.mark.parametrize("scan_windows,env,thresh,h", [
    (None, None, None, 32), (None, None, "20", 32), (None, None, None, 64),
    (True, None, None, 32), (False, None, "2", 64), (None, "1", None, 32),
    (None, "0", "2", 64)])
def test_df_scan_decision_matches_jax(monkeypatch, scan_windows, env, thresh, h):
    """``resolve_df_scan`` against ``_resolve_df_scan``: the knob first, then
    ``MDU_DF_SCAN``, then the batch count against ``MDU_TILE_SCAN_THRESHOLD``;
    the port's views walk the unrolled batches whatever it decides."""
    for name, val in (("MDU_DF_SCAN", env), ("MDU_TILE_SCAN_THRESHOLD", thresh)):
        if val is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, val)
    # mixture: 8 views in batches of 3, 3, 2
    knobs = dict(STAND_DF, mixture=True, scan_windows=scan_windows)
    cfg, jc_ = DemoFusionConfig(**knobs), jcfg.DemoFusionConfig(**knobs)
    plan, jplan = pdf.plan_demofusion_phase(h, h, 2, cfg), jdf.plan_demofusion_phase(h, h, 2, jc_)
    want = jdf._resolve_df_scan(jc_, jplan)
    assert pdf.resolve_df_scan(cfg, plan) == want
    assert pdf.resolve_df_scan(cfg) == jdf._resolve_df_scan(jc_)
    walk = pdf.views_walk(None, plan, cfg)
    widths = [len(ids) for _, _, ids, _ in walk]
    assert widths == [3, 3, 2]
