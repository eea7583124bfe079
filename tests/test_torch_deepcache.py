"""Port parity for DeepCache and DemoFusion's conds: the UNet's write and read
passes (SD1.5 at branches 1 and 2, SDXL, with residuals on the read pass),
the cache shapes, txt2img with ``deepcache=2`` under seven samplers, the
refusing samplers, a tiled run with a region, a masked img2img, the grid
without the fused blend, and DemoFusion with DeepCache and an AND cond and
with a scheduled cond, against ``mdu_tpu``.

The pipeline cases run a stand-in UNet (``JaxStandIn`` / ``TorchStandIn``)
that keeps the UNet's contract (cache modes, residuals, ``adm``, an image
``concat``) in a few elementwise ops, so that each JAX program compiles in
about a second; the real UNet's cache modes are held at the module level and
in one untiled txt2img. Tolerance: atol 1e-5 x max|ref| for modules, 1e-4 x
max|ref| for pipelines (fp32 on both sides, JAX at 'highest')."""
import dataclasses
from typing import Any

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import mdu_tpu.config as jcfg
from mdu_tpu.models import AutoencoderKL as JaxVAE
from mdu_tpu.models import UNet2DCondition as JaxUNet
from mdu_tpu.models import random_params
from mdu_tpu.models import tiny_unet_config as jax_tiny_unet
from mdu_tpu.models import tiny_vae_config as jax_tiny_vae
from mdu_tpu.models.unet import UNetConfig as JaxUNetConfig
from mdu_tpu.models.unet import tiny_sdxl_unet_config as jax_tiny_sdxl
from mdu_tpu.pipeline import DiffusionPipeline as JaxPipeline
from mdu_tpu.tiling import demofusion as jdf
from mdu_tpu.tiling import regions as jregions
from mdu_tpu.tiling.schedulers import plan_tiled_diffusion as jax_plan
from mdu_tpu.utils import bbox as jbbox
from mdu_tpu_torch import (DemoFusionConfig, DiffusionPipeline, Method, SamplerConfig,
                           TiledDiffusionConfig)
from mdu_tpu_torch.models import (AutoencoderKL, UNet2DCondition, load_jax_params,
                                  random_state_dict, tiny_sdxl_unet_config, tiny_unet_config,
                                  tiny_vae_config)
from mdu_tpu_torch.models.unet import UNetConfig
from mdu_tpu_torch.samplers import samplers
from mdu_tpu_torch.samplers.denoiser import mark_deepcache
from mdu_tpu_torch.tiling import demofusion as pdf
from mdu_tpu_torch.tiling import schedulers
from mdu_tpu_torch.tiling.schedulers import plan_tiled_diffusion
from mdu_tpu_torch.utils.bbox import RegionSpec

torch.set_num_threads(2)
TD = dict(method=Method.MULTI_DIFF, tile_w=16, tile_h=16, overlap=8, tile_bs=2)


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------ the stand-in UNet


def _shallow_count(cfg, branch):
    """The skips a read pass at ``branch`` has: conv_in, ``layers_per_block``
    a shallow level, a downsample between them."""
    return 1 + branch * cfg.layers_per_block + (branch - 1)


class JaxStandIn(fnn.Module):
    """The UNet's call contract in a few elementwise ops, no weights: a
    shallow term of the latent (and of an image ``concat``, the time, the
    context's mean, an ``adm``'s mean and the shallow residuals), and a deep
    term through the cached feature [B, C_b, H / 2^(b-1), W / 2^(b-1)] (the
    mid residual enters it), so that a stale or misplaced cache shows."""

    cfg: Any
    dtype: Any = jnp.float32
    layout: str = "NCHW"

    @fnn.compact
    def __call__(self, x, timesteps, context, added_cond=None, residuals=None, cache=None,
                 cache_mode=None, cache_branch=1):
        cfg, b = self.cfg, cache_branch
        read, down, oc, B = cache_mode == "read", 2 ** (cache_branch - 1), cfg.out_channels, \
            x.shape[0]
        x = x.astype(jnp.float32)

        def col(v):
            return v.reshape(B, 1, 1, 1)

        cond = (col(jnp.sin(timesteps.astype(jnp.float32) * 0.013))
                + col(context.astype(jnp.float32).mean(axis=(1, 2))))
        if cfg.adm_in_channels is not None:
            cond = cond + col(added_cond["adm"].astype(jnp.float32).mean(axis=1))
        shallow = jnp.tanh(x[:, :oc]) * 0.7 + cond
        if x.shape[1] > oc:
            shallow = shallow + x[:, oc:].sum(axis=1, keepdims=True) * 0.2
        mid = 0.0
        if residuals is not None:
            down_res, mid_res = residuals
            used = down_res[:_shallow_count(cfg, b)] if read else down_res
            shallow = shallow + 0.5 * sum(col(r.astype(jnp.float32).mean(axis=(1, 2, 3)))
                                          for r in used)
            mid = col(mid_res.astype(jnp.float32).mean(axis=(1, 2, 3)))
        if read:
            f = cache.astype(jnp.float32)
        else:
            scale = 1.0 + 0.1 * jnp.arange(cfg.block_out_channels[b], dtype=jnp.float32)
            f = jnp.tanh(x[:, :1, ::down, ::down] * 1.3 + cond + mid) * scale.reshape(1, -1, 1, 1)
        deep = jnp.repeat(jnp.repeat(f.mean(axis=1, keepdims=True), down, 2), down, 3)
        out = (shallow + 0.3 * jnp.sin(deep * 2.0)).astype(self.dtype)
        if cache_mode == "write":
            return out, f.astype(self.dtype)
        return out


class TorchStandIn(nn.Module):
    """``JaxStandIn`` in torch."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype

    def forward(self, x, timesteps, context, added_cond=None, residuals=None, cache=None,
                cache_mode=None, cache_branch=1):
        cfg, b = self.cfg, cache_branch
        read, down, oc, B = cache_mode == "read", 2 ** (cache_branch - 1), cfg.out_channels, \
            x.shape[0]
        x = x.float()

        def col(v):
            return v.reshape(B, 1, 1, 1)

        cond = (col(torch.sin(timesteps.float() * 0.013))
                + col(context.float().mean(dim=(1, 2))))
        if cfg.adm_in_channels is not None:
            cond = cond + col(added_cond["adm"].float().mean(dim=1))
        shallow = torch.tanh(x[:, :oc]) * 0.7 + cond
        if x.shape[1] > oc:
            shallow = shallow + x[:, oc:].sum(dim=1, keepdim=True) * 0.2
        mid = 0.0
        if residuals is not None:
            down_res, mid_res = residuals
            used = down_res[:_shallow_count(cfg, b)] if read else down_res
            shallow = shallow + 0.5 * sum(col(r.float().mean(dim=(1, 2, 3))) for r in used)
            mid = col(mid_res.float().mean(dim=(1, 2, 3)))
        if read:
            f = cache.float()
        else:
            scale = 1.0 + 0.1 * torch.arange(cfg.block_out_channels[b], dtype=torch.float32)
            f = torch.tanh(x[:, :1, ::down, ::down] * 1.3 + cond + mid) * scale.reshape(1, -1, 1, 1)
        deep = f.mean(dim=1, keepdim=True).repeat_interleave(down, 2).repeat_interleave(down, 3)
        out = (shallow + 0.3 * torch.sin(deep * 2.0)).to(self.dtype)
        if cache_mode == "write":
            return out, f.to(self.dtype)
        return out


def standin_pipes(jax_cfg=None, port_cfg=None, **port_kw):
    """A JAX and a port pipeline over the stand-in UNet of the tiny configs
    (the given ones), with the tiny VAE (random weights, the same on both
    sides). ``port_kw`` go to the port's pipeline, ``jax_kw`` of it are
    popped for the JAX one."""
    jax_kw = port_kw.pop("jax_kw", {})
    vae = JaxVAE(jax_tiny_vae())
    vp = random_params(vae, 1, jnp.zeros((1, 3, 64, 64)), jax.random.PRNGKey(0))
    jpipe = JaxPipeline(JaxStandIn(jax_cfg or jax_tiny_unet()), {}, vae, vp, **jax_kw)
    port = DiffusionPipeline(TorchStandIn(port_cfg or tiny_unet_config()),
                             load_jax_params(AutoencoderKL(tiny_vae_config()), _np(vp)),
                             device="cpu", **port_kw)
    return jpipe, port


def jax_cond(seed, L=7):
    return {"crossattn": np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (1, L, 16))) * 0.1}


def to_jax(c):
    if c is None:
        return None
    if "__and__" in c:
        return {"__and__": [to_jax(p) for p in c["__and__"]], "__weights__": c["__weights__"]}
    if "__bank__" in c:
        return {"__bank__": to_jax(c["__bank__"]),
                "__index__": jnp.asarray(c["__index__"], jnp.int32)}
    return {k: jnp.asarray(v) for k, v in c.items()}


@pytest.fixture(scope="module")
def pipes():
    return standin_pipes()


# --------------------------------------------------------------- the real UNet


def _skip_shapes(cfg, B, H, W):
    """The UNet's skip shapes and its mid state's, for ControlNet-like
    residuals."""
    shapes, h, w = [(B, cfg.block_out_channels[0], H, W)], H, W
    L = len(cfg.block_out_channels)
    for i, ch in enumerate(cfg.block_out_channels):
        shapes += [(B, ch, h, w)] * cfg.layers_per_block
        if i != L - 1:
            h, w = (h + 1) // 2, (w + 1) // 2
            shapes.append((B, ch, h, w))
    return shapes, (B, cfg.block_out_channels[-1], h, w)


@pytest.mark.parametrize("arch,branch", [("sd15", 1), ("sd15", 2), ("sdxl", 1)])
def test_unet_cache_modes_match_jax(rng, arch, branch):
    """Write: the plain output and the feature after up_{L-b-1}_upsample;
    read from that feature: the plain output again. Both with residuals on
    every skip and the mid state, which the read pass zips against its
    shallow skips and drops the mid one. SDXL's level 0 has no transformer."""
    jcfg_, pcfg_ = ((jax_tiny_unet(), tiny_unet_config()) if arch == "sd15"
                    else (jax_tiny_sdxl(), tiny_sdxl_unet_config()))
    B, H = 2, 16
    x = rng.normal(size=(B, 4, H, H)).astype(np.float32)
    t = np.array([5.0, 9.0], np.float32)
    ctx = rng.normal(size=(B, 7, 16)).astype(np.float32)
    added = None
    if arch == "sdxl":
        added = {"text_embeds": rng.normal(size=(B, 16)).astype(np.float32),
                 "time_ids": np.ones((B, 6), np.float32)}
    shapes, mid_shape = _skip_shapes(jcfg_, B, H, H)
    res = ([rng.normal(size=s).astype(np.float32) * 0.1 for s in shapes],
           rng.normal(size=mid_shape).astype(np.float32) * 0.1)
    junet = JaxUNet(jcfg_)
    jadded = None if added is None else {k: jnp.asarray(v) for k, v in added.items()}
    params = random_params(junet, 3, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), jadded)
    jres = ([jnp.asarray(r) for r in res[0]], jnp.asarray(res[1]))

    def write_read(p):
        w, f = junet.apply(p, x, t, ctx, jadded, residuals=jres, cache_mode="write",
                           cache_branch=branch)
        return w, f, junet.apply(p, x, t, ctx, jadded, residuals=jres, cache=f,
                                 cache_mode="read", cache_branch=branch)

    jw, jf, jr = jax.jit(write_read)(params)
    unet = load_jax_params(UNet2DCondition(pcfg_), _np(params))
    tx, tt, tc = torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx)
    tadded = None if added is None else {k: torch.from_numpy(v) for k, v in added.items()}
    tres = ([torch.from_numpy(r) for r in res[0]], torch.from_numpy(res[1]))
    with torch.no_grad():
        plain = unet(tx, tt, tc, tadded, residuals=tres)
        pw, pf = unet(tx, tt, tc, tadded, residuals=tres, cache_mode="write",
                      cache_branch=branch)
        pr = unet(tx, tt, tc, tadded, residuals=tres, cache=pf, cache_mode="read",
                  cache_branch=branch)
        for bad in (0, len(pcfg_.block_out_channels)):
            with pytest.raises(ValueError, match="cache_branch"):
                unet(tx, tt, tc, tadded, cache_mode="write", cache_branch=bad)
    down = 2 ** (branch - 1)
    assert tuple(pf.shape) == (B, pcfg_.block_out_channels[branch], H // down, H // down)
    torch.testing.assert_close(pw, plain, rtol=0, atol=0)
    _close(pf, jf, 1e-5)
    _close(pw, jw, 1e-5)
    _close(pr, jr, 1e-5)
    _close(pr, plain.numpy(), 1e-6)


def test_real_unet_txt2img_deepcache_matches_jax():
    """A real UNet (the tiny config's first level and its mid-block, which
    JAX compiles in about half the four-level one's time) untiled (16 x 16
    latent), Euler 4 steps at CFG 7 under deepcache=2: steps 1 and 3 read the
    cache step 0 and 2 wrote."""
    two_levels = dict(block_out_channels=(8, 16), cross_attention_dim=16, num_heads=2,
                      transformer_layers=(1, 0), norm_num_groups=4)
    junet, vae = JaxUNet(JaxUNetConfig(**two_levels)), JaxVAE(jax_tiny_vae())
    up = random_params(junet, 0, jnp.zeros((1, 4, 16, 16)), jnp.zeros((1,)),
                       jnp.zeros((1, 7, 16)))
    jpipe = JaxPipeline(junet, up, vae, {})
    port = DiffusionPipeline(load_jax_params(UNet2DCondition(UNetConfig(**two_levels)),
                                             _np(up)),
                             AutoencoderKL(tiny_vae_config()), device="cpu")
    c, u = jax_cond(0), jax_cond(1)
    sp = dict(name="Euler", steps=4, deepcache=2)
    want = jpipe.txt2img(to_jax(c), to_jax(u), 128, 128, jcfg.SamplerConfig(**sp), seed=3,
                         decode=False).latents
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (1, 4, 16, 16)))
    got = port._txt2img_from_noise(noise, c, u, SamplerConfig(**sp), 3, decode=False).latents
    _close(got, want)
    exact = port._txt2img_from_noise(noise, c, u, SamplerConfig(name="Euler", steps=4), 3,
                                     decode=False).latents
    assert (exact - got).abs().max() > 1e-4


def test_one_step_deepcache_equals_plain():
    """With one step only the full step 0 runs: the cached program is the
    plain one (the real tiny UNet, tiled)."""
    unet = UNet2DCondition(tiny_unet_config())
    unet.load_state_dict(random_state_dict(unet, 0, device="cpu"))
    port = DiffusionPipeline(unet, AutoencoderKL(tiny_vae_config()), device="cpu")
    c, u = jax_cond(0), jax_cond(1)
    noise = torch.randn(1, 4, 16, 32, generator=torch.Generator().manual_seed(0))
    runs = [port._txt2img_from_noise(noise, c, u, SamplerConfig(steps=1, deepcache=n), 0,
                                     TiledDiffusionConfig(**TD), decode=False).latents
            for n in (1, 2)]
    torch.testing.assert_close(runs[1], runs[0], rtol=0, atol=0)


def test_guided_denoiser_matches_jax(rng):
    """``GuidedDenoiser`` over the stand-in model: [uncond; cond] in one call
    and CFG 7; one cond alone; no CFG without an uncond."""
    from mdu_tpu.samplers.denoiser import GuidedDenoiser as JaxGuided
    from mdu_tpu.samplers.schedule import NoiseSchedule as JaxSchedule
    from mdu_tpu_torch.samplers.denoiser import GuidedDenoiser
    from mdu_tpu_torch.samplers.schedule import NoiseSchedule

    jm, pm = JaxStandIn(jax_tiny_unet()), TorchStandIn(tiny_unet_config())
    c, u = jax_cond(0), jax_cond(1)
    x = rng.normal(size=(1, 4, 8, 8)).astype(np.float32) * 3
    for uu in (u, None):
        jg = JaxGuided(lambda xx, t, cc: jm.apply({}, xx, t, cc["crossattn"]), JaxSchedule(),
                       to_jax(c), to_jax(uu), 7.0)
        pg = GuidedDenoiser(lambda xx, t, cc: pm(xx, t, cc["crossattn"]), NoiseSchedule(),
                            {k: torch.from_numpy(v) for k, v in c.items()},
                            None if uu is None else
                            {k: torch.from_numpy(v) for k, v in uu.items()}, 7.0)
        _close(pg(torch.from_numpy(x), torch.tensor(2.5)), jg(jnp.asarray(x), jnp.float32(2.5)),
               1e-5)
    _close(pg.denoise_with_cond(torch.from_numpy(x), torch.tensor(0.7),
                                {k: torch.from_numpy(v) for k, v in u.items()}),
           jg.denoise_with_cond(jnp.asarray(x), jnp.float32(0.7), to_jax(u)), 1e-5)


# ------------------------------------------------------------------ the caches


def _aux_shapes(caches):
    return [tuple(c.shape) for c in caches]


@pytest.mark.parametrize("case", ["untiled", "and", "image_cfg", "uniform", "branch2",
                                  "no_uncond", "odd", "scan"])
def test_deepcache_aux_matches_jax(pipes, case):
    """``_deepcache_aux``'s caches against the JAX package's unrolled grid's
    (a plan that scans runs unrolled in the port: one cache a batch, where
    the JAX scan keeps one a chunk of ``tile_bs``): mult 2 / P + 1 / 3 / 1,
    ``Kp`` per batch or ``tile_bs`` when uniform, the width and size at the
    branch, and the error for tile dims the branch's 2^(b-1) does not
    divide."""
    jpipe, port = pipes
    c, u = jax_cond(0), jax_cond(1)
    h, w, td, branch, icfg = 16, 40, dict(TD, tile_bs=3), 1, None
    if case == "and":
        c = {"__and__": [c, jax_cond(2), jax_cond(3)], "__weights__": (1.0, 0.5, 0.2)}
    elif case == "image_cfg":
        icfg = 1.5
    elif case == "uniform":
        td["uniform_batches"] = True
    elif case == "branch2":
        branch = 2
    elif case == "no_uncond":
        u = None
    elif case == "odd":
        branch, h, w, td = 2, 13, 30, dict(td, tile_w=13, tile_h=13)
    scan = case == "scan"
    plan = plan_tiled_diffusion(td["method"], h, w, tile_h=td["tile_h"], tile_w=td["tile_w"],
                                overlap=td["overlap"], tile_bs=td["tile_bs"],
                                uniform_batches=td.get("uniform_batches", False),
                                tile_scan=scan)
    jp = jax_plan(td["method"], h, w, tile_h=td["tile_h"], tile_w=td["tile_w"],
                  overlap=td["overlap"], tile_bs=td["tile_bs"],
                  uniform_batches=td.get("uniform_batches", False), tile_scan=scan)
    assert plan.scan_tiles == jp.scan_tiles == scan
    if scan:
        jp = jax_plan(td["method"], h, w, tile_h=td["tile_h"], tile_w=td["tile_w"],
                      overlap=td["overlap"], tile_bs=td["tile_bs"], tile_scan=False)
    args = (7.0, branch, 1, (h, w), icfg)
    if case == "odd":
        for fn, p, cc in ((port._deepcache_aux, plan, c), (jpipe._deepcache_aux, jp, to_jax(c))):
            with pytest.raises(ValueError, match="divisible by 2"):
                fn(p, cc, u, *args)
        return
    for p, jp_ in ((plan, jp), (None, None)):
        got = port._deepcache_aux(p, c, u, *args)
        want = jpipe._deepcache_aux(jp_, to_jax(c), None if u is None else to_jax(u), *args)
        want = [want] if jp_ is None else list(want)
        assert _aux_shapes(got) == _aux_shapes(want)
        assert all(g.dtype == torch.float32 and not g.any() for g in got)


# ------------------------------------------------------------------ the samplers


def _jax_draws(name, seed, shape, steps):
    """The draws the JAX package's ``name`` makes from ``fold_in(PRNGKey(seed),
    7)``: Euler a splits the key every step; DPM++ 2M SDE folds in the step
    on every step but the last."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
    out = []
    for i in range(steps):
        if name == "Euler a":
            key, sub = jax.random.split(key)
        elif i == steps - 1:
            break
        else:
            sub = jax.random.fold_in(key, i)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return out


class Replay:
    def __init__(self, draws):
        self.draws = list(draws)

    def __call__(self, like):
        d = self.draws.pop(0)
        assert d.shape == tuple(like.shape)
        return torch.from_numpy(d)


@pytest.mark.parametrize("name", ["Euler", "Heun", "DPM++ 2M", "LMS", "PLMS", "Euler a",
                                  "DPM++ 2M SDE"])
def test_txt2img_deepcache_matches_jax(pipes, name):
    """Untiled 16 x 16 latent, 5 steps at CFG 7, deepcache=2; Heun's and
    PLMS's second calls in a step read or rewrite as JAX's ``lax.cond`` does.
    The stochastic samplers replay the JAX package's draws. The cached run
    differs from the exact one."""
    jpipe, port = pipes
    c, u = jax_cond(0), jax_cond(1)
    steps, seed = 5, 4
    want = jpipe.txt2img(to_jax(c), to_jax(u), 128, 128,
                         jcfg.SamplerConfig(name=name, steps=steps, deepcache=2), seed=seed,
                         decode=False).latents
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (1, 4, 16, 16)))
    draws = _jax_draws(name, seed, (1, 4, 16, 16), steps)
    replay = Replay(draws)
    got = port._txt2img_from_noise(noise, c, u, SamplerConfig(name=name, steps=steps,
                                                               deepcache=2), seed,
                                   decode=False, sampler_noise=replay).latents
    _close(got, want)
    if name in samplers.STOCHASTIC_SAMPLERS:
        assert replay.draws == []
    exact = port._txt2img_from_noise(noise, c, u, SamplerConfig(name=name, steps=steps), seed,
                                     decode=False, sampler_noise=Replay(draws)).latents
    assert (exact - got).abs().max() > 1e-4


@pytest.mark.parametrize("name", sorted(samplers.STATIC_SIGMA_SAMPLERS))
def test_static_sigma_samplers_refuse_deepcache(pipes, name):
    _, port = pipes
    with pytest.raises(ValueError, match="DeepCache"):
        port.txt2img(jax_cond(0), jax_cond(1), 128, 128,
                     SamplerConfig(name=name, steps=4, deepcache=2), decode=False)
    x, sig = torch.zeros(1, 4, 4, 4), torch.tensor([2.0, 1.0, 0.5, 0.0])
    args = (Replay([]),) if name in samplers.STOCHASTIC_SAMPLERS else ()
    with pytest.raises(ValueError, match="DeepCache"):
        samplers.get_sampler(name)(mark_deepcache(lambda x, s, i: x), x, sig, *args)


# -------------------------------------------------------- the grid and img2img


def test_tiled_regional_deepcache_matches_jax(pipes):
    """A 16 x 40 latent in 4 tiles (batches of 2), a BACKGROUND region with
    its own (cond, uncond), Euler 4 steps under deepcache=2: the grid caches
    a batch each, the region runs full."""
    jpipe, port = pipes
    c, u, rc, ru = (jax_cond(k) for k in range(4))
    region = RegionSpec(0.0, 0.0, 0.5, 1.0, seed=7)
    jregion = jbbox.RegionSpec(**{**dataclasses.asdict(region),
                                  "blend_mode": jbbox.BlendMode.BACKGROUND})
    sp = dict(name="Euler", steps=4, deepcache=2)
    want = jpipe.txt2img(to_jax(c), to_jax(u), 320, 128, jcfg.SamplerConfig(**sp), seed=9,
                         tiled_diffusion=jcfg.TiledDiffusionConfig(**TD, regions=(jregion,)),
                         region_conds=[(to_jax(rc), to_jax(ru))], decode=False).latents
    base = jax.random.normal(jax.random.PRNGKey(9), (1, 4, 16, 40))
    noise = np.asarray(jregions.compose_region_noise(base, [jregion.to_bbox(40, 16)], [7]))
    got = port._txt2img_from_noise(noise, c, u, SamplerConfig(**sp), 9,
                                   TiledDiffusionConfig(**TD, regions=[region]),
                                   region_conds=[(rc, ru)], region_seeds=[7],
                                   decode=False).latents
    _close(got, want)


def test_masked_img2img_deepcache_matches_jax(pipes):
    """img2img from a given latent with a mask on the tiled canvas, Euler 6
    steps at denoise 0.7 under deepcache=2: the inpaint blend wraps the
    cached denoiser."""
    jpipe, port = pipes
    c, u = jax_cond(0), jax_cond(1)
    init = np.random.default_rng(3).normal(size=(1, 4, 16, 40)).astype(np.float32)
    mask = np.linspace(0.0, 1.0, 128 * 320, dtype=np.float32).reshape(128, 320)
    sp = dict(name="Euler", steps=6, denoising_strength=0.7, deepcache=2)
    want = jpipe.img2img(None, to_jax(c), to_jax(u), jcfg.SamplerConfig(**sp), seed=5,
                         tiled_diffusion=jcfg.TiledDiffusionConfig(**TD), mask=mask,
                         init_latents=jnp.asarray(init), decode=False).latents
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (1, 4, 16, 40)))
    got = port._img2img_from_noise(None, None, noise, c, u, SamplerConfig(**sp), 5,
                                   TiledDiffusionConfig(**TD), mask=mask, init_latents=init,
                                   decode=False).latents
    _close(got, want)


def test_deepcache_grid_takes_no_fused_blend(pipes, monkeypatch):
    """Under MDU_FUSED_BLEND=1 the exact grid sums through #5's wrapper and
    the DeepCache grid never calls it (JAX's ``and not stateful``); both give
    the scatter-add's sum."""
    _, port = pipes
    calls = []
    fused = schedulers.fused_tile_blend

    def spy(*a, **kw):
        calls.append(1)
        return fused(*a, **kw)

    monkeypatch.setattr(schedulers, "fused_tile_blend", spy)
    monkeypatch.setenv("MDU_FUSED_BLEND", "1")
    noise = torch.randn(1, 4, 16, 40, generator=torch.Generator().manual_seed(1))
    c, u = jax_cond(0), jax_cond(1)

    def run(n):
        return port._txt2img_from_noise(noise, c, u, SamplerConfig(steps=3, deepcache=n), 0,
                                        TiledDiffusionConfig(**TD), decode=False).latents

    run(1)
    assert len(calls) == 3
    calls.clear()
    cached = run(2)
    assert calls == []
    monkeypatch.setenv("MDU_FUSED_BLEND", "0")
    torch.testing.assert_close(run(2), cached, rtol=0, atol=0)


# ------------------------------------------------------------------ DemoFusion


DF = dict(window_size=16, overlap=8, tile_bs=4, tile_bs_g=2, scale_factor=2)


def _demofusion(jpipe, port, c, u, sp, seed=5, **df):
    """x2 from a 16 x 16 latent on both sides, JAX's base and phase noise fed
    to the port: (port phase latents, JAX final latent)."""
    df = dict(DF, **df)
    want = jpipe.demofusion(to_jax(c), to_jax(u), 128, 128, jcfg.DemoFusionConfig(**df),
                            jcfg.SamplerConfig(**sp), seed=seed, decode=False).latents
    base = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (1, 4, 16, 16)))
    phase = np.asarray(jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(seed), 102),
                                         (1, 4, 32, 32)))
    got = port._demofusion_from_noise(torch.from_numpy(base), [torch.from_numpy(phase)], c, u,
                                      128, 128, DemoFusionConfig(**df), SamplerConfig(**sp),
                                      seed=seed, decode=False)
    return got, want


def test_demofusion_deepcache_and_cond_matches_jax(pipes, capsys):
    """DeepCache on the global views (two batches of two views, mixture on),
    an AND cond of two branches (caches P + 1 = 3 wide), Euler 6 steps at
    denoise 0.7; the base phase runs DeepCache untiled."""
    jpipe, port = pipes
    c = {"__and__": [jax_cond(0), jax_cond(2)], "__weights__": (1.0, 0.6)}
    sp = dict(name="Euler", steps=6, denoising_strength=0.7, deepcache=2)
    got, want = _demofusion(jpipe, port, c, jax_cond(1), sp, mixture=True)
    _close(got.latents, want)
    assert "global dilated views only" in capsys.readouterr().err
    plan = pdf.plan_demofusion_phase(32, 32, 2, DemoFusionConfig(**DF, mixture=True))
    jplan = jdf.plan_demofusion_phase(32, 32, 2, jcfg.DemoFusionConfig(**DF, mixture=True))
    caches = pdf.demofusion_deepcache_aux(port, plan, DemoFusionConfig(**DF, mixture=True),
                                          False, 7.0, 2, 1, 1)
    jcaches = jdf.demofusion_deepcache_aux(jpipe, jplan, jcfg.DemoFusionConfig(**DF), False,
                                           7.0, 2, 1, 1)
    assert _aux_shapes(caches) == _aux_shapes(jcaches) == [(6, 16, 16, 16)] * 4


def test_demofusion_scheduled_cond_matches_jax(pipes):
    """A scheduled cond (a bank of two prompts, switching at step 1) and a
    plain uncond, Euler 4 steps at denoise 0.8; a callable giving the same
    cond every step gives the same result."""
    jpipe, port = pipes
    bank = {"crossattn": np.concatenate([jax_cond(5)["crossattn"], jax_cond(6)["crossattn"]])}
    c = {"__bank__": bank, "__index__": [0, 1, 1, 1]}
    sp = dict(name="Euler", steps=4, denoising_strength=0.8)
    got, want = _demofusion(jpipe, port, c, jax_cond(1), sp)
    _close(got.latents, want)
    step_cond = DiffusionPipeline._as_cond_fn(c)
    base = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (1, 4, 16, 16)))
    phase = np.asarray(jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(5), 102),
                                         (1, 4, 32, 32)))
    called = port._demofusion_from_noise(torch.from_numpy(base), [torch.from_numpy(phase)],
                                         step_cond, jax_cond(1), 128, 128,
                                         DemoFusionConfig(**DF), SamplerConfig(**sp), seed=5,
                                         decode=False)
    torch.testing.assert_close(called.latents, got.latents, rtol=0, atol=0)


# ------------------------------------------------------------------ the scan grid


@pytest.mark.parametrize("tile_scan,uniform,thresh,w", [
    (None, False, None, 40), (None, False, "2", 40), (None, False, None, 160),
    (True, False, None, 40), (True, True, None, 40), (True, False, None, 16),
    (False, False, "1", 160), (None, True, "1", 160)])
def test_scan_tiles_decision_matches_jax(monkeypatch, tile_scan, uniform, thresh, w):
    """``scan_tiles`` by ``_resolve_tile_scan``'s rule: never under uniform
    batches, ``tile_scan`` with more than one batch, else the batch count
    against ``MDU_TILE_SCAN_THRESHOLD`` (8 by default)."""
    if thresh is None:
        monkeypatch.delenv("MDU_TILE_SCAN_THRESHOLD", raising=False)
    else:
        monkeypatch.setenv("MDU_TILE_SCAN_THRESHOLD", thresh)
    kw = dict(tile_h=16, tile_w=16, overlap=8, tile_bs=2, uniform_batches=uniform,
              tile_scan=tile_scan)
    plan, jp = plan_tiled_diffusion(Method.MULTI_DIFF, 16, w, **kw), jax_plan(
        Method.MULTI_DIFF, 16, w, **kw)
    assert plan.scan_tiles == jp.scan_tiles
    assert plan.num_batches == len(jp.batched)


@pytest.mark.parametrize("case", ["md", "mod", "deepcache"])
def test_scan_grid_matches_jax(pipes, case):
    """``tile_scan=True`` on a 16 x 40 latent (4 tiles, ``tile_bs`` 3): the
    JAX package's ``lax.scan`` grid runs chunks of 3, the second padded with
    the last tile twice at weight 0; the port runs the plan's batches of 2
    and 2 unrolled, within 1e-5 x max of it, and to the bit what it runs
    with ``tile_scan=False``; Mixture of Diffusers and DeepCache N = 2 (the
    scan's one cache a chunk, the port's one a batch) too."""
    jpipe, port = pipes
    c, u = jax_cond(0), jax_cond(1)
    td = dict(TD, tile_bs=3, method=Method.MIX_DIFF if case == "mod" else Method.MULTI_DIFF)
    sp = dict(name="Euler", steps=4, deepcache=2 if case == "deepcache" else 1)
    seed = 6
    want = jpipe.txt2img(to_jax(c), to_jax(u), 320, 128, jcfg.SamplerConfig(**sp), seed=seed,
                         tiled_diffusion=jcfg.TiledDiffusionConfig(**td, tile_scan=True),
                         decode=False).latents
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (1, 4, 16, 40)))
    ptd = TiledDiffusionConfig(**td, tile_scan=True)
    assert port._plan(ptd, 16, 40).scan_tiles
    got = port._txt2img_from_noise(noise, c, u, SamplerConfig(**sp), seed, ptd,
                                   decode=False).latents
    _close(got, want, rel=1e-5)
    unrolled = port._txt2img_from_noise(noise, c, u, SamplerConfig(**sp), seed,
                                        dataclasses.replace(ptd, tile_scan=False),
                                        decode=False).latents
    torch.testing.assert_close(unrolled, got, rtol=0, atol=0)
