"""Port parity for the adapters: StableSR's guidance encoder (its residuals,
the tiled pipeline, tiled against untiled, a region's own cut, its
checkpoint), edit-model image CFG (two-way at 1, tiled, under DeepCache,
the automatic image latent through img2img with an ESRGAN pre-upscale, its
errors), unCLIP's ``adm`` (the UNet's label embedding, the tiled pipeline,
the missing leaf, the config) and ESRGAN (the tiny RRDBNet, new-arch and
old-arch checkpoints, the registry), against ``mdu_tpu``.

The pipelines run the stand-in UNet of ``test_torch_deepcache.py`` with the
real guidance encoder, VAE and RRDBNet. Tolerance: atol 1e-5 x max|ref| for
modules, 1e-4 x max|ref| for pipelines (fp32 on both sides, JAX at
'highest')."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import mdu_tpu.config as jcfg
from mdu_tpu import upscale as jupscale
from mdu_tpu.models import StableSRGuidance as JaxStableSR
from mdu_tpu.models import UNet2DCondition as JaxUNet
from mdu_tpu.models import random_params
from mdu_tpu.models import tiny_unet_config as jax_tiny_unet
from mdu_tpu.models import esrgan as jesrgan
from mdu_tpu.models import loader as jloader
from mdu_tpu.models.unet import sd21_unclip_unet_config as jax_unclip_config
from mdu_tpu_torch import SamplerConfig, TiledDiffusionConfig, get_upscaler, upscale
from mdu_tpu_torch.models import (RRDBNet, StableSRGuidance, UNet2DCondition, load_esrgan,
                                  load_jax_params, register_esrgan_upscaler,
                                  sd21_unclip_unet_config, tiny_rrdb_config, tiny_unet_config)
from mdu_tpu_torch.models import esrgan
from mdu_tpu_torch.models.loader import load_guidance
from mdu_tpu_torch.models.safetensors import save_file
from mdu_tpu_torch.tiling.schedulers import plan_tiled_diffusion
from mdu_tpu_torch.utils.bbox import BlendMode, RegionSpec
from test_torch_deepcache import TD, _close, _np, jax_cond, standin_pipes, to_jax

torch.set_num_threads(2)


def _flat(params):
    return traverse_util.flatten_dict(params["params"], sep="/")


def _fill_gates(params, seed, scale=0.05):
    """Every zero-initialised gate (``zero*``) drawn from a normal of std
    ``scale``, so that the residuals are not zero."""
    rng = np.random.default_rng(seed)
    flat = {k: (jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * scale)
                if k.startswith("zero") else v) for k, v in _flat(params).items()}
    return {"params": traverse_util.unflatten_dict(flat, sep="/")}


# --------------------------------------------------------------------- StableSR


@pytest.fixture(scope="module")
def stablesr():
    """The tiny guidance encoder with its gates filled, and the stand-in
    pipelines that carry it: (JAX module, JAX params, port module, JAX
    pipeline, port pipeline)."""
    gm = JaxStableSR(jax_tiny_unet())
    gp = _fill_gates(random_params(gm, 2, jnp.zeros((1, 4, 16, 16)), jnp.zeros((1,))), 12)
    port_gm = load_jax_params(StableSRGuidance(tiny_unet_config()), _np(gp))
    jpipe, port = standin_pipes(guidance_model=port_gm,
                                jax_kw=dict(guidance_model=gm, guidance_params=gp))
    return gm, gp, port_gm, jpipe, port


def _guidance(seed, h=16, w=40):
    return (np.random.default_rng(seed).normal(size=(1, 4, h, w)) * 0.3).astype(np.float32)


def test_stablesr_residuals_match_jax(stablesr, rng):
    """A residual per skip (conv_in, 2 a level, a downsample between) and the
    mid one, each at its skip's shape."""
    gm, gp, port_gm, _, _ = stablesr
    g = rng.normal(size=(2, 4, 16, 16)).astype(np.float32)
    t = np.array([3.0, 700.0], np.float32)
    jdown, jmid = gm.apply(gp, jnp.asarray(g), jnp.asarray(t))
    with torch.no_grad():
        down, mid = port_gm(torch.from_numpy(g), torch.from_numpy(t))
    cfg = port_gm.cfg
    assert len(down) == len(jdown) == 1 + len(cfg.block_out_channels) * cfg.layers_per_block \
        + len(cfg.block_out_channels) - 1
    for got, want in zip(down, jdown):
        _close(got, want, 1e-5)
    _close(mid, jmid, 1e-5)
    assert mid.shape[1] == cfg.block_out_channels[-1] and float(mid.abs().max()) > 0


def test_stablesr_tiled_pipeline_matches_jax(stablesr):
    """A 16 x 40 latent in 4 tiles, the guidance latent on cond and uncond
    cut per tile, Euler 3 steps at CFG 7; another guidance latent moves the
    result."""
    _, _, _, jpipe, port = stablesr
    g = _guidance(1)
    c, u = {**jax_cond(0), "guidance": g}, {**jax_cond(1), "guidance": g}
    sp = dict(name="Euler", steps=3)
    want = jpipe.txt2img(to_jax(c), to_jax(u), 320, 128, jcfg.SamplerConfig(**sp), seed=2,
                         tiled_diffusion=jcfg.TiledDiffusionConfig(**TD), decode=False).latents
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (1, 4, 16, 40)))

    def run(cc, uu):
        return port._txt2img_from_noise(noise, cc, uu, SamplerConfig(**sp), 2,
                                        TiledDiffusionConfig(**TD), decode=False).latents

    got = run(c, u)
    _close(got, want)
    g2 = _guidance(2)
    assert (run({**c, "guidance": g2}, {**u, "guidance": g2}) - got).abs().max() > 1e-4


def test_stablesr_tiled_equals_untiled(stablesr):
    """One tile over the whole canvas: the tile's guidance cut is the whole
    latent, so the tiled run is the untiled one."""
    _, _, _, _, port = stablesr
    g = _guidance(3, 16, 16)
    c, u = {**jax_cond(0), "guidance": g}, {**jax_cond(1), "guidance": g}
    noise = torch.randn(1, 4, 16, 16, generator=torch.Generator().manual_seed(3))
    plan = plan_tiled_diffusion(TD["method"], 16, 16, tile_h=16, tile_w=16, overlap=8)
    assert len(plan.bboxes) == 1
    runs = [port._txt2img_from_noise(noise, c, u, SamplerConfig(steps=2), 0, plan=p,
                                     tiled_diffusion=TiledDiffusionConfig(**TD),
                                     decode=False).latents for p in (plan, None)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)


def test_stablesr_region_gets_its_own_cut(stablesr, monkeypatch):
    """A FOREGROUND region's calls see the guidance latent cut to its bbox
    (ref switch_stablesr_tensors per custom bbox, abstractdiffusion.py:577-588)."""
    _, _, port_gm, _, port = stablesr
    g = _guidance(4, 16, 32)
    seen = []
    forward = port_gm.forward

    def spy(guidance, t):
        seen.append(guidance.clone())
        return forward(guidance, t)

    monkeypatch.setattr(port_gm, "forward", spy)
    region = RegionSpec(0.5, 0.0, 0.25, 0.5, blend_mode=BlendMode.FOREGROUND,
                        feather_ratio=0.3, seed=7)
    td = TiledDiffusionConfig(**TD, regions=[region])
    res = port._txt2img_from_noise(torch.zeros(1, 4, 16, 32), {**jax_cond(0), "guidance": g},
                                   {**jax_cond(1), "guidance": g}, SamplerConfig(steps=1), 0,
                                   td, region_conds=[({**jax_cond(2), "guidance": g}, None)],
                                   decode=False)
    assert torch.isfinite(res.latents).all()
    b = region.to_bbox(32, 16)
    cut = torch.from_numpy(g[:, :, b.y:b.y + b.h, b.x:b.x + b.w])
    assert any(s.shape == cut.shape and torch.equal(s, cut) for s in seen)


def test_load_guidance_round_trip_matches_jax(stablesr, tmp_path):
    """A file keyed by the JAX package's flat paths: the port's loader gives
    every tensor back, as the JAX package's loader does."""
    _, gp, port_gm, _, _ = stablesr
    path = str(tmp_path / "guidance.safetensors")
    save_file({k.replace(".", "/"): v for k, v in port_gm.state_dict().items()}, path)
    got = load_guidance(path, tiny_unet_config(), guidance_scale=0.5, device="cpu")
    assert got.guidance_scale == 0.5
    for k, v in port_gm.state_dict().items():
        torch.testing.assert_close(got.state_dict()[k], v, rtol=0, atol=0)
    _, jparams = jloader.load_guidance(path, jax_tiny_unet())
    for k, v in _flat(jparams).items():
        np.testing.assert_array_equal(got.state_dict()[k.replace("/", ".")].numpy(),
                                      np.asarray(v))


def test_guidance_leaf_on_one_side_raises(stablesr):
    _, _, _, _, port = stablesr
    c = {**jax_cond(0), "guidance": _guidance(5, 16, 16)}
    with pytest.raises(ValueError, match="guidance"):
        port.txt2img(c, jax_cond(1), 128, 128, SamplerConfig(steps=1), decode=False)


# -------------------------------------------------------------------- image CFG


@pytest.fixture(scope="module")
def edit_pipes():
    """The stand-in of an instruct-pix2pix UNet: 8 input channels."""
    return standin_pipes(dataclasses.replace(jax_tiny_unet(), in_channels=8),
                         dataclasses.replace(tiny_unet_config(), in_channels=8))


def _edit_conds(h, w):
    ilat = _guidance(9, h, w)
    return {**jax_cond(0), "concat": ilat}, {**jax_cond(1), "concat": ilat}


def test_image_cfg_one_equals_two_way(edit_pipes):
    """du + 1 (di - du) + cfg (dc - di) is two-way CFG over the uncond that
    carries the image latent."""
    _, port = edit_pipes
    c, u = _edit_conds(16, 16)
    noise = torch.randn(1, 4, 16, 16, generator=torch.Generator().manual_seed(7))
    a, b = (port._txt2img_from_noise(noise, c, u, SamplerConfig(steps=3, image_cfg_scale=s), 7,
                                     decode=False).latents for s in (None, 1.0))
    _close(b, a.numpy(), 1e-5)
    c15 = port._txt2img_from_noise(noise, c, u, SamplerConfig(steps=3, image_cfg_scale=1.5), 7,
                                   decode=False).latents
    assert (c15 - a).abs().max() > 1e-4


@pytest.mark.parametrize("deepcache", [1, 2])
def test_image_cfg_tiled_matches_jax(edit_pipes, deepcache):
    """The canvas-shaped image latent cut per tile, image CFG 1.5 at CFG 7,
    Euler 4 steps; under DeepCache the caches are three batches wide."""
    jpipe, port = edit_pipes
    c, u = _edit_conds(16, 40)
    sp = dict(name="Euler", steps=4, image_cfg_scale=1.5, deepcache=deepcache)
    want = jpipe.txt2img(to_jax(c), to_jax(u), 320, 128, jcfg.SamplerConfig(**sp), seed=3,
                         tiled_diffusion=jcfg.TiledDiffusionConfig(**TD), decode=False).latents
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (1, 4, 16, 40)))
    got = port._txt2img_from_noise(noise, c, u, SamplerConfig(**sp), 3,
                                   TiledDiffusionConfig(**TD), decode=False).latents
    _close(got, want)


def _esrgan_state(cfg, seed, names, scale=0.02):
    """Random ESRGAN weights under the checkpoint keys ``names(param path)``."""
    rng = np.random.default_rng(seed)
    model = RRDBNet(cfg)
    return {names(k.replace(".", "/")): torch.from_numpy(
        (rng.normal(size=tuple(v.shape)) * scale).astype(np.float32))
        for k, v in model.state_dict().items()}


@pytest.fixture
def tiny_gan(tmp_path):
    """A tiny new-arch ESRGAN file registered as "TinyGAN" on both sides,
    taken out of both registries afterwards."""
    path = str(tmp_path / "gan.safetensors")
    save_file(_esrgan_state(tiny_rrdb_config(), 1, esrgan.translate_esrgan_name), path)
    register_esrgan_upscaler("TinyGAN", path, device="cpu")
    jesrgan.register_esrgan_upscaler("TinyGAN", path)
    yield path
    upscale._REGISTRY.pop("TinyGAN", None)
    jupscale._REGISTRY.pop("TinyGAN", None)


def test_image_cfg_img2img_esrgan_matches_jax(edit_pipes, tiny_gan):
    """img2img of a 64 x 64 image through the registered ESRGAN x2 (the x4
    model, then Lanczos down), the image latent's mode attached as ``concat``
    on cond and uncond by the pipeline, image CFG 1.5, tiled, Euler 5 steps
    at denoise 0.6; JAX's encoder and sampling draws fed to the port."""
    jpipe, port = edit_pipes
    img = (np.random.default_rng(4).random((64, 64, 3)) * 255).astype(np.uint8)
    c, u = jax_cond(0), jax_cond(1)
    sp = dict(name="Euler", steps=5, denoising_strength=0.6, image_cfg_scale=1.5)
    td = dict(TD, upscaler="TinyGAN", scale_factor=2.0)
    want = jpipe.img2img(img, to_jax(c), to_jax(u), jcfg.SamplerConfig(**sp), seed=6,
                         tiled_diffusion=jcfg.TiledDiffusionConfig(**td), decode=False)
    key = jax.random.PRNGKey(6)
    enc = np.asarray(jax.random.normal(jax.random.fold_in(key, 3), (1, 4, 16, 16)))
    noise = np.asarray(jax.random.normal(key, (1, 4, 16, 16)))
    got = port._img2img_from_noise(img, enc, noise, c, u, SamplerConfig(**sp), 6,
                                   TiledDiffusionConfig(**td), decode=False)
    _close(got.latents, want.latents)
    assert got.info == want.info
    x = np.random.default_rng(5).uniform(-1, 1, size=(1, 3, 12, 10)).astype(np.float32)
    _close(get_upscaler("TinyGAN")(torch.from_numpy(x), 2.0),
           jupscale.get_upscaler("TinyGAN")(jnp.asarray(x), 2.0), 1e-5)


def test_image_cfg_errors(edit_pipes, pipes_4ch):
    """An AND cond, no uncond and an uncond without its image latent raise
    as in the JAX package; so does img2img on a UNet without the image
    channels."""
    _, port = edit_pipes
    c, u = _edit_conds(16, 16)
    sp = SamplerConfig(steps=1, image_cfg_scale=1.5)
    kw = dict(width=128, height=128, sampler=sp, decode=False)
    with pytest.raises(ValueError, match="AND"):
        port.txt2img({"__and__": [c, c], "__weights__": (1.0, 1.0)}, u, **kw)
    with pytest.raises(ValueError, match="needs an uncond"):
        port.txt2img(c, None, **kw)
    with pytest.raises(ValueError, match="image_cfg_scale requires"):
        port.txt2img(c, jax_cond(1), **kw)
    img = np.zeros((64, 64, 3), np.uint8)
    with pytest.raises(ValueError, match="in_channels=4"):
        pipes_4ch.img2img(img, jax_cond(0), jax_cond(1),
                          SamplerConfig(steps=2, denoising_strength=0.5, image_cfg_scale=1.5))


@pytest.fixture(scope="module")
def pipes_4ch():
    return standin_pipes()[1]


# ----------------------------------------------------------------------- unCLIP


def test_unclip_unet_matches_jax(rng):
    """The tiny UNet with an 8-wide ``adm`` through the label embedding into
    the time embedding; without ``adm`` it raises."""
    jc = dataclasses.replace(jax_tiny_unet(), adm_in_channels=8)
    x = rng.normal(size=(2, 4, 16, 16)).astype(np.float32)
    t = np.array([11.0, 400.0], np.float32)
    ctx = rng.normal(size=(2, 7, 16)).astype(np.float32)
    adm = rng.normal(size=(2, 8)).astype(np.float32)
    junet = JaxUNet(jc)
    params = random_params(junet, 4, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                           {"adm": jnp.asarray(adm)})
    want = jax.jit(junet.apply)(params, x, t, ctx, {"adm": jnp.asarray(adm)})
    unet = load_jax_params(UNet2DCondition(dataclasses.replace(tiny_unet_config(),
                                                               adm_in_channels=8)),
                           _np(params))
    assert tuple(unet.label_embed_1.weight.shape) == (32, 8)
    tx, tt, tc = torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx)
    with torch.no_grad():
        _close(unet(tx, tt, tc, {"adm": torch.from_numpy(adm)}), want, 1e-5)
        with pytest.raises(ValueError, match="adm"):
            unet(tx, tt, tc)


@pytest.fixture(scope="module")
def unclip_pipes():
    return standin_pipes(dataclasses.replace(jax_tiny_unet(), adm_in_channels=8),
                         dataclasses.replace(tiny_unet_config(), adm_in_channels=8))


def _unclip_conds(seed):
    adm = (np.random.default_rng(seed).normal(size=(1, 8)) * 0.5).astype(np.float32)
    return {**jax_cond(0), "adm": adm}, {**jax_cond(1), "adm": adm}


def test_unclip_tiled_matches_jax(unclip_pipes):
    """``adm`` repeated per tile like a vector leaf, Euler 3 steps over 4
    tiles; another embedding moves the result."""
    jpipe, port = unclip_pipes
    c, u = _unclip_conds(5)
    sp = dict(name="Euler", steps=3)
    want = jpipe.txt2img(to_jax(c), to_jax(u), 320, 128, jcfg.SamplerConfig(**sp), seed=4,
                         tiled_diffusion=jcfg.TiledDiffusionConfig(**TD), decode=False).latents
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (1, 4, 16, 40)))

    def run(cc, uu):
        return port._txt2img_from_noise(noise, cc, uu, SamplerConfig(**sp), 4,
                                        TiledDiffusionConfig(**TD), decode=False).latents

    got = run(c, u)
    _close(got, want)
    assert (run(*_unclip_conds(6)) - got).abs().max() > 1e-4


def test_unclip_missing_adm_raises(unclip_pipes):
    _, port = unclip_pipes
    with pytest.raises(ValueError, match="adm"):
        port.txt2img(jax_cond(0), None, 128, 128, SamplerConfig(steps=1), decode=False)


def test_unclip_config_factory_matches_jax():
    for variant, width in (("l", 1536), ("h", 2048)):
        got = sd21_unclip_unet_config(variant)
        assert dataclasses.asdict(got) == dataclasses.asdict(jax_unclip_config(variant))
        assert (got.adm_in_channels, got.cross_attention_dim, got.head_dim) == (width, 1024, 64)


# ----------------------------------------------------------------------- ESRGAN


def test_rrdbnet_matches_jax(rng):
    cfg = tiny_rrdb_config()
    x = rng.uniform(size=(1, 3, 16, 12)).astype(np.float32)
    jm = jesrgan.RRDBNet(jesrgan.tiny_rrdb_config())
    params = random_params(jm, 0, jnp.asarray(x))
    want = jm.apply(params, jnp.asarray(x))
    model = load_jax_params(RRDBNet(cfg), _np(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (1, 3, 64, 48)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("arch", ["new", "old"])
def test_load_esrgan_matches_jax(tmp_path, arch):
    """New-arch and old-arch keys, the widths and depth read from the file
    (3 blocks, 6 features, grow 4); the JAX package's loader gives the same
    weights."""
    cfg = esrgan.RRDBNetConfig(num_feat=6, num_blocks=3, grow=4)
    names = (esrgan.translate_esrgan_name if arch == "new"
             else lambda n: esrgan._old_arch_name(n, cfg.num_blocks))
    state = _esrgan_state(cfg, 2, names)
    path = str(tmp_path / f"{arch}.safetensors")
    save_file(state, path)
    model = load_esrgan(path, device="cpu")
    assert model.cfg == cfg
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, state[names(k.replace(".", "/"))], rtol=0, atol=0)
    _, jparams = jesrgan.load_esrgan(path)
    for k, v in _flat(jparams).items():
        np.testing.assert_array_equal(model.state_dict()[k.replace("/", ".")].numpy(),
                                      np.asarray(v))
    del state[names("conv_hr/bias")]
    save_file(state, path)
    with pytest.raises(KeyError, match="missing 1 params"):
        load_esrgan(path, device="cpu")
