"""Port parity for the img2img upscaling slice: resize, the upscalers, the
renoise mask, the Mixture of Diffusers weights, plan and combinator (unrolled
and under ``MDU_FUSED_BLEND``), the GroupNorm dispatch with captured and
injected statistics, the truncated schedule, tiled noise inversion, and the
whole tiny img2img against ``mdu_tpu``, fed the same noise; then the decode's
NaN chain, the noise-inversion cache and the CPU entry point.
Tolerance: atol 1e-4 * max|ref| (fp32 on both sides, JAX at 'highest')."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdu_tpu.config as jcfg
from mdu_tpu import upscale as jupscale
from mdu_tpu.models import AutoencoderKL as JaxVAE
from mdu_tpu.models import UNet2DCondition as JaxUNet
from mdu_tpu.models import random_params
from mdu_tpu.models import tiny_vae_config as jax_tiny_vae
from mdu_tpu.models.layers import GroupNorm as JaxGroupNorm
from mdu_tpu.models.unet import UNetConfig as JaxUNetConfig
from mdu_tpu.ops import resize as jresize
from mdu_tpu.ops.tile_context import TileContext as JaxTileContext
from mdu_tpu.pipeline import DiffusionPipeline as JaxPipeline
from mdu_tpu.samplers.schedule import NoiseSchedule as JaxSchedule
from mdu_tpu.tiling.schedulers import make_tiled_denoiser as jax_make_tiled_denoiser
from mdu_tpu.tiling.schedulers import plan_tiled_diffusion as jax_plan
from mdu_tpu.utils import guided_filter as jgf
from mdu_tpu.utils import image as jimage
from mdu_tpu.utils import weights as jweights
from mdu_tpu_torch import (DiffusionPipeline, Method, SamplerConfig, TiledDiffusionConfig,
                           TiledVAEConfig, get_upscaler, list_upscalers)
from mdu_tpu_torch.models import AutoencoderKL, UNet2DCondition, load_jax_params, tiny_vae_config
from mdu_tpu_torch.models.unet import UNetConfig
from mdu_tpu_torch.models import layers
from mdu_tpu_torch.ops import resize
from mdu_tpu_torch.ops.groupnorm import GroupNormStats
from mdu_tpu_torch.ops.tile_context import TileContext
from mdu_tpu_torch.samplers.schedule import NoiseSchedule
from mdu_tpu_torch.tiling.schedulers import make_tiled_denoiser, plan_tiled_diffusion
from mdu_tpu_torch.utils import guided_filter, image, weights

torch.set_num_threads(2)
# a two-level UNet (the tiny config's first level and its mid-block): JAX
# compiles the pipelines in about half the four-level one's time
TWO_LEVELS = dict(block_out_channels=(8, 16), cross_attention_dim=16, num_heads=2,
                  transformer_layers=(1, 0), norm_num_groups=4)


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _u8(seed, h, w):
    return (np.random.default_rng(seed).random((h, w, 3)) * 255).astype(np.uint8)


# ------------------------------------------------------- resize, upscalers


@pytest.mark.parametrize("method", ["nearest", "linear", "cubic", "lanczos"])
def test_resize_matches_jax(rng, method):
    """Up by 4 (config 3's Lanczos pre-upscale), down, and ragged sizes."""
    x = rng.normal(size=(1, 3, 24, 17)).astype(np.float32)
    for size in ((96, 68), (9, 40), (24, 17)):
        np.testing.assert_array_equal(resize.resize_matrix(24, size[0], method),
                                      jresize._resize_matrix(24, size[0], method))
        _close(resize.resize_nchw(torch.from_numpy(x), size, method),
               jresize.resize_nchw(jnp.asarray(x), size, method), rel=1e-6)


def test_upscaler_registry_matches_jax(rng):
    assert list_upscalers() == jupscale.list_upscalers()
    x = rng.uniform(-1, 1, size=(1, 3, 16, 12)).astype(np.float32)
    for name in list_upscalers():
        for scale in (2.0, 4.0, 1.5):
            _close(get_upscaler(name)(torch.from_numpy(x), scale),
                   jupscale.get_upscaler(name)(jnp.asarray(x), scale), rel=1e-6)
    with pytest.raises(KeyError):
        get_upscaler("no such upscaler")
    # an ESRGAN name resolves only once registered (models/esrgan.py)
    with pytest.raises(KeyError):
        get_upscaler("R-ESRGAN 4x+")


def test_retouch_mask_matches_jax():
    """The mask stage alone on one uint8 image: luma, guided filter, and the
    linear resize to the latent canvas. Both sides quantise the same uint8
    image, so they agree to the bit before the resize."""
    img = _u8(3, 80, 72)
    gray = image.grayscale_u8(img)
    np.testing.assert_array_equal(gray, jimage.grayscale_u8(img))
    for k in (64, 16, 1):
        got = guided_filter.get_retouch_mask(gray, k)
        np.testing.assert_array_equal(got, jgf.get_retouch_mask(gray, k))
    got_m = 1.0 - resize.resize_nchw(torch.from_numpy(got)[None, None], (10, 9), "linear")
    want_m = 1.0 - jresize.resize_nchw(jnp.asarray(got)[None, None], (10, 9), "linear")
    _close(got_m, want_m, rel=1e-6)


def test_image_helpers_match_jax():
    img = _u8(4, 12, 10)
    rgba = np.concatenate([img, _u8(5, 12, 10)[..., :1]], axis=-1)
    for arr in (img, rgba, img[..., 0]):
        np.testing.assert_array_equal(image.image_to_tensor(arr).numpy(),
                                      np.asarray(jimage.image_to_tensor(arr)))
    np.testing.assert_array_equal(image.tensor_to_image(image.image_to_tensor(img)),
                                  img[None])
    z = np.random.default_rng(6).normal(size=(1, 4, 5, 6)).astype(np.float32)
    _close(image.cheap_latent_preview(torch.from_numpy(z)),
           jimage.cheap_latent_preview(jnp.asarray(z)), rel=1e-6)


# ------------------------------------------------ Mixture of Diffusers


@pytest.mark.parametrize("tw,th,ratio", [(96, 96, 0.2), (16, 24, 0.5), (7, 5, 0.0)])
def test_weights_match_jax(tw, th, ratio):
    np.testing.assert_array_equal(weights.gaussian_weights(tw, th),
                                  jweights.gaussian_weights(tw, th))
    np.testing.assert_array_equal(weights.feather_mask(tw, th, ratio),
                                  jweights.feather_mask(tw, th, ratio))


@pytest.mark.parametrize("w,h,tile,ov,bs", [(256, 256, 96, 8, 8), (1024, 1024, 96, 8, 8),
                                            (24, 24, 16, 8, 3), (37, 21, 16, 4, 2)])
def test_mod_plan_matches_jax(w, h, tile, ov, bs):
    """Config 3's 256^2 latent (9 tiles in near-equal batches of 5 and 4) and
    the 8K's 1024^2 (144 tiles, 18 batches of 8) first."""
    got = plan_tiled_diffusion(Method.MIX_DIFF, h, w, tile, tile, ov, tile_bs=bs)
    want = jax_plan(jcfg.Method.MIX_DIFF, h, w, tile, tile, ov, tile_bs=bs)
    assert [(b.x, b.y, b.w, b.h) for b in got.bboxes] == \
        [(b.x, b.y, b.w, b.h) for b in want.bboxes]
    assert [len(b) for b in got.batched] == [len(b) for b in want.batched]
    np.testing.assert_array_equal(got.tile_weights, want.tile_weights)
    np.testing.assert_array_equal(got.weights, want.weights)
    if (w, h) == (256, 256):
        assert [len(b) for b in got.batched] == [5, 4]
    if (w, h) == (1024, 1024):
        assert (len(got.bboxes), got.num_batches) == (144, 18)


@pytest.mark.parametrize("fused", [False, True])
def test_mod_combinator_matches_jax(rng, monkeypatch, fused):
    """A toy tile denoiser through the MoD combinator on a 37 x 21 canvas (8
    tiles of 16, batches of 3, 3, 2); under MDU_FUSED_BLEND the port's plain
    version of the fused blend against the JAX package's interpret mode."""
    if fused:
        monkeypatch.setenv("MDU_FUSED_BLEND", "interp")
    x = rng.normal(size=(2, 4, 21, 37)).astype(np.float32)
    plan = plan_tiled_diffusion(Method.MIX_DIFF, 21, 37, 16, 16, 4, tile_bs=3)
    jplan = jax_plan(jcfg.Method.MIX_DIFF, 21, 37, 16, 16, 4, tile_bs=3)

    def toy_j(flat, sigma, step, bboxes, batch_i):
        return jnp.sin(flat) * sigma + 0.1 * batch_i + 0.01 * bboxes[0].x

    def toy_t(flat, sigma, step, bboxes, batch_i):
        return torch.sin(flat) * sigma + 0.1 * batch_i + 0.01 * bboxes[0].x

    want = jax_make_tiled_denoiser(jplan, toy_j)(jnp.asarray(x), jnp.float32(1.5), 0)
    got = make_tiled_denoiser(plan, toy_t)(torch.from_numpy(x), torch.tensor(1.5), 0)
    _close(got, want, rel=1e-6)
    # a constant denoiser comes back unchanged: the weights sum to 1
    ones = make_tiled_denoiser(plan, lambda f, *a: torch.ones_like(f))(
        torch.from_numpy(x), torch.tensor(1.0), 0)
    np.testing.assert_allclose(ones.numpy(), 1.0, atol=1e-5)


# ------------------------------------------------------- GroupNorm stats


def test_group_norm_dispatch_order(rng, monkeypatch):
    """Injected statistics come before the capture mode, which comes before
    the fused kernel, which comes before ``tile_group_norm``: with
    MDU_FUSED_GN=1 a norm with injected or captured statistics never reaches
    the fused kernel, even with a TileContext given. Injected statistics are
    tiled over the batch (row i takes image i % B), as ``jnp.tile`` does."""
    B, C, G, h, w = 2, 8, 4, 6, 5
    x = (rng.normal(size=(B, C, h, w)) * 3 + 1).astype(np.float32)
    tiles = (rng.normal(size=(3 * B, C, h, w)) * 2 - 1).astype(np.float32)
    jmod = JaxGroupNorm(G)
    params = {"params": jax.tree.map(lambda a: a + jnp.arange(C, dtype=jnp.float32) * 0.1,
                                     jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])}
    port = load_jax_params(layers.GroupNorm(C, G), jax.tree.map(np.asarray, params))

    calls = []
    real = layers.fused_group_norm
    monkeypatch.setenv("MDU_FUSED_GN", "1")
    monkeypatch.setattr(layers, "fused_group_norm",
                        lambda *a, **k: calls.append(1) or real(*a, **k))

    # capture: per-sample statistics, recorded
    want, mut = jmod.apply(params, jnp.asarray(x), mutable=["gn_stats"])
    cap = GroupNormStats(capture=True)
    _close(port(torch.from_numpy(x), stats=cap), want)
    mean, var = cap.get(port)
    _close(mean, mut["gn_stats"]["stats"][0], rel=1e-6)
    _close(var, mut["gn_stats"]["stats"][1], rel=1e-6)

    # injection, tiled over 3 x B rows; a TileContext does not override it
    variables = {**params, "gn_stats": mut["gn_stats"]}
    want = jmod.apply(variables, jnp.asarray(tiles))
    inj = cap.injected()
    _close(port(torch.from_numpy(tiles), stats=inj), want)
    ctx = TileContext(3, (h, w))
    want_ctx = jmod.apply(variables, jnp.asarray(tiles), JaxTileContext(3, (h, w)))
    _close(port(torch.from_numpy(tiles), ctx, stats=inj), want_ctx)
    assert not calls
    # a stats object that holds another layer falls through to the kernel
    port(torch.from_numpy(x), stats=GroupNormStats())
    assert calls == [1]
    # with a TileContext and no statistics: pooled, never the kernel
    want_pool = jmod.apply(params, jnp.asarray(tiles), JaxTileContext(3, (h, w)))
    _close(port(torch.from_numpy(tiles), ctx), want_pool)
    assert calls == [1]


# ------------------------------------------------------- schedule


@pytest.mark.parametrize("steps,strength", [(20, 0.4), (20, 0.75), (10, 1.0), (7, 0.05)])
def test_img2img_steps_match_jax(steps, strength):
    got = NoiseSchedule().img2img_steps(steps, strength)
    assert got == JaxSchedule().img2img_steps(steps, strength)
    if (steps, strength) == (20, 0.4):
        sig = NoiseSchedule().sampling_sigmas(20)[20 - got[1] - 1:]
        assert len(sig) == 10 and sig[-1] == 0.0      # config 3: 9 Euler steps


# -------------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def pipes():
    ucfg = JaxUNetConfig(**TWO_LEVELS)
    unet, vae = JaxUNet(ucfg), JaxVAE(jax_tiny_vae())
    up = random_params(unet, 0, jnp.zeros((1, 4, 16, 16)), jnp.zeros((1,)),
                       jnp.zeros((1, 7, ucfg.cross_attention_dim)))
    vp = random_params(vae, 1, jnp.zeros((1, 3, 64, 64)), jax.random.PRNGKey(0))
    jpipe = JaxPipeline(unet, up, vae, vp)
    to_np = lambda p: jax.tree.map(np.asarray, p)            # noqa: E731
    port = DiffusionPipeline(load_jax_params(UNet2DCondition(UNetConfig(**TWO_LEVELS)), to_np(up)),
                             load_jax_params(AutoencoderKL(tiny_vae_config()), to_np(vp)),
                             device="cpu")
    c = {"crossattn": np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, 7, 16))) * 0.1}
    u = {"crossattn": np.asarray(jax.random.normal(jax.random.PRNGKey(1), (1, 7, 16))) * 0.1}
    return jpipe, port, c, u


# 192 x 192 px -> a 24 x 24 latent: MoD tiles of 16 at overlap 8, 4 tiles in
# one batch (the combinator's test covers several); exact tiled encode at
# tile 64 (4 tiles of 128)
TD = dict(method=Method.MIX_DIFF, tile_w=16, tile_h=16, overlap=8, tile_bs=4,
          noise_inverse=True, noise_inverse_steps=2, noise_inverse_retouch=0.8)
TV = dict(encoder_tile_size=64, fast_encoder=False, fast_decoder=False)
SP = dict(name="Euler", steps=4, cfg_scale=7.0, denoising_strength=0.5)


def _jax_noise(seed, moments_shape):
    """The JAX package's draws in img2img: the encoder's sample and the
    sampling noise."""
    key = jax.random.PRNGKey(seed)
    shape = (moments_shape[0], moments_shape[1] // 2) + tuple(moments_shape[2:])
    enc = jax.random.normal(jax.random.fold_in(key, 3), shape, jnp.float32)
    return np.array(enc), np.array(jax.random.normal(key, shape, jnp.float32))


@pytest.mark.parametrize("case", ["mod_noise_inverse", "lanczos_x2", "mask", "target_size",
                                  "init_latents"])
def test_tiny_img2img_matches_jax(pipes, case):
    """The whole img2img, decode off, JAX's noise fed to the port:

    * ``mod_noise_inverse``: MoD + noise inversion (2 steps) on a 192 x 192
      uint8 image with upscaler None and renoise strength 0.5: both sides
      quantise the same uint8 image for the renoise mask
      (``tensor_to_image(image_to_tensor(u8)) == u8``), so the masks agree;
    * ``lanczos_x2``: a 96 x 96 image through the Lanczos upscaler x2, renoise
      strength 0 (the mask would quantise two different fp32 upscales);
    * ``mask``: masked redraw on the MoD canvas, no inversion;
    * ``target_size``: a 160 x 176 image resized (Lanczos) to 192 x 192,
      renoise strength 0;
    * ``init_latents``: a given latent in place of the encode, no inversion.

    Euler, 4 steps at denoise 0.5 (3 steps), CFG 7, exact tiled encode. The
    cases share their compiled JAX programs where the shapes allow."""
    jpipe, port, c, u = pipes
    jpipe.free_cache()
    port.free_cache()
    td, mask, img = dict(TD), None, _u8(8, 192, 192)
    target, init = None, None
    if case == "mod_noise_inverse":
        td["noise_inverse_renoise_strength"] = 0.5
    elif case == "lanczos_x2":
        td.update(upscaler="Lanczos", scale_factor=2.0, noise_inverse_renoise_strength=0.0)
        img = _u8(9, 96, 96)
    elif case == "mask":
        td["noise_inverse"] = False
        yy, xx = np.mgrid[0:192, 0:192]
        mask = ((yy + xx) / 383.0).astype(np.float32)
    elif case == "target_size":
        td["noise_inverse_renoise_strength"] = 0.0
        img, target = _u8(10, 160, 176), (192, 192)
    else:
        td["noise_inverse"] = False
        img, init = None, np.random.default_rng(15).normal(size=(1, 4, 24, 24)).astype(
            np.float32)
    res_j = jpipe.img2img(img, {k: jnp.asarray(v) for k, v in c.items()},
                          {k: jnp.asarray(v) for k, v in u.items()},
                          sampler=jcfg.SamplerConfig(**SP), seed=11,
                          tiled_diffusion=jcfg.TiledDiffusionConfig(**td),
                          tiled_vae=jcfg.TiledVAEConfig(**TV), mask=mask, decode=False,
                          target_size=target,
                          init_latents=None if init is None else jnp.asarray(init))
    enc, noise = _jax_noise(11, (1, 8, 24, 24))
    res_t = port._img2img_from_noise(img, enc, noise, c, u, SamplerConfig(**SP), 11,
                                     TiledDiffusionConfig(**td), TiledVAEConfig(**TV),
                                     mask=mask, init_latents=init, decode=False,
                                     target_size=target)
    assert res_t.latents.shape == (1, 4, 24, 24)
    _close(res_t.latents, res_j.latents)
    assert res_t.info == res_j.info
    if case == "init_latents":
        with pytest.raises(ValueError, match="noise_inverse requires an image"):
            port._img2img_from_noise(None, enc, noise, c, u, SamplerConfig(**SP), 11,
                                     TiledDiffusionConfig(**TD), init_latents=init)
    elif case != "mask":
        _close(port.noise_inverse_cache.xt, jpipe.noise_inverse_cache.xt)


def test_noise_inversion_matches_jax(pipes):
    """Two reverse-Euler steps over the MoD plan of the whole-slice cases
    (whose compiled JAX program it reuses), with retouch 0.8, on another
    latent."""
    jpipe, port, c, _ = pipes
    lat = np.random.default_rng(7).normal(size=(1, 4, 24, 24)).astype(np.float32)
    plan = plan_tiled_diffusion(Method.MIX_DIFF, 24, 24, 16, 16, 8, tile_bs=4)
    jplan = jax_plan(jcfg.Method.MIX_DIFF, 24, 24, 16, 16, 8, tile_bs=4)
    want = jpipe.noise_inversion(jnp.asarray(lat), {"crossattn": jnp.asarray(c["crossattn"])},
                                 2, 0.8, jplan)
    got = port.noise_inversion(torch.from_numpy(lat), c, 2, 0.8, plan)
    _close(got, want)


def test_decode_nan_chain(pipes, monkeypatch):
    """A poisoned ``conv_out`` makes the exact and the fast decode NaN: the
    image is the cheap latent preview, as the JAX package computes it. When
    only the first decode fails, the retry with estimated statistics gives
    the image."""
    _, port, _, _ = pipes
    z = np.random.default_rng(12).normal(size=(1, 4, 24, 24)).astype(np.float32) * 0.2
    tv = TiledVAEConfig(decoder_tile_size=16, fast_decoder=False)
    bias = port.vae.decoder.conv_out.bias
    saved = bias.detach().clone()
    try:
        with torch.no_grad():
            bias.fill_(float("nan"))
        img = port._decode(torch.from_numpy(z), tv)
    finally:
        with torch.no_grad():
            bias.copy_(saved)
    assert port.last_decode == "latent preview"
    approx = jimage.cheap_latent_preview(jnp.asarray(z) / 0.18215)
    approx = jresize.resize_nchw(approx, (192, 192), "linear")
    want = jimage.tensor_to_image(np.clip(np.asarray(approx), -1.0, 1.0))
    assert img.shape == (1, 192, 192, 3)
    assert np.abs(img.astype(int) - want.astype(int)).max() <= 1

    real = port._decode_tensor
    seen = []

    def first_fails(latents, tv_):
        seen.append(tv_.fast_decoder)
        out = real(latents, tv_)
        return out * float("nan") if len(seen) == 1 else out

    monkeypatch.setattr(port, "_decode_tensor", first_fails)
    img = port._decode(torch.from_numpy(z), tv)
    assert seen == [False, True] and port.last_decode == "estimated stats"
    want = real(torch.from_numpy(z), TiledVAEConfig(decoder_tile_size=16))
    np.testing.assert_array_equal(img, image.tensor_to_image(want))
    monkeypatch.undo()
    port._decode(torch.from_numpy(z), tv)
    assert port.last_decode == "decode"


def test_noise_inverse_cache_hit_and_miss(pipes, monkeypatch):
    """The inversion runs once for the same image, cond, steps, retouch and
    weights; another cond, other steps or newly loaded weights miss; and
    ``free_cache`` empties it."""
    _, port, c, u = pipes
    runs = []
    real = port.noise_inversion
    monkeypatch.setattr(port, "noise_inversion",
                        lambda *a, **k: runs.append(1) or real(*a, **k))
    img = _u8(13, 64, 64)
    td = TiledDiffusionConfig(**{**TD, "noise_inverse_renoise_strength": 0.0})
    sp = SamplerConfig(name="Euler", steps=2, denoising_strength=0.5)

    def go(cond=c, tdc=td):
        return port.img2img(img, cond, u, sampler=sp, seed=1, tiled_diffusion=tdc,
                            tiled_vae=None, decode=False)

    port.free_cache()
    first = go()
    go()
    assert len(runs) == 1                                  # hit
    go(cond={"crossattn": c["crossattn"] * 2})
    assert len(runs) == 2                                  # another prompt
    go(tdc=TiledDiffusionConfig(**{**TD, "noise_inverse_steps": 3,
                                   "noise_inverse_renoise_strength": 0.0}))
    assert len(runs) == 3                                  # other steps
    go(tdc=td)
    assert len(runs) == 4
    go(tdc=td)
    assert len(runs) == 4                                  # hit again
    sd = {k: v.clone() for k, v in port.unet.state_dict().items()}
    port.unet.load_state_dict(sd)                          # the same values, reloaded
    again = go()
    assert len(runs) == 5                                  # new weights miss
    torch.testing.assert_close(again.latents, first.latents)
    port.free_cache()
    assert port.noise_inverse_cache is None
    go()
    assert len(runs) == 6


def test_img2img_entry_point_runs_on_cpu_when_asked(pipes):
    _, port, c, u = pipes
    kw = dict(sampler=SamplerConfig(steps=2), seed=3,
              tiled_diffusion=TiledDiffusionConfig(
                  method=Method.MIX_DIFF, tile_w=8, tile_h=8, overlap=4, upscaler="Nearest",
                  scale_factor=1.5, noise_inverse=True, noise_inverse_steps=2,
                  noise_inverse_renoise_kernel=8),
              tiled_vae=TiledVAEConfig(encoder_tile_size=32, decoder_tile_size=4,
                                       tile_batch=2))
    res = port.img2img(_u8(14, 64, 80), c, u, **kw)
    assert res.images.shape == (1, 96, 120, 3) and res.images.dtype == np.uint8
    assert torch.isfinite(res.latents).all() and port.last_decode == "decode"
    port.free_cache()
    again = port.img2img(_u8(14, 64, 80), c, u, **kw)
    np.testing.assert_array_equal(again.images, res.images)        # seeded
