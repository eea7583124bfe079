"""Port parity for the flagged kernels (MDU_FUSED_GN, MDU_FUSED_CONV,
MDU_FUSED_BLEND, MDU_FLASH): each plain version against its Pallas kernel in
interpret mode (oracles as in tests/test_pallas.py), the port's copies of the
host-side planners against the JAX ones, the flagged tiny UNet and tile
fusion against the JAX package under its flags, and the flag dispatch.
Inputs come from numpy with a seed; each test states its tolerance."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdu_tpu.models import UNet2DCondition as JaxUNet
from mdu_tpu.models import random_params
from mdu_tpu.models.unet import UNetConfig as JaxUNetConfig
from mdu_tpu.ops.pallas import build_contributor_table as jax_table
from mdu_tpu.ops.pallas import flash_attention_t as jax_flash_t
from mdu_tpu.ops.pallas import flash_attention_t_fm as jax_flash_fm
from mdu_tpu.ops.pallas import fused_group_norm as jax_gn
from mdu_tpu.ops.pallas import fused_tile_blend as jax_blend
from mdu_tpu.ops.pallas.conv3x3 import _plan_blocks as jax_plan_blocks
from mdu_tpu.ops.pallas.conv3x3 import fused_conv3x3 as jax_conv
from mdu_tpu.tiling import schedulers as jsched
from mdu_tpu.utils import grid as jgrid
from mdu_tpu_torch import (DiffusionPipeline, Method, SamplerConfig,
                           TiledDiffusionConfig, TiledVAEConfig)
from mdu_tpu_torch.models import (AutoencoderKL, UNet2DCondition, load_jax_params,
                                  random_state_dict, tiny_unet_config, tiny_vae_config)
from mdu_tpu_torch.models import layers as port_layers
from mdu_tpu_torch.models.unet import UNetConfig
from mdu_tpu_torch.ops import attention as port_attention
from mdu_tpu_torch.ops.kernels import (LAUNCHES, flash_attention, flash_attention_fm,
                                       flash_attention_fm_plain, flash_attention_t,
                                       flash_attention_t_plain, fused_conv3x3,
                                       fused_conv3x3_plain, fused_group_norm,
                                       fused_group_norm_plain, fused_tile_blend,
                                       fused_tile_blend_plain)
from mdu_tpu_torch.ops.kernels.conv3x3 import _plan_blocks
from mdu_tpu_torch.tiling import schedulers as psched
from mdu_tpu_torch.utils import grid
from mdu_tpu_torch.utils.bbox import BBox
from mdu_tpu_torch.utils.blend_table import build_contributor_table

torch.set_num_threads(2)
FLAGS = ("MDU_FUSED_GN", "MDU_FUSED_CONV", "MDU_FUSED_BLEND", "MDU_FLASH")


@pytest.fixture(autouse=True)
def _no_flags(monkeypatch):
    for f in FLAGS:
        monkeypatch.delenv(f, raising=False)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


# ----------------------------------------------------------- #4 GroupNorm


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 3e-2)])
def test_group_norm_plain_matches_pallas(rng, dtype, tol):
    x = (rng.normal(size=(2, 16, 8, 12)) * 3 + 1).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    want = np.asarray(jax_gn(jnp.asarray(x, dtype), 4, jnp.asarray(w), jnp.asarray(b),
                             interpret=True)).astype(np.float32)
    xt, wt, bt = _t(x, w, b)
    got = fused_group_norm_plain(xt.to(getattr(torch, dtype)), 4, wt, bt)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_group_norm_plain_clamps_a_zero_variance_group(rng):
    """Group 0 is constant: E[x^2] - mean^2 rounds to about 0, and the Pallas
    body, which does not clamp, may take rsqrt of a negative (NaN). The port
    clamps at 0, so group 0 is exactly the bias; the other group agrees
    with the Pallas kernel to 2e-4."""
    x = np.full((1, 8, 8, 12), 5.0, np.float32)
    x[:, 4:] = rng.normal(size=(1, 4, 8, 12))
    w = rng.normal(size=(8,)).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    want = np.asarray(jax_gn(jnp.asarray(x), 2, jnp.asarray(w), jnp.asarray(b),
                             interpret=True))
    got = fused_group_norm_plain(*_t(x), 2, *_t(w, b)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[0, :4], np.broadcast_to(b[:4, None, None], (4, 8, 12)))
    np.testing.assert_allclose(got[0, 4:], want[0, 4:], rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------- #6 conv


@pytest.mark.parametrize("fuse_act", [False, True])
@pytest.mark.parametrize("B,H,W,C,Co", [
    (2, 8, 12, 16, 24),
    (1, 7, 9, 8, 8),        # odd H and W
])
def test_conv3x3_plain_matches_pallas(rng, fuse_act, B, H, W, C, Co):
    """conv3x3(silu(x * a + b)), zero pad after the activation: 2e-4."""
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    w = (rng.normal(size=(3, 3, C, Co)) * 0.1).astype(np.float32)
    a = (rng.normal(size=(B, C)) * 0.5 + 1.0).astype(np.float32)
    b = (rng.normal(size=(B, C)) * 0.2).astype(np.float32)
    want = np.asarray(jax_conv(*(jnp.asarray(v) for v in (x, w, a, b)),
                               fuse_act=fuse_act, interpret=True, block_h=4))
    got = fused_conv3x3_plain(*_t(x, w, a, b), fuse_act=fuse_act).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_plan_blocks_copy_matches_jax():
    """The port's planner decides dispatch: it must agree with JAX's on
    every SD1.5 / SDXL UNet shape and the tiny ones."""
    shapes = [(64, 96), (32, 48), (16, 24), (8, 12), (128, 128), (96, 96),
              (64, 64), (16, 16), (8, 8), (7, 9)]
    chans = [8, 16, 24, 320, 640, 960, 1280, 1920, 2560]
    n_fit = 0
    for H, W in shapes:
        for C in chans:
            for Co in chans:
                got = _plan_blocks(H, W, C, Co)
                assert got == jax_plan_blocks(H, W, C, Co), (H, W, C, Co)
                n_fit += got is not None
    assert 0 < n_fit < len(shapes) * len(chans) ** 2


# ---------------------------------------------------------- #5 tile blend


@pytest.mark.parametrize("h,w,tw,ov,bh,bw", [
    (64, 256, 96, 48, 16, 32),      # config 2's latent canvas and tiles
    (64, 96, 32, 16, 32, 32),
    (61, 97, 24, 8, 8, 128),
])
def test_contributor_table_copy_matches_jax(h, w, tw, ov, bh, bw):
    th = min(tw, h)
    jb = jgrid.split_grid(w, h, tw, th, ov)
    pb = grid.split_grid(w, h, tw, th, ov)
    want = jax_table(h, w, jb, bh, bw)
    got = build_contributor_table(h, w, pb, bh, bw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


@pytest.mark.parametrize("normalize", [True, False])
def test_tile_blend_plain_matches_pallas(rng, normalize):
    """Sums in bbox order in fp32 on both sides: 1e-6."""
    h, w, tw = 64, 96, 32
    jb = tuple(jgrid.split_grid(w, h, tw, tw, 16))
    pb = tuple(BBox(b.x, b.y, b.w, b.h) for b in jb)
    tiles = rng.normal(size=(len(jb), 4, tw, tw)).astype(np.float32)
    weights = jgrid.paint_count(w, h, jb)[0, 0]
    want = np.asarray(jax_blend(jnp.asarray(tiles), jnp.asarray(weights), h, w, jb,
                                normalize=normalize, interpret=True))
    got = fused_tile_blend_plain(*_t(tiles, weights), h, w, pb, normalize=normalize)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- #3, #1 flash


@pytest.mark.parametrize("Lq,Lk,D", [
    (200, 200, 40),
    (256, 256, 80),
    (300, 77, 40),      # ragged kv: padding on the TPU, masked here
])
def test_flash_t_plain_matches_pallas(rng, Lq, Lk, D):
    q, k, v = (rng.normal(size=(1, 2, L, D)).astype(np.float32) for L in (Lq, Lk, Lk))
    want = np.asarray(jax_flash_t(*(jnp.asarray(a) for a in (q, k, v)),
                                  block_q=128, block_k=128, interpret=True))
    got = flash_attention_t_plain(*_t(q, k, v)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-3), ("bfloat16", 2e-2)])
def test_fm_bf16_exp_plain_matches_pallas(rng, dtype, tol):
    """bf16_exp rounds the shifted score to bf16 before the exp. A score that
    differs in its last fp32 bit between the two products' summation orders
    can round to the neighbouring bf16 value (an ulp of 0.125 near -30),
    which moves that p by 13 %: hence 2e-3 in fp32, against a 2e-2 effect
    of the flag itself, which the test also checks."""
    q, k, v = (rng.normal(size=(1, 2, 256, 40)).astype(np.float32) for _ in range(3))
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    want = np.asarray(jax_flash_fm(jq, jk, jv, bf16_exp=True, block_q=128, block_k=128,
                                   interpret=True)).astype(np.float32)
    tq, tk, tv = (a.to(getattr(torch, dtype)) for a in _t(q, k, v))
    got = flash_attention_fm_plain(tq, tk, tv, bf16_exp=True).float().numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    if dtype == "float32":
        plain = flash_attention_fm_plain(tq, tk, tv).numpy()
        assert np.abs(plain - got).max() > 5 * tol


def test_flash_variant_follows_mdu_flash(monkeypatch):
    for D in (40, 512):
        monkeypatch.setenv("MDU_FLASH", "lane")
        assert port_attention._flash_variant(D) is flash_attention
        monkeypatch.setenv("MDU_FLASH", "trans")
        assert port_attention._flash_variant(D) is flash_attention_t
        monkeypatch.setenv("MDU_FLASH", "fm")
        assert port_attention._flash_variant(D) is flash_attention_fm
        monkeypatch.setenv("MDU_FLASH", "fm16")
        fn = port_attention._flash_variant(D)
        assert isinstance(fn, functools.partial) and fn.func is flash_attention_fm
        assert fn.keywords == {"bf16_exp": True}
        monkeypatch.setenv("MDU_FLASH", "other")
        assert port_attention._flash_variant(D) is (
            flash_attention if D % 128 == 0 else flash_attention_fm)


def test_fm_at_wide_bf16_heads_is_not_implemented():
    """fm / fm16 on the VAE's D = 512 in bf16 raise, naming the ROADMAP
    item, and do not route to another kernel (checked before any launch)."""
    q = torch.zeros(1, 1, 8, 512, dtype=torch.bfloat16, device="meta")
    for kw in ({}, {"bf16_exp": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
            flash_attention_fm(q, q, q, **kw)


def test_new_wrappers_take_the_plain_version_on_cpu_only(rng):
    before = dict(LAUNCHES)
    x = torch.from_numpy(rng.normal(size=(1, 8, 8, 8)).astype(np.float32))
    wt, bt = torch.ones(8), torch.zeros(8)
    torch.testing.assert_close(fused_group_norm(x, 2, wt, bt),
                               fused_group_norm_plain(x, 2, wt, bt), rtol=0, atol=0)
    w = torch.from_numpy(rng.normal(size=(3, 3, 8, 4)).astype(np.float32))
    torch.testing.assert_close(fused_conv3x3(x, w), fused_conv3x3_plain(x, w),
                               rtol=0, atol=0)
    q = torch.from_numpy(rng.normal(size=(1, 1, 64, 16)).astype(np.float32))
    torch.testing.assert_close(flash_attention_t(q, q, q), flash_attention_t_plain(q, q, q),
                               rtol=0, atol=0)
    bbs = grid.split_grid(24, 16, 16, 8, 4)
    tiles = torch.from_numpy(rng.normal(size=(len(bbs), 2, 8, 16)).astype(np.float32))
    wts = torch.from_numpy(grid.paint_count(24, 16, bbs)[0, 0])
    torch.testing.assert_close(fused_tile_blend(tiles, wts, 16, 24, bbs),
                               fused_tile_blend_plain(tiles, wts, 16, 24, bbs), rtol=0, atol=0)
    assert LAUNCHES == before                 # no kernel ran
    meta = x.to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_group_norm(meta, 2, wt.to("meta"), bt.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        fused_conv3x3(meta, w.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        fused_tile_blend(tiles.to("meta"), wts.to("meta"), 16, 24, bbs)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_t(*(q.to("meta"),) * 3)


# ------------------------------------------------------------ the modules


def _small_unet_configs():
    """A two-level SD1.5-shaped UNet (thin, shallow) so that the JAX side's
    interpret-mode conv kernels stay quick: at 16 x 16 both levels take the
    fused conv (H * W >= 64), including a 24-channel skip concat."""
    kw = dict(block_out_channels=(8, 16), layers_per_block=1, cross_attention_dim=16,
              num_heads=2, transformer_layers=(1, 0), norm_num_groups=4)
    return JaxUNetConfig(**kw), UNetConfig(**kw)


def test_unet_under_fused_flags_matches_jax(rng, monkeypatch):
    """The port with MDU_FUSED_CONV=1 and MDU_FUSED_GN=1 against JAX with
    MDU_FUSED_CONV=interp (JAX's GN flag is TPU-only: its plain GroupNorm is
    the oracle of the port's fused one). fp32, atol 1e-4 * max|ref|."""
    jcfg, pcfg = _small_unet_configs()
    unet = JaxUNet(jcfg)
    x = rng.normal(size=(2, 4, 16, 16)).astype(np.float32)
    t = np.array([5.0, 701.3], np.float32)
    ctx = rng.normal(size=(2, 7, 16)).astype(np.float32)
    params = random_params(unet, 0, jnp.asarray(x[:1]), jnp.asarray(t[:1]),
                           jnp.asarray(ctx[:1]))
    port = load_jax_params(UNet2DCondition(pcfg), jax.tree.map(np.asarray, params)).eval()
    monkeypatch.setenv("MDU_FUSED_CONV", "interp")
    want = np.asarray(jax.jit(unet.apply)(params, *(jnp.asarray(a) for a in (x, t, ctx))))
    monkeypatch.setenv("MDU_FUSED_CONV", "1")
    monkeypatch.setenv("MDU_FUSED_GN", "1")
    calls = {"conv": 0, "gn": 0}

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(port_layers, "fused_conv3x3",
                        count("conv", port_layers.fused_conv3x3))
    monkeypatch.setattr(port_layers, "fused_group_norm",
                        count("gn", port_layers.fused_group_norm))
    with torch.no_grad():
        got = port(*_t(x, t, ctx)).numpy()
    # every conv of the 8 ResBlocks (C <= 640, H * W >= 64 at 16 x 16 and
    # 8 x 8); GroupNorm: the 4 Transformer2D norms and norm_out (the
    # ResBlock norms take the folded affine under MDU_FUSED_CONV)
    assert calls == {"conv": 16, "gn": 5}
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def _toy_tile_denoise(flat, sigma, step, bboxes, batch_i):
    return flat * 0.5 + sigma * 0.1


def test_tiled_fusion_under_fused_blend_matches_jax(rng, monkeypatch):
    """make_tiled_denoiser on the tiny tiled txt2img's canvas (16 x 40
    latent, tile 16, overlap 8, tile_bs 3: two tile batches) with a toy
    tile denoiser: the port under MDU_FUSED_BLEND=1 against JAX under
    MDU_FUSED_BLEND=interp (1e-6), and against its own scatter path."""
    x = rng.normal(size=(2, 4, 16, 40)).astype(np.float32)
    jplan = jsched.plan_tiled_diffusion(Method.MULTI_DIFF, 16, 40, tile_h=16, tile_w=16,
                                        overlap=8, tile_bs=3)
    pplan = psched.plan_tiled_diffusion(Method.MULTI_DIFF, 16, 40, tile_h=16, tile_w=16,
                                        overlap=8, tile_bs=3)
    assert pplan.num_batches == 2
    monkeypatch.setenv("MDU_FUSED_BLEND", "interp")
    want = np.asarray(jsched.make_tiled_denoiser(jplan, _toy_tile_denoise)(
        jnp.asarray(x), jnp.asarray(1.0), jnp.asarray(0)))
    plain = psched.make_tiled_denoiser(pplan, _toy_tile_denoise)
    monkeypatch.setenv("MDU_FUSED_BLEND", "1")
    fused = psched.make_tiled_denoiser(pplan, _toy_tile_denoise)
    args = (torch.from_numpy(x), torch.tensor(1.0), 0)
    got = fused(*args)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    monkeypatch.delenv("MDU_FUSED_BLEND")
    torch.testing.assert_close(got, plain(*args), rtol=0, atol=0)


@pytest.fixture(scope="module")
def tiny_port():
    unet = UNet2DCondition(tiny_unet_config())
    vae = AutoencoderKL(tiny_vae_config())
    unet.load_state_dict(random_state_dict(unet, 0, device="cpu"))
    vae.load_state_dict(random_state_dict(vae, 1, device="cpu"))
    gen = torch.Generator().manual_seed(3)
    c = {"crossattn": torch.randn(1, 7, 16, generator=gen) * 0.1}
    u = {"crossattn": torch.randn(1, 7, 16, generator=gen) * 0.1}
    noise = torch.randn(1, 4, 16, 40, generator=gen)
    return DiffusionPipeline(unet, vae, device="cpu"), c, u, noise


def _tiny_txt2img(tiny_port, steps):
    pipe, c, u, noise = tiny_port
    res = pipe._txt2img_from_noise(
        noise, c, u, SamplerConfig(steps=steps), 0,
        TiledDiffusionConfig(tile_w=16, tile_h=16, overlap=8, tile_bs=3), decode=False)
    img = pipe._decode_tensor(res.latents, TiledVAEConfig(decoder_tile_size=16,
                                                          fast_decoder=False))
    return res.latents, img


def test_tiny_txt2img_under_all_flags_matches_unflagged(tiny_port, monkeypatch):
    """The tiny tiled txt2img + exact tiled decode with all four flags set
    against the same run with none, on the CPU (each wrapper's plain
    version): fp32, atol 1e-4 * max|ref|."""
    want = _tiny_txt2img(tiny_port, 3)
    for f, v in zip(FLAGS, ("1", "1", "1", "trans")):
        monkeypatch.setenv(f, v)
    got = _tiny_txt2img(tiny_port, 3)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * float(w.abs().max()))


@pytest.mark.parametrize("flag", [None, "MDU_FUSED_GN", "MDU_FUSED_CONV",
                                  "MDU_FUSED_BLEND"])
def test_flag_dispatch_calls_the_flagged_wrapper_only(tiny_port, monkeypatch, flag):
    """With no flag none of the new wrappers is called; under each flag its
    wrapper is. (``MDU_FLASH`` acts on CUDA tensors only: see
    test_flash_variant_follows_mdu_flash.)"""
    calls = {}

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(module, name, wrapped)

    spy(port_layers, "fused_group_norm")
    spy(port_layers, "fused_conv3x3")
    spy(psched, "fused_tile_blend")
    if flag:
        monkeypatch.setenv(flag, "1")
    _tiny_txt2img(tiny_port, 1)
    wrapper = {None: None, "MDU_FUSED_GN": "fused_group_norm",
               "MDU_FUSED_CONV": "fused_conv3x3",
               "MDU_FUSED_BLEND": "fused_tile_blend"}[flag]
    assert set(calls) == ({wrapper} if wrapper else set())
