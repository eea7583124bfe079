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
from mdu_tpu_torch.ops.kernels import flash as flash_mod
from mdu_tpu_torch.ops.kernels import flash_bwd as flash_bwd_mod
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


def _recording_launch(monkeypatch):
    """Replaces the kernel launch of ``ops/kernels/flash.py`` with a recorder
    of (name, library, C function, form, args), and its device check with
    nothing, so that meta tensors reach the form choice."""
    calls = []
    monkeypatch.setattr(flash_mod, "_check", lambda *a: None)
    monkeypatch.setattr(flash_mod, "launch",
                        lambda name, lib, fn, dev, *args, form=None:
                        calls.append((name, lib, fn, form, args)))
    return calls


def test_fm_at_wide_bf16_heads_takes_the_wide_form(monkeypatch):
    """fm / fm16 on the VAE's D = 512 in bf16 launch the fixed shift on the
    wide warpgroup kernel of flash_attention's library
    (mdu_flash_attention_fm_wide), counted under flash_attention_fm, with no
    raise."""
    calls = _recording_launch(monkeypatch)
    q = torch.zeros(1, 1, 8, 512, dtype=torch.bfloat16, device="meta")
    for kw in ({}, {"bf16_exp": True}):
        assert flash_attention_fm(q, q, q, **kw).shape == q.shape
    assert [c[:4] for c in calls] == [("flash_attention_fm", "flash_attention",
                                       "mdu_flash_attention_fm_wide", "wide")] * 2
    # (q, k, v, out, bh, Lq, Lk, D, scale, smax, clamp, bf16_exp, vec)
    assert [c[4][11].value for c in calls] == [0, 1]
    assert calls[0][4][8].value == pytest.approx(512 ** -0.5)
    assert flash_mod.MAX_D["flash_attention_fm"] == 512


_NARROW = [(40, "sm90"), (64, "sm90"), (80, "sm90"), (160, "sm90"), (16, "sm90"), (4, "mma"),
           (13, "mma"), (72, "sm90"), (100, "mma")]
# above D = 160: #1 and #2 take the wide warpgroup form for D % 8 == 0, else
# the split-D mma.sync kernel (#1's wide_mma); #3 runs #2's form there
_WIDE = [(168, "wide", "wide"), (200, "wide", "wide"), (512, "wide", "wide"),
         (164, "wide_mma", "mma"), (300, "wide_mma", "mma"), (508, "wide_mma", "mma")]


@pytest.mark.parametrize("D,form,name", [
    *[(D, form, name) for D, form in _NARROW
      for name in ("flash_attention_fm", "flash_attention_t")],
    *[(D, "mma", "flash_attention") for D, _ in _NARROW],
    *[(D, fm, "flash_attention_fm") for D, fm, _ in _WIDE],
    *[(D, other, name) for D, _, other in _WIDE
      for name in ("flash_attention", "flash_attention_t")]])
def test_bf16_form_rule(monkeypatch, D, form, name):
    """Aligned bf16 with D % 8 == 0 goes to a warpgroup form, sm90 for 16 <=
    D <= 160 (#1, #3) and wide for 160 < D <= 512 (#1, #2); other heads, and
    every #2 head up to 160, to an mma.sync form (#1's split-D one above 160
    is wide_mma). #3 above 160 runs #2's form, counted under #2. The
    wrapper launches the C function of the form the rule picks."""
    calls = _recording_launch(monkeypatch)
    q = torch.zeros(1, 1, 8, D, dtype=torch.bfloat16, device="meta")
    fn = {"flash_attention_fm": flash_attention_fm, "flash_attention_t": flash_attention_t,
          "flash_attention": flash_attention}[name]
    fn(q, q, q)
    runs = "flash_attention" if name == "flash_attention_t" and D > 160 else name
    assert flash_mod.bf16_form(runs, q, q, q) == form
    assert calls[0][:4] == (runs, *flash_mod.FORMS[runs][form], form)
    # (q, k, v, out, bh, Lq, Lk, D, scale) + (smax, clamp, bf16_exp) + (vec)
    n_args = (9 + 3 * (runs == "flash_attention_fm")
              + (form not in flash_mod.WARPGROUP_FORMS))
    assert len(calls[0][4]) == n_args


def test_unaligned_bf16_goes_to_the_mma_form():
    """A base off a 16-byte boundary cannot carry a tensor map: at D = 40
    (#1, #3) and at D = 512 (#1, #2: the split-D mma.sync kernel)."""
    for D, names, aligned_form, mma_form in (
            (40, ("flash_attention_fm", "flash_attention_t"), "sm90", "mma"),
            (512, ("flash_attention_fm",), "wide", "wide_mma"),
            (512, ("flash_attention",), "wide", "mma")):
        q = _off16((1, 1, 8, D), torch.bfloat16, True)
        ok = torch.zeros(1, 1, 8, D, dtype=torch.bfloat16)
        assert q.is_contiguous() and q.data_ptr() % 16 != 0
        for name in names:
            assert flash_mod.bf16_form(name, ok, ok, ok) == aligned_form
            assert flash_mod.bf16_form(name, q, ok, ok) == mma_form
            assert flash_mod.bf16_form(name, ok, ok, q) == mma_form


@pytest.mark.parametrize("name", ["flash_attention_fm_f32", "flash_attention_f32"])
@pytest.mark.parametrize("D,unaligned,form", [
    (40, False, "sm90"), (80, False, "sm90"), (4, False, "sm90"), (16, False, "sm90"),
    (160, False, "sm90"), (164, False, "wide"), (512, False, "wide"), (13, False, "simt"),
    (42, False, "simt"), (162, False, "simt"), (508, False, "wide"), (40, True, "simt"),
    (512, True, "simt")])
def test_f32_form_rule(monkeypatch, name, D, unaligned, form):
    """fp32 with D % 4 == 0 and 16-byte aligned q, k, v goes to the
    tensor-core forms, sm90 up to D = 160 and wide above; anything else to
    the CUDA-core form. A form's launch calls its own C function, counted
    under it, with ``vec`` for simt only; the wrappers launch the form the
    rule picks."""
    calls = _recording_launch(monkeypatch)
    x = _off16((1, 1, 8, D), torch.float32, unaligned)
    ok = torch.zeros(1, 1, 8, D)
    assert flash_mod.f32_form(name, ok, ok, x) == form
    assert flash_mod.f32_form(name, x, ok, ok) == form
    assert flash_mod.launch_f32_form(name, form, x, ok, ok).shape == x.shape
    # (q, k, v, out, bh, Lq, Lk, D, scale) + (smax, clamp, bf16_exp) + (vec)
    n_args = 9 + (3 if name == "flash_attention_fm_f32" else 0) + (form == "simt")
    assert [(c[:4], len(c[4])) for c in calls] == [
        ((name, "flash_attention_f32", flash_mod.F32_FORMS[name][form], form), n_args)]
    if not unaligned:                       # meta tensors count as aligned
        m = torch.zeros(1, 1, 8, D, device="meta")
        fn = flash_attention_fm if name == "flash_attention_fm_f32" else flash_attention
        assert fn(m, m, m).shape == m.shape
        assert calls[-1][:4] == calls[0][:4]


@pytest.mark.parametrize("dtype,D,unaligned,form", [
    *[(torch.float32, D, False, "f32_simt" if D == 13 else "f32_sm90")
      for D in (4, 13, 40, 64, 80, 160)],
    *[(torch.bfloat16, D, False, "bf16_simt" if D in (4, 13) else "bf16_sm90")
      for D in (4, 13, 40, 64, 80, 160)],
    *[(dt, D, True, f"{name}_simt") for dt, name in ((torch.float32, "f32"),
                                                    (torch.bfloat16, "bf16"))
      for D in (4, 13, 40, 64, 80, 160)]])
def test_bwd_form_rule(monkeypatch, dtype, D, unaligned, form):
    """The backward's form by dtype, D and alignment alone: fp32 with D % 4
    == 0 and D <= 160 and bf16 with D % 8 == 0 and 16 <= D <= 160 go to the
    tensor-core forms when q, k, v and dO sit on 16-byte boundaries; a view
    one element off, or any other head, to the CUDA-core form. A form's
    launch calls its own library's C function, counted under it, with the
    dtype flag for simt only."""
    calls = []
    monkeypatch.setattr(flash_bwd_mod, "launch",
                        lambda name, lib, fn, dev, *args, form=None:
                        calls.append((name, lib, fn, form, args)))
    x = _off16((1, 2, 8, D), dtype, unaligned)
    ok = torch.zeros(1, 2, 8, D, dtype=dtype)
    for args in ((x, ok, ok, ok), (ok, ok, x, ok), (ok, x, ok, ok), (ok, ok, ok, x)):
        assert flash_bwd_mod.bwd_form(*args) == form
    grads = flash_bwd_mod.launch_bwd_form(form, x, ok, ok, ok, ok)
    assert [tuple(g.shape) for g in grads] == [(1, 2, 8, D)] * 3
    # (q, k, v, o, do, dq, dk, dv, lse, delta, bh, Lq, Lk, D, scale) + (bf16)
    assert [(c[:4], len(c[4])) for c in calls] == [
        (("flash_attention_bwd", *flash_bwd_mod.BWD_FORMS[form], form),
         15 + form.endswith("simt"))]
    assert calls[0][4][10].value == 2 and calls[0][4][14].value == pytest.approx(D ** -0.5)


def test_flash_t_fp32_takes_flash_attention_f32_forms(monkeypatch):
    """fp32 under MDU_FLASH=trans runs flash_attention's fp32 forms (the
    same function), counted under flash_attention_f32."""
    calls = _recording_launch(monkeypatch)
    for D, form in ((40, "sm90"), (512, "wide"), (13, "simt")):
        q = torch.zeros(1, 1, 8, D, device="meta")
        flash_attention_t(q, q, q)
        assert calls[-1][:4] == ("flash_attention_f32", "flash_attention_f32",
                                 flash_mod.F32_FORMS["flash_attention_f32"][form], form)


def _off16(shape, dtype, unaligned):
    """A contiguous tensor of ``shape`` whose base is (or is not) on a
    16-byte boundary."""
    n = int(np.prod(shape))
    base = torch.zeros(n + 1, dtype=dtype)
    t = (base[1:] if unaligned else base[:n]).view(*shape)
    assert (t.data_ptr() % 16 != 0) == unaligned
    return t


@pytest.mark.parametrize("C,Co,off,form", [
    (320, 320, None, "sm90"), (640, 320, None, "sm90"), (64, 40, None, "sm90"),
    (24, 40, None, "mma"), (12, 40, None, "mma"), (96, 40, None, "mma"),  # C % 64
    (320, 20, None, "mma"),                                                # Co % 8
    (320, 40, "x", "mma"), (320, 40, "packed", "mma"), (320, 40, "scale", "mma"),
    (320, 40, "shift", "mma")])
def test_conv_form_rule(monkeypatch, C, Co, off, form):
    """bf16 with C % 64 == 0, Co % 8 == 0 and every operand on a 16-byte
    boundary goes to the warpgroup form, anything else to the mma.sync form;
    the launch takes the C function of the form it is given and counts it
    under it."""
    from mdu_tpu_torch.ops.kernels import conv3x3 as conv_mod

    B, H, W = 1, 4, 8
    Cp = -(-C // conv_mod.K_CHUNK) * conv_mod.K_CHUNK
    bf = torch.bfloat16
    x = _off16((B, H, W, C), bf, off == "x")
    packed = _off16((Co, 9 * Cp), bf, off == "packed")
    scale = _off16((B, C), torch.float32, off == "scale")
    shift = _off16((B, C), torch.float32, off == "shift")
    assert conv_mod.conv_form(x, packed, scale, shift) == form
    calls = []
    monkeypatch.setattr(conv_mod, "launch", lambda name, lib, fn, dev, *args, form=None:
                        calls.append((name, lib, fn, form, len(args))))
    y = conv_mod.launch_form(form, x, packed, scale, shift, True)
    assert y.shape == (B, H, W, Co)
    # (x, packed, scale, shift, y, B, H, W, C, Cp, Co, fuse_act) + (is_bf16, vec)
    assert calls == [("fused_conv3x3", "conv3x3", conv_mod.FORMS[form], form,
                      12 if form == "sm90" else 14)]


@pytest.mark.parametrize("C,Co,off,form", [
    (320, 320, None, "sm90"), (640, 320, None, "sm90"), (320, 640, None, "sm90"),
    (16, 40, None, "sm90"), (48, 200, None, "sm90"),
    (24, 40, None, "simt"), (12, 40, None, "simt"), (40, 40, None, "simt"),  # C % 16
    (320, 20, None, "simt"),                                               # Co % 8
    (320, 40, "x", "simt"), (320, 40, "packed", "simt"), (320, 40, "scale", "simt"),
    (320, 40, "shift", "simt")])
def test_conv_f32_form_rule(monkeypatch, C, Co, off, form):
    """fp32 with C % 16 == 0, Co % 8 == 0 and every operand on a 16-byte
    boundary goes to the warpgroup form (three TF32 products), anything else
    to the CUDA-core form; the launch takes the C function of the form it is
    given and counts it under it."""
    from mdu_tpu_torch.ops.kernels import conv3x3 as conv_mod

    B, H, W = 1, 4, 8
    Cp = -(-C // conv_mod.K_CHUNK) * conv_mod.K_CHUNK
    f32 = torch.float32
    x = _off16((B, H, W, C), f32, off == "x")
    packed = _off16((2, Co, 9 * Cp), f32, off == "packed")
    scale = _off16((B, C), f32, off == "scale")
    shift = _off16((B, C), f32, off == "shift")
    assert conv_mod.packed_shape(C, Co, f32) == tuple(packed.shape)
    assert conv_mod.conv_f32_form(x, packed, scale, shift) == form
    calls = []
    monkeypatch.setattr(conv_mod, "launch", lambda name, lib, fn, dev, *args, form=None:
                        calls.append((name, lib, fn, form, [getattr(a, "value", None)
                                                            for a in args])))
    y = conv_mod.launch_f32_form(form, x, packed, scale, shift, True)
    assert y.shape == (B, H, W, Co) and y.dtype == f32
    # (x, packed, scale, shift, y, B, H, W, C, Cp, Co, fuse_act) + (is_bf16, vec)
    assert [c[:4] for c in calls] == [("fused_conv3x3_f32", "conv3x3",
                                       conv_mod.F32_FORMS[form], form)]
    assert calls[0][4][5:] == [B, H, W, C, Cp, Co, 1] + ([0, 0] if form == "simt" else [])


def _tf32_rna(x):
    """x rounded to tf32, to the nearest with ties away from zero."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_trunc(x):
    """x as the tensor cores read an fp32 word in tf32: the low 13 mantissa
    bits dropped."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def test_conv_f32_three_tf32_passes_keep_fp32_precision(rng):
    """The fp32 warpgroup conv's arithmetic (csrc/conv3x3_f32_sm90.cuh),
    emulated in numpy on a [1, 6, 10, 32] -> 16 fused conv: the weight split
    at pack time (big + small is the weight, big a tf32 value), the
    activated and zero-padded input split the same way, small read as the
    tensor cores read it, As.Bb + Ab.Bs + Ab.Bb with each 16-channel chunk
    summed on its own and then added in fp32: within the kernel's 1e-4 bar of
    the fp32 plain version, where one TF32 pass is not."""
    from mdu_tpu_torch.ops.kernels import conv3x3 as conv_mod

    B, H, W, C, Co = 1, 6, 10, 32, 16
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    w = (rng.normal(size=(3, 3, C, Co)) / np.sqrt(9 * C)).astype(np.float32)
    scale = (1 + 0.5 * rng.normal(size=(B, C))).astype(np.float32)
    shift = (0.2 * rng.normal(size=(B, C))).astype(np.float32)
    want = fused_conv3x3_plain(*_t(x, w, scale, shift), fuse_act=True).numpy()

    packed = conv_mod.pack_conv3x3_weight(torch.from_numpy(w)).numpy()
    Cp = packed.shape[-1] // 9
    assert packed.shape == (2, Co, 9 * Cp)
    big, small = packed
    assert np.array_equal(big, _tf32_rna(big)) and np.array_equal(big, _tf32_rna(big + small))
    assert np.array_equal(big + small, conv_mod.pack_conv3x3_weight(
        torch.from_numpy(w).double()).float().numpy())
    wb = big.reshape(Co, 3, 3, Cp)[..., :C]
    ws = _tf32_trunc(small).reshape(Co, 3, 3, Cp)[..., :C]

    xf = x * scale[:, None, None, :] + shift[:, None, None, :]
    a = np.pad(xf / (1 + np.exp(-xf)), ((0, 0), (1, 1), (1, 1), (0, 0)))
    ab = _tf32_rna(a)
    as_ = _tf32_trunc(a - ab)

    def conv(av, wv, c0):
        """sum over the 9 taps and the channels c0 .. c0 + 15, in fp32"""
        out = np.zeros((B, H, W, Co), np.float32)
        for dy in range(3):
            for dx in range(3):
                win = av[:, dy:dy + H, dx:dx + W, c0:c0 + 16]
                out += np.einsum("bhwc,oc->bhwo", win, wv[:, dy, dx, c0:c0 + 16])
        return out

    got = np.zeros((B, H, W, Co), np.float32)
    one_pass = np.zeros((B, H, W, Co), np.float32)
    for c0 in range(0, C, 16):
        got += conv(as_, wb, c0) + conv(ab, ws, c0) + conv(ab, wb, c0)
        one_pass += conv(ab, _tf32_rna(wb + ws), c0)
    assert np.abs(got - want).max() <= 1e-4
    assert np.abs(one_pass - want).max() > 1e-4


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


@pytest.mark.parametrize("B,C,H,W,itemsize,plan", [
    (10, 320, 64, 96, 2, ("cluster", 4, 15360)),    # config 2's level 0: 39 MB, 120 KB a group
    (10, 320, 64, 96, 4, ("cluster", 8, 7680)),     # the same in fp32, 240 KB
    (10, 960, 64, 96, 2, ("cluster", 8, 23040)),    # the largest ResBlock group: 45 KB parts
    (10, 416, 67, 93, 2, ("cluster", 8, 10128)),    # ragged: whole 16-byte lines a part
    (10, 640, 32, 48, 2, ("two_read", 0, 0)),       # 20 MB: the second read comes from L2
    (10, 1280, 8, 12, 2, ("two_read", 0, 0)),
    (1, 96, 7, 9, 4, ("two_read", 0, 0)),
    (1, 32 * 13, 128, 256, 4, ("two_read", 0, 0)),  # 1.7 MB a group: past 8 parts of 192 KB
])
def test_gn_form_rule(B, C, H, W, itemsize, plan):
    """#4's form is a function of the shape and dtype alone: the cluster form
    for a tensor past 32 MiB whose group fits a cluster (the fewest CTAs, up
    to 8, whose parts hold 32 KB, each part whole 16-byte lines, none past
    192 KB), else the two-read form."""
    from mdu_tpu_torch.ops.kernels.group_norm import cluster_split, gn_plan

    got = gn_plan(B, C, 32, H, W, itemsize)
    assert got == plan
    n = C // 32 * H * W
    split = cluster_split(n, itemsize)
    if got[0] == "cluster":
        cluster, part = split
        assert cluster * part >= n > (cluster - 1) * part and part * itemsize % 16 == 0
    elif n * itemsize <= 8 * 192 * 1024:
        assert split is not None                    # two_read by the tensor's size alone


def test_launch_resolves_each_c_function_once(monkeypatch):
    """``launch`` looks a C function up and sets its argtypes on its first
    call only; every call still counts, and passes the current stream."""
    from mdu_tpu_torch.ops.kernels import launch as launch_mod

    calls, lookups = [], []

    class Fn:
        def __init__(self):
            self.set = []

        def __setattr__(self, key, value):
            if key != "set":
                self.set.append(key)
            object.__setattr__(self, key, value)

        def __call__(self, *args):
            calls.append(args)
            return 0

    class Lib:
        def __getattr__(self, name):
            lookups.append(name)
            fn = Fn()
            object.__setattr__(self, name, fn)
            return fn

    lib = Lib()
    monkeypatch.setattr(launch_mod.build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(launch_mod, "_raw_stream", lambda index: 1234)
    monkeypatch.setattr(launch_mod, "_FNS", {})
    before = dict(launch_mod.LAUNCHES)
    dev = torch.device("cuda", 0)
    for _ in range(3):
        launch_mod.launch("fused_tile_blend", "tile_blend", "mdu_tile_blend", dev,
                          launch_mod.ctypes.c_int(7))
    launch_mod.launch("fused_group_norm", "group_norm", "mdu_group_norm_cluster", dev,
                      launch_mod.ctypes.c_int(1), form="cluster")
    assert lookups == ["mdu_tile_blend", "mdu_group_norm_cluster"]
    assert lib.mdu_tile_blend.set == ["argtypes", "restype"]
    assert lib.mdu_tile_blend.argtypes == [launch_mod.ctypes.c_int, launch_mod.ctypes.c_void_p]
    assert [a[-1] for a in calls] == [1234] * 4
    assert launch_mod.LAUNCHES["fused_tile_blend"] == before["fused_tile_blend"] + 3
    assert (launch_mod.LAUNCHES["fused_group_norm.cluster"]
            == before["fused_group_norm.cluster"] + 1)


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
