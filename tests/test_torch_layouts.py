"""Port parity for the UNet's layout and experiment switches against
``mdu_tpu``: ``MDU_UNET_LAYOUT=NHWC`` (the port's UNet on
``torch.channels_last`` activations against JAX's NHWC UNet, oracle
``tests/test_nhwc.py``: SD1.5 with ControlNet-shaped residuals, SDXL, the
``state_dict`` equal to JAX's parameter tree), ``MDU_GN=fold|chanreduce``
and the channels-last GroupNorm (oracle ``tests/test_groupnorm.py``),
``conv3x3_mm`` in both modes and layouts (oracle ``tests/test_conv_mm.py``),
and the dispatch rules: under NHWC the fused conv takes more than 640
channels and the fused GroupNorm (#4) is never taken, ``MDU_CONV_MM`` comes
after the fused conv, an unknown layout raises.

Tolerances: UNets atol 1e-5 x max|ref| (fp32, JAX at 'highest'); GroupNorm
and ``conv3x3_mm`` in fp32 atol 1e-5 x max|ref|; in bf16 one bf16 step of
the largest value (2^-7 x max|ref|): both sides accumulate in fp32 and round
once to bf16, so they may differ by that rounding alone."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdu_tpu.models import ControlNet as JaxControlNet
from mdu_tpu.models import UNet2DCondition as JaxUNet
from mdu_tpu.models import random_params
from mdu_tpu.models import tiny_sdxl_unet_config as jax_tiny_sdxl
from mdu_tpu.models import tiny_unet_config as jax_tiny_unet
from mdu_tpu.ops import conv_mm as jconv_mm
from mdu_tpu.ops import groupnorm as jgn
from mdu_tpu.ops import tile_context as jtc
from mdu_tpu_torch import flags
from mdu_tpu_torch.models import (UNet2DCondition, default_unet_layout, load_jax_params,
                                  tiny_sdxl_unet_config, tiny_unet_config)
from mdu_tpu_torch.models import layers
from mdu_tpu_torch.models.convert import state_dict_from_jax
from mdu_tpu_torch.ops import groupnorm as pgn
from mdu_tpu_torch.ops import tile_context as ptc
from mdu_tpu_torch.ops.conv_mm import conv3x3_mm

torch.set_num_threads(2)
BF16_STEP = 2.0 ** -7


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rel):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().cpu().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, dtype=np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _skip_shapes(cfg, B, H, W):
    shapes, h, w = [(B, cfg.block_out_channels[0], H, W)], H, W
    L = len(cfg.block_out_channels)
    for i, ch in enumerate(cfg.block_out_channels):
        shapes += [(B, ch, h, w)] * cfg.layers_per_block
        if i != L - 1:
            h, w = (h + 1) // 2, (w + 1) // 2
            shapes.append((B, ch, h, w))
    return shapes, (B, cfg.block_out_channels[-1], h, w)


def _channels_last_everywhere(unet):
    """Forward pre-hooks that record every Conv2D / GroupNorm input that is
    not channels-last."""
    bad = []

    def hook(m, inp):
        x = inp[0]
        if x.dim() == 4 and x.shape[1] > 1 and not x.is_contiguous(
                memory_format=torch.channels_last):
            bad.append((type(m).__name__, tuple(x.shape)))

    for m in unet.modules():
        if isinstance(m, (layers.Conv2D, layers.GroupNorm)):
            m.register_forward_pre_hook(hook)
    return bad


@pytest.mark.parametrize("arch", ["sd15", "sdxl"])
def test_nhwc_unet_matches_jax(rng, arch):
    """The NHWC UNet against JAX's NHWC UNet on the same weights: SD1.5 with
    random ControlNet residuals (shapes from JAX's ControlNet; NCHW, turned
    channels-last at their add sites) on a 16 x 24 latent; SDXL with its
    added cond. The ``state_dict`` is JAX's NHWC parameter tree, name for
    name; every conv and norm input is channels-last; the output is NCHW
    contiguous and equal to the NCHW UNet's."""
    jcfg_, pcfg_ = ((jax_tiny_unet(), tiny_unet_config()) if arch == "sd15"
                    else (jax_tiny_sdxl(), tiny_sdxl_unet_config()))
    B, H, W = (2, 16, 24) if arch == "sd15" else (1, 16, 16)
    x = rng.normal(size=(B, 4, H, W)).astype(np.float32)
    t = np.array([10.0, 500.0][:B], np.float32)
    ctx = rng.normal(size=(B, 7, jcfg_.cross_attention_dim)).astype(np.float32)
    added = res = None
    if arch == "sdxl":
        added = {"text_embeds": rng.normal(size=(B, jcfg_.addition_pooled_dim)).astype(
            np.float32), "time_ids": np.ones((B, 6), np.float32)}
    else:
        cn = JaxControlNet(jcfg_)
        hint = jnp.zeros((B, 3, H * 8, W * 8))
        cp = random_params(cn, 1, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), hint)
        shapes = jax.eval_shape(cn.apply, cp, jnp.asarray(x), jnp.asarray(t),
                                jnp.asarray(ctx), hint)
        assert [tuple(s.shape) for s in shapes[0]] == _skip_shapes(jcfg_, B, H, W)[0]
        res = ([rng.normal(size=s.shape).astype(np.float32) * 0.1 for s in shapes[0]],
               rng.normal(size=shapes[1].shape).astype(np.float32) * 0.1)
    jadded = None if added is None else {k: jnp.asarray(v) for k, v in added.items()}
    jres = None if res is None else ([jnp.asarray(r) for r in res[0]], jnp.asarray(res[1]))
    jnhwc = JaxUNet(jcfg_, layout="NHWC")
    params = random_params(JaxUNet(jcfg_), 0, jnp.asarray(x), jnp.asarray(t),
                           jnp.asarray(ctx), jadded)
    want = jax.jit(lambda p, a, b, c: jnhwc.apply(p, a, b, c, jadded, residuals=jres))(
        params, x, t, ctx)
    nhwc_tree = jax.eval_shape(lambda: jnhwc.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                  jnp.asarray(t), jnp.asarray(ctx), jadded))
    sd_names = set(state_dict_from_jax(_np(params)))
    nhwc_names = set(state_dict_from_jax(jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype), {"params": nhwc_tree["params"]})))

    unet = load_jax_params(UNet2DCondition(pcfg_, layout="NHWC"), _np(params))
    ref = load_jax_params(UNet2DCondition(pcfg_), _np(params))
    assert set(unet.state_dict()) == set(ref.state_dict()) == sd_names == nhwc_names
    bad = _channels_last_everywhere(unet)
    tx, tt, tc = torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx)
    tadded = None if added is None else {k: torch.from_numpy(v) for k, v in added.items()}
    tres = None if res is None else ([torch.from_numpy(r) for r in res[0]],
                                     torch.from_numpy(res[1]))
    with torch.no_grad():
        got = unet(tx, tt, tc, tadded, residuals=tres)
        plain = ref(tx, tt, tc, tadded, residuals=tres)
    assert bad == []
    assert got.is_contiguous() and tuple(got.shape) == (B, 4, H, W)
    _close(got, want, 1e-5)
    _close(got, plain.numpy(), 1e-5)


def test_nhwc_deepcache_feature_is_channels_last(rng):
    """The DeepCache feature of an NHWC UNet is channels-last (JAX's is NHWC)
    and a read pass from it gives the write pass's output."""
    cfg = tiny_unet_config()
    unet = UNet2DCondition(cfg, layout="NHWC")
    unet.load_state_dict({k: torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(
        np.float32) * 0.2) for k, v in unet.state_dict().items()})
    x = torch.from_numpy(rng.normal(size=(1, 4, 16, 16)).astype(np.float32))
    t, ctx = torch.tensor([3.0]), torch.from_numpy(rng.normal(size=(1, 7, 16)).astype(np.float32))
    with torch.no_grad():
        out, feat = unet(x, t, ctx, cache_mode="write")
        again = unet(x, t, ctx, cache=feat.contiguous(), cache_mode="read")
    assert feat.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(again, out, rtol=0, atol=1e-6)


# -------------------------------------------------------------- GroupNorm modes


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("mode", ["fold", "chanreduce", "nhwc"])
def test_group_norm_modes_match_jax(rng, mode, dtype):
    B, C, H, W, G = 2, 32, 9, 13, 8
    x = (rng.normal(size=(B, C, H, W)) * 2 + 0.5).astype(np.float32)
    w = rng.normal(size=(C,)).astype(np.float32)
    b = rng.normal(size=(C,)).astype(np.float32)
    jd, td = (jnp.float32, torch.float32) if dtype == np.float32 else (jnp.bfloat16,
                                                                       torch.bfloat16)
    jx, tx = jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)
    if mode == "nhwc":
        want = jgn.group_norm_nhwc(jx.transpose(0, 2, 3, 1), G, w, b).transpose(0, 3, 1, 2)
        tx = tx.contiguous(memory_format=torch.channels_last)
        got = pgn.group_norm_nhwc(tx, G, torch.from_numpy(w), torch.from_numpy(b))
        assert got.is_contiguous(memory_format=torch.channels_last)
        ja, jb = jgn.group_norm_affine_nhwc(jx.transpose(0, 2, 3, 1), G, w, b)
        ta, tb = pgn.group_norm_affine_nhwc(tx, G, torch.from_numpy(w), torch.from_numpy(b))
        _close(ta, ja, 1e-5)
        _close(tb, jb, 1e-5)
    else:
        jfn = jgn.group_norm_fold if mode == "fold" else jgn.group_norm_chanreduce
        pfn = pgn.group_norm_fold if mode == "fold" else pgn.group_norm_chanreduce
        want = jfn(jx, G, w, b)
        got = pfn(tx, G, torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == td
    _close(got, np.asarray(want.astype(jnp.float32)), 1e-5 if dtype == np.float32 else BF16_STEP)
    plain = pgn.group_norm(torch.from_numpy(x), G, torch.from_numpy(w), torch.from_numpy(b))
    _close(got, plain.numpy(), 1e-5 if dtype == np.float32 else BF16_STEP)


@pytest.mark.parametrize("mode", [None, "fold", "chanreduce"])
def test_tile_group_norm_dispatches_on_mdu_gn(rng, monkeypatch, mode):
    """Without a tile context ``tile_group_norm`` runs the formulation
    ``MDU_GN`` names, as JAX's does (``mdu_tpu/ops/tile_context.py:65-78``);
    with a context, ``MDU_GN`` changes nothing."""
    if mode:
        monkeypatch.setenv("MDU_GN", mode)
    calls = []
    for name in ("group_norm", "group_norm_fold", "group_norm_chanreduce"):
        fn = getattr(ptc, name)
        monkeypatch.setattr(ptc, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    x = (rng.normal(size=(2, 16, 8, 8)) * 3).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    got = ptc.tile_group_norm(torch.from_numpy(x).to(torch.bfloat16), 4, torch.from_numpy(w),
                              None, None)
    want = jtc.tile_group_norm(jnp.asarray(x).astype(jnp.bfloat16), 4, jnp.asarray(w), None,
                               None)
    assert calls == [{None: "group_norm", "fold": "group_norm_fold",
                      "chanreduce": "group_norm_chanreduce"}[mode]]
    _close(got, np.asarray(want.astype(jnp.float32)), BF16_STEP)
    calls.clear()
    ctx = ptc.TileContext(num_tiles=2, base_hw=(8, 8))
    ptc.tile_group_norm(torch.from_numpy(x), 4, None, None, ctx)
    assert calls == []


# ------------------------------------------------------------------ conv3x3_mm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
@pytest.mark.parametrize("mode", ["9mm", "im2col"])
def test_conv3x3_mm_matches_jax(rng, mode, layout, dtype):
    """Ragged shapes (the padding arithmetic); in bf16 the taps accumulate in
    fp32, so the result is the fp32 one rounded once."""
    B, C, H, W, O = 2, 24, 9, 12, 7
    w = (rng.normal(size=(O, C, 3, 3)) * 0.2).astype(np.float32)
    x4 = rng.normal(size=(B, C, H, W)).astype(np.float32)
    x = x4 if layout == "NCHW" else x4.transpose(0, 2, 3, 1)
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                      torch.bfloat16)
    want = jconv_mm.conv3x3_mm(jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd),
                               mode=mode, layout=layout)
    got = conv3x3_mm(torch.from_numpy(np.ascontiguousarray(x)).to(td),
                     torch.from_numpy(w).to(td), mode, layout)
    assert got.dtype == td and tuple(got.shape) == tuple(want.shape)
    want = np.asarray(want.astype(jnp.float32))
    _close(got, want, 1e-5 if dtype == "float32" else BF16_STEP)
    # the fp32 conv of the same (rounded) operands, rounded once
    xr = torch.from_numpy(x4).to(td).float()
    ref = torch.nn.functional.conv2d(xr, torch.from_numpy(w).to(td).float(), padding=1)
    ref = ref if layout == "NCHW" else ref.permute(0, 2, 3, 1)
    _close(got, ref.to(td).float().numpy(), 1e-5 if dtype == "float32" else BF16_STEP)


def test_conv3x3_mm_rejects_unknown_mode_and_layout():
    x = torch.zeros(1, 4, 4, 3)
    w = torch.zeros(2, 3, 3, 3)
    with pytest.raises(ValueError, match="mode"):
        conv3x3_mm(x, w, "winograd")
    with pytest.raises(ValueError, match="layout"):
        conv3x3_mm(x, w, "9mm", "CHWN")


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("mode", ["9mm", "im2col"])
def test_conv2d_takes_conv_mm_under_the_flag(rng, monkeypatch, layout, mode):
    """``Conv2D`` takes ``conv3x3_mm`` for 'same' stride-1 3x3 kernels only,
    in its layout, with the same result as the convolution."""
    x = torch.from_numpy(rng.normal(size=(1, 6, 10, 11)).astype(np.float32))
    if layout == "NHWC":
        x = x.contiguous(memory_format=torch.channels_last)
    calls = []
    monkeypatch.setattr(layers, "conv3x3_mm", lambda *a, **k: (
        calls.append(a[3]), conv3x3_mm(*a, **k))[1])
    for kw, taken in ((dict(kernel_size=(3, 3)), True),
                      (dict(kernel_size=(1, 1), padding=0), False),
                      (dict(kernel_size=(3, 3), strides=(2, 2)), False)):
        layer = layers.Conv2D(6, 8, layout=layout, **kw)
        torch.nn.init.normal_(layer.weight, std=0.2)
        torch.nn.init.normal_(layer.bias)
        with torch.no_grad():
            plain = layer(x)
            monkeypatch.setenv("MDU_CONV_MM", mode)
            mm = layer(x)
            monkeypatch.delenv("MDU_CONV_MM")
        assert calls == ([layout] if taken else []), kw
        calls.clear()
        _close(mm, plain.numpy(), 1e-5)
        if layout == "NHWC":
            assert mm.is_contiguous(memory_format=torch.channels_last)


# ----------------------------------------------------------------- dispatch


def test_fused_conv_channel_limit_follows_the_layout(monkeypatch):
    """Under NHWC the fused conv drops NCHW's 640-channel limit (JAX
    ``layers.py:131``): 1280 -> 1280 at 16 x 24 is taken when the planner
    fits it; 2560 -> 1280 the planner does not fit in either layout."""
    monkeypatch.setenv("MDU_FUSED_CONV", "1")
    x = torch.empty(1, 1280, 16, 24, device="meta")
    for layout, want in (("NCHW", False), ("NHWC", True)):
        conv = layers.Conv2D(1280, 1280, layout=layout)
        assert conv._fused_ok(x) is want, layout
    wide = layers.Conv2D(2560, 1280, layout="NHWC")
    assert not wide._fused_ok(torch.empty(1, 2560, 16, 24, device="meta"))
    small = layers.Conv2D(320, 320, layout="NCHW")
    assert small._fused_ok(torch.empty(1, 320, 64, 96, device="meta"))
    monkeypatch.delenv("MDU_FUSED_CONV")
    assert not layers.Conv2D(1280, 1280, layout="NHWC")._fused_ok(x)


def test_nhwc_never_takes_the_fused_group_norm(rng, monkeypatch):
    """With all four kernel flags on (their plain versions on the CPU), the
    NHWC tiny UNet calls #6 on its level-0 and level-1 ResBlocks and #4 never, and
    ``MDU_CONV_MM`` takes only the convs #6 does not; the NCHW UNet under
    the same flags calls #4. Both give the plain NCHW UNet's output."""
    cfg = tiny_unet_config()
    ref = UNet2DCondition(cfg)
    ref.load_state_dict({k: torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(
        np.float32) * 0.2) for k, v in ref.state_dict().items()})
    x = torch.from_numpy(rng.normal(size=(2, 4, 16, 16)).astype(np.float32))
    t, ctx = torch.tensor([3.0, 700.0]), torch.from_numpy(
        rng.normal(size=(2, 7, 16)).astype(np.float32))
    with torch.no_grad():
        plain = ref(x, t, ctx)
    counts = {"gn": 0, "conv": 0, "mm": 0}

    def count(key, fn):
        def wrapped(*a, **k):
            counts[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(layers, "fused_group_norm", count("gn", layers.fused_group_norm))
    monkeypatch.setattr(layers, "fused_conv3x3", count("conv", layers.fused_conv3x3))
    monkeypatch.setattr(layers, "conv3x3_mm", count("mm", layers.conv3x3_mm))
    for k, v in (("MDU_FUSED_GN", "1"), ("MDU_FUSED_CONV", "1"), ("MDU_CONV_MM", "9mm")):
        monkeypatch.setenv(k, v)
    seen = {}
    for layout in ("NHWC", "NCHW"):
        unet = UNet2DCondition(cfg, layout=layout)
        unet.load_state_dict(ref.state_dict())
        for key in counts:
            counts[key] = 0
        with torch.no_grad():
            got = unet(x, t, ctx)
        seen[layout] = dict(counts)
        _close(got, plain.numpy(), 1e-5)
    # levels 0 and 1 (16 x 16, 8 x 8: H * W >= 64): 2 down + 3 up ResBlocks
    # each, two convs a ResBlock
    assert seen["NHWC"]["gn"] == 0 and seen["NHWC"]["conv"] == 20
    assert seen["NCHW"]["gn"] > 0 and seen["NCHW"]["conv"] == 20
    # every other 3x3 stride-1 conv: conv_in, conv_out, the deeper ResBlocks,
    # the upsamplers
    assert seen["NHWC"]["mm"] == seen["NCHW"]["mm"] > 0


def test_unknown_layout_raises(monkeypatch):
    import mdu_tpu.models.unet as jnet

    for bad in ("NCWH", "channels_last"):
        monkeypatch.setenv("MDU_UNET_LAYOUT", bad)
        with pytest.raises(ValueError) as jerr:
            jnet.default_unet_layout()
        with pytest.raises(ValueError) as err:
            default_unet_layout()
        assert str(err.value) == str(jerr.value)
    monkeypatch.setenv("MDU_UNET_LAYOUT", "nhwc")
    assert default_unet_layout() == jnet.default_unet_layout() == "NHWC"
    monkeypatch.delenv("MDU_UNET_LAYOUT")
    assert default_unet_layout() == "NCHW"
    with pytest.raises(ValueError, match="layout"):
        UNet2DCondition(tiny_unet_config(), layout="CHWN")
    assert flags.gn_mode() is None and flags.conv_mm_mode() is None


def test_channels_last_group_norm_refuses_pooled_and_injected_stats():
    """The tile-pooled and injected modes are the VAE's (NCHW); JAX asserts
    they never reach a channels-last GroupNorm."""
    gn = layers.GroupNorm(8, 4, layout="NHWC")
    x = torch.zeros(2, 8, 4, 4).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="per-sample"):
        gn(x, ctx=ptc.TileContext(num_tiles=2, base_hw=(4, 4)))
    with pytest.raises(ValueError, match="per-sample"):
        gn(x, stats=pgn.GroupNormStats(capture=True))
    assert dataclasses.is_dataclass(ptc.TileContext)
