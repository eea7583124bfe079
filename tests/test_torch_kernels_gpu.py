"""The port's CUDA kernels against their plain PyTorch versions, on the card.

bf16 kernels are held to 2x the bf16 plain version's error (against the plain
version in fp32) + 1e-3; fp32 kernels to 1e-4 of the plain version in fp32
(the tile blend's fp32 sums run in the same order: exact).

Imports torch and the port only (the card's machine has no JAX). Every test
decides in its body whether a card is present and skips without one. Run:

    python -m pytest -o addopts='' -m gpu tests/test_torch_kernels_gpu.py
"""
import pytest
import torch

from mdu_tpu_torch.ops.kernels import (LAUNCHES, BlendTable, flash, fused_conv3x3,
                                       fused_conv3x3_plain, fused_group_norm,
                                       fused_group_norm_plain, fused_tile_blend,
                                       fused_tile_blend_plain, pack_conv3x3_weight)
from mdu_tpu_torch.utils.grid import paint_count, split_grid

pytestmark = pytest.mark.gpu

CASES = [
    ("flash_attention_fm", (1, 2, 513, 513, 40)),
    ("flash_attention_fm", (1, 2, 200, 77, 64)),
    ("flash_attention_fm", (2, 8, 1536, 1536, 80)),
    ("flash_attention_fm", (1, 1, 300, 300, 160)),
    ("flash_attention_fm", (1, 1, 70, 90, 13)),       # D not a multiple of 8
    ("flash_attention", (1, 1, 1000, 1000, 512)),
    ("flash_attention", (1, 2, 200, 77, 128)),
    ("flash_attention", (1, 1, 100, 130, 300)),
    ("flash_attention_t", (1, 2, 513, 513, 40)),
    ("flash_attention_t", (1, 2, 200, 77, 64)),
    ("flash_attention_t", (2, 8, 1536, 1536, 80)),
    ("flash_attention_t", (1, 1, 300, 300, 160)),
    ("flash_attention_t", (1, 1, 70, 90, 13)),
    ("flash_attention_t", (1, 1, 40, 40, 4)),         # DP = 16
]
CASES_F32 = [
    ("flash_attention_fm", (1, 2, 513, 513, 40)),
    ("flash_attention_fm", (1, 1, 70, 90, 13)),
    ("flash_attention_fm", (1, 1, 300, 300, 160)),
    ("flash_attention", (1, 1, 1000, 1000, 512)),
    ("flash_attention", (1, 2, 200, 77, 128)),
    ("flash_attention", (1, 1, 100, 130, 300)),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _fns(name):
    return {"flash_attention_fm": (flash.flash_attention_fm, flash.flash_attention_fm_plain),
            "flash_attention": (flash.flash_attention, flash.flash_attention_plain),
            "flash_attention_t": (flash.flash_attention_t, flash.flash_attention_t_plain)}[name]


@pytest.mark.parametrize("name,shape", CASES)
def test_kernel_matches_plain(name, shape):
    dev = _card()
    B, H, Lq, Lk, D = shape
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(B, H, Lq, D, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(B, H, Lk, D, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(B, H, Lk, D, generator=gen, device=dev).to(torch.bfloat16)
    kernel, plain = _fns(name)
    before = flash.LAUNCHES[name]
    out = kernel(q, k, v)
    torch.cuda.synchronize()
    assert flash.LAUNCHES[name] == before + 1
    ref = plain(q.float(), k.float(), v.float())
    err = (out.float() - ref).abs().max().item()
    err_bf16 = (plain(q, k, v).float() - ref).abs().max().item()
    assert err <= 2 * err_bf16 + 1e-3


@pytest.mark.parametrize("name,shape", CASES_F32)
def test_f32_kernel_matches_plain(name, shape):
    dev = _card()
    B, H, Lq, Lk, D = shape
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(B, H, Lq, D, generator=gen, device=dev)
    k = torch.randn(B, H, Lk, D, generator=gen, device=dev)
    v = torch.randn(B, H, Lk, D, generator=gen, device=dev)
    kernel, plain = _fns(name)
    before = flash.LAUNCHES[name + "_f32"]
    out = kernel(q, k, v)
    torch.cuda.synchronize()
    assert flash.LAUNCHES[name + "_f32"] == before + 1
    assert out.dtype == torch.float32
    assert (out - plain(q, k, v)).abs().max().item() <= 1e-4


def test_fm_kernel_clamp_and_shift():
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(1, 1, 600, 32, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    q = q * 8
    for kw in (dict(smax=60.0), dict(smax=5.0, clamp=True)):
        out = flash.flash_attention_fm(q, k, v, **kw)
        ref = flash.flash_attention_fm_plain(q.float(), k.float(), v.float(), **kw)
        err_bf16 = (flash.flash_attention_fm_plain(q, k, v, **kw).float() - ref).abs().max()
        assert (out.float() - ref).abs().max() <= 2 * err_bf16 + 1e-3
        out32 = flash.flash_attention_fm(q.float(), k.float(), v.float(), **kw)
        assert (out32 - ref).abs().max() <= 1e-4


def test_wrappers_reject_what_the_kernels_do_not_take():
    dev = _card()
    q = torch.randn(1, 1, 64, 40, device=dev)
    for fn in (flash.flash_attention_fm, flash.flash_attention):
        with pytest.raises(ValueError, match="bfloat16 or float32"):
            fn(q.half(), q.half(), q.half())
        with pytest.raises(ValueError, match="different dtypes"):
            fn(q, q.to(torch.bfloat16), q)
        qb = q.to(torch.bfloat16)
        with pytest.raises(ValueError, match="contiguous"):
            fn(qb.transpose(2, 3), qb.transpose(2, 3), qb.transpose(2, 3))
    big = torch.zeros(1, 1, 8, 200, device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
        flash.flash_attention_fm(big, big, big)


def _close_bf16(out, ref, plain_bf16):
    err = (out.float() - ref.float()).abs().max().item()
    err_bf16 = (plain_bf16.float() - ref.float()).abs().max().item()
    assert torch.isfinite(out).all()
    assert err <= 2 * err_bf16 + 1e-3, (err, err_bf16)


def test_flash_t_routes_wide_heads_and_fp32_to_the_same_function():
    """D > 160 in bf16 runs flash_attention's kernel, fp32 the fp32 online
    kernel: both compute flash_attention_t's function."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(1, 1, 300, 512, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    before = dict(LAUNCHES)
    out = flash.flash_attention_t(q, k, v)
    q32, k32, v32 = (x.float()[..., :40].contiguous() for x in (q, k, v))
    out32 = flash.flash_attention_t(q32, k32, v32)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert LAUNCHES["flash_attention_f32"] == before["flash_attention_f32"] + 1
    assert LAUNCHES["flash_attention_t"] == before["flash_attention_t"]
    ref = flash.flash_attention_t_plain(q.float(), k.float(), v.float())
    _close_bf16(out, ref, flash.flash_attention_t_plain(q, k, v))
    assert (out32 - flash.flash_attention_t_plain(q32, k32, v32)).abs().max() <= 1e-4


def test_fm_kernel_bf16_exp():
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn(2, 2, 700, 40, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    out = flash.flash_attention_fm(q, k, v, bf16_exp=True)
    plain = flash.flash_attention_fm_plain
    ref = plain(q.float(), k.float(), v.float(), bf16_exp=True)
    # a score near a bf16 rounding boundary may round either way: the fp32
    # plain version with q.k summed in the reverse order of d measures that
    rev = plain(q.float().flip(-1).contiguous(), k.float().flip(-1).contiguous(), v.float(),
                bf16_exp=True)
    amb = (rev - ref).abs().max().item()
    err = (out.float() - ref).abs().max().item()
    err_bf16 = (plain(q, k, v, bf16_exp=True).float() - ref).abs().max().item()
    assert err <= 2 * (err_bf16 + amb) + 1e-3
    out32 = flash.flash_attention_fm(q.float(), k.float(), v.float(), bf16_exp=True)
    assert (out32 - ref).abs().max() <= 1e-4


@pytest.mark.parametrize("shape,dtype", [
    ((2, 320, 64, 96), torch.bfloat16),
    ((2, 1280, 8, 12), torch.bfloat16),
    ((1, 96, 7, 9), torch.bfloat16),          # H * W not a multiple of 8
    ((2, 320, 64, 96), torch.float32),
    ((1, 96, 7, 9), torch.float32),
])
def test_group_norm_kernel_matches_plain(shape, dtype):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(4)
    x = (torch.randn(shape, generator=gen, device=dev) * 3 + 1).to(dtype)
    w = (1 + 0.2 * torch.randn(shape[1], generator=gen, device=dev)).to(dtype)
    b = (0.2 * torch.randn(shape[1], generator=gen, device=dev)).to(dtype)
    before = LAUNCHES["fused_group_norm"]
    out = fused_group_norm(x, 32, w, b, 1e-5)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_group_norm"] == before + 1 and out.dtype == dtype
    ref = fused_group_norm_plain(x.float(), 32, w.float(), b.float(), 1e-5)
    if dtype == torch.bfloat16:
        _close_bf16(out, ref, fused_group_norm_plain(x, 32, w, b, 1e-5))
    else:
        assert (out - ref).abs().max() <= 1e-4
    # a constant group: the variance is clamped at 0, the output is the bias
    x[:, :shape[1] // 32] = 5.0
    out = fused_group_norm(x, 32, w, b, 1e-5)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[:, :shape[1] // 32].float(),
                               b[:shape[1] // 32].float()[None, :, None, None]
                               .expand_as(out[:, :shape[1] // 32]), rtol=0, atol=0)


@pytest.mark.parametrize("h,w,th,tw,ov,BC,normalize,dtype", [
    (64, 256, 64, 96, 48, 4, False, torch.float32),     # config 2
    (64, 256, 64, 96, 48, 4, True, torch.float32),
    (61, 97, 24, 24, 8, 3, True, torch.float32),
    (64, 256, 64, 96, 48, 4, True, torch.bfloat16),
])
def test_tile_blend_kernel_matches_plain(h, w, th, tw, ov, BC, normalize, dtype):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(5)
    bbs = split_grid(w, h, tw, th, ov)
    table = BlendTable(h, w, bbs)
    tiles = torch.randn(len(bbs), BC, th, tw, generator=gen, device=dev).to(dtype)
    wts = torch.as_tensor(paint_count(w, h, bbs)[0, 0], device=dev)
    before = LAUNCHES["fused_tile_blend"]
    out = fused_tile_blend(tiles, wts, h, w, bbs, normalize, table)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_tile_blend"] == before + 1 and out.dtype == dtype
    ref = fused_tile_blend_plain(tiles.float(), wts, h, w, bbs, normalize, table)
    if dtype == torch.bfloat16:
        _close_bf16(out, ref, fused_tile_blend_plain(tiles, wts, h, w, bbs, normalize, table))
    else:
        torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("B,H,W,C,Co,dtype", [
    (2, 64, 96, 320, 320, torch.bfloat16),
    (2, 32, 48, 640, 640, torch.bfloat16),
    (2, 16, 16, 24, 8, torch.bfloat16),      # tiny UNet widths
    (2, 7, 9, 12, 20, torch.bfloat16),       # odd H, W, C: no 16-byte loads
    (2, 32, 48, 320, 64, torch.float32),
    (1, 7, 9, 12, 20, torch.float32),
])
@pytest.mark.parametrize("fuse_act", [True, False])
def test_conv3x3_kernel_matches_plain(B, H, W, C, Co, dtype, fuse_act):
    dev = _card()
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(B, H, W, C, generator=gen, device=dev).to(dtype)
    w = (torch.randn(3, 3, C, Co, generator=gen, device=dev) / (9 * C) ** 0.5).to(dtype)
    a = 1 + 0.5 * torch.randn(B, C, generator=gen, device=dev)
    sh = 0.2 * torch.randn(B, C, generator=gen, device=dev)
    name = "fused_conv3x3" if dtype == torch.bfloat16 else "fused_conv3x3_f32"
    before = LAUNCHES[name]
    out = fused_conv3x3(x, w, a, sh, fuse_act=fuse_act, packed=pack_conv3x3_weight(w))
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1 and out.shape == (B, H, W, Co)
    ref = fused_conv3x3_plain(x.float(), w.float(), a, sh, fuse_act=fuse_act)
    if dtype == torch.bfloat16:
        _close_bf16(out, ref, fused_conv3x3_plain(x, w, a, sh, fuse_act=fuse_act))
    else:
        assert (out - ref).abs().max() <= 1e-4


def test_new_wrappers_reject_what_the_kernels_do_not_take():
    dev = _card()
    x = torch.randn(1, 8, 8, 8, device=dev)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        fused_group_norm(x.half(), 2, torch.ones(8, device=dev), torch.zeros(8, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        fused_group_norm(x.transpose(2, 3), 2, torch.ones(8, device=dev),
                         torch.zeros(8, device=dev))
    w = torch.randn(3, 3, 8, 4, device=dev)
    with pytest.raises(ValueError, match="scale"):
        fused_conv3x3(x, w, None, None, fuse_act=True)
    with pytest.raises(ValueError, match="packed"):
        fused_conv3x3(x, w, packed=torch.zeros(4, 9 * 8, device=dev))
    bbs = split_grid(24, 16, 16, 8, 4)
    tiles = torch.randn(len(bbs), 2, 8, 16, device=dev)
    with pytest.raises(ValueError, match="weights"):
        fused_tile_blend(tiles, torch.ones(16, 24, device=dev, dtype=torch.float64), 16, 24, bbs)
