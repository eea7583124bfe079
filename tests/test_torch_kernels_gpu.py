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
from mdu_tpu_torch.ops.kernels import conv3x3 as conv3x3_mod
from mdu_tpu_torch.config import Method
from mdu_tpu_torch.tiling.schedulers import mod_tile_weights, plan_tiled_diffusion
from mdu_tpu_torch.utils.grid import paint_count, split_grid

pytestmark = pytest.mark.gpu
torch.set_num_threads(2)

# (kernel, (B, H, Lq, Lk, D), the form the wrapper must pick; None: one form)
CASES = [
    ("flash_attention_fm", (1, 2, 513, 513, 40), "sm90"),
    ("flash_attention_fm", (1, 2, 200, 77, 64), "sm90"),
    ("flash_attention_fm", (2, 8, 1536, 1536, 80), "sm90"),
    ("flash_attention_fm", (1, 1, 300, 300, 160), "sm90"),
    ("flash_attention_fm", (1, 2, 77, 513, 80), "sm90"),     # Lq < Lk, both ragged
    ("flash_attention_fm", (1, 1, 260, 128, 16), "sm90"),    # one kv tile, DP = 16
    ("flash_attention_fm", (1, 1, 70, 90, 13), "mma"),       # D not a multiple of 8
    ("flash_attention_fm", (2, 8, 576, 576, 160), "sm90"),   # config 3's UNet level 2
    ("flash_attention_fm", (2, 8, 9216, 9216, 40), "sm90"),  # config 4's region calls, level 0
    ("flash_attention_fm", (2, 8, 2304, 2304, 80), "sm90"),  # and level 1
    ("flash_attention_fm", (4, 10, 4096, 4096, 64), "sm90"),  # config 5's SDXL level 1
    ("flash_attention_fm", (4, 20, 1024, 1024, 64), "sm90"),  # and level 2
    ("flash_attention_fm", (10, 5, 6144, 6144, 64), "sm90"),  # SD2.1-unCLIP on config 2's
    ("flash_attention_fm", (10, 10, 1536, 1536, 64), "sm90"),  # canvas, levels 0 and 1
    ("flash_attention", (1, 1, 1000, 1000, 512), "wide"),
    ("flash_attention", (1, 1, 17424, 17424, 512), "wide"),  # config 3's encoder mid-block
    ("flash_attention", (4, 1, 13924, 13924, 512), "wide"),  # config 4's decoder mid-block
    ("flash_attention", (4, 1, 7396, 7396, 512), "wide"),    # a streamed decoder group
    ("flash_attention", (1, 1, 7396, 7396, 512), "wide"),    # (config 3 and the 8K, tile 64)
    ("flash_attention", (2, 1, 17424, 17424, 512), "wide"),  # a streamed encoder group
    ("flash_attention", (2, 1, 513, 700, 512), "wide"),      # Lq, Lk off the 64 / 32 tiles
    ("flash_attention", (1, 2, 300, 300, 200), "wide"),      # D off 64: DP = 256
    ("flash_attention", (1, 1, 200, 150, 192), "wide"),
    ("flash_attention", (1, 2, 200, 77, 128), "mma"),
    ("flash_attention", (1, 1, 100, 130, 300), "mma"),       # D % 8 != 0
    ("flash_attention_t", (1, 2, 513, 513, 40), "sm90"),
    ("flash_attention_t", (1, 2, 200, 77, 64), "sm90"),
    ("flash_attention_t", (2, 8, 1536, 1536, 80), "sm90"),
    ("flash_attention_t", (1, 1, 300, 300, 160), "sm90"),
    ("flash_attention_t", (1, 2, 77, 513, 80), "sm90"),
    ("flash_attention_t", (1, 1, 260, 128, 16), "sm90"),
    ("flash_attention_t", (1, 1, 70, 90, 13), "mma"),
    ("flash_attention_t", (1, 1, 40, 40, 4), "mma"),         # DP = 16
    ("flash_attention_t", (2, 8, 9216, 9216, 40), "sm90"),   # config 4's region calls
    ("flash_attention_t", (2, 8, 2304, 2304, 80), "sm90"),
    ("flash_attention_t", (2, 8, 576, 576, 160), "sm90"),
    ("flash_attention_t", (4, 10, 4096, 4096, 64), "sm90"),   # config 5's SDXL levels
    ("flash_attention_t", (4, 20, 1024, 1024, 64), "sm90"),
]
# (kernel, (B, H, Lq, Lk, D), the fp32 form the wrapper must pick)
CASES_F32 = [
    ("flash_attention_fm", (1, 2, 513, 513, 40), "sm90"),
    ("flash_attention_fm", (2, 8, 1536, 1536, 80), "sm90"),
    ("flash_attention_fm", (1, 1, 300, 300, 160), "sm90"),
    ("flash_attention_fm", (1, 2, 77, 513, 80), "sm90"),     # Lq < Lk, both ragged
    ("flash_attention_fm", (1, 1, 260, 64, 16), "sm90"),     # one kv tile
    ("flash_attention_fm", (1, 1, 70, 90, 4), "sm90"),
    ("flash_attention_fm", (1, 1, 100, 130, 164), "wide"),
    ("flash_attention_fm", (1, 1, 1000, 1000, 512), "wide"),
    ("flash_attention_fm", (1, 1, 70, 90, 13), "simt"),      # D % 4 != 0
    ("flash_attention", (1, 2, 513, 513, 40), "sm90"),
    ("flash_attention", (1, 2, 200, 77, 128), "sm90"),
    ("flash_attention", (1, 1, 300, 300, 160), "sm90"),
    ("flash_attention", (1, 2, 77, 513, 80), "sm90"),
    ("flash_attention", (1, 1, 260, 32, 96), "sm90"),        # one kv tile, one consumer
    ("flash_attention", (1, 1, 70, 90, 4), "sm90"),
    ("flash_attention", (1, 1, 100, 130, 164), "wide"),
    ("flash_attention", (1, 1, 100, 130, 300), "wide"),
    ("flash_attention", (1, 1, 1000, 1000, 512), "wide"),
    ("flash_attention", (1, 1, 70, 90, 13), "simt"),
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


@pytest.mark.parametrize("name,shape,form", CASES)
def test_kernel_matches_plain(name, shape, form):
    dev = _card()
    B, H, Lq, Lk, D = shape
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(B, H, Lq, D, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(B, H, Lk, D, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(B, H, Lk, D, generator=gen, device=dev).to(torch.bfloat16)
    kernel, plain = _fns(name)
    before = dict(flash.LAUNCHES)
    out = kernel(q, k, v)
    torch.cuda.synchronize()
    assert flash.LAUNCHES[name] == before[name] + 1
    if form is not None:
        assert flash.LAUNCHES[f"{name}.{form}"] == before[f"{name}.{form}"] + 1
    ref = plain(q.float(), k.float(), v.float())
    err = (out.float() - ref).abs().max().item()
    err_bf16 = (plain(q, k, v).float() - ref).abs().max().item()
    assert err <= 2 * err_bf16 + 1e-3


@pytest.mark.parametrize("name,shape,form", CASES_F32)
def test_f32_kernel_matches_plain(name, shape, form):
    dev = _card()
    B, H, Lq, Lk, D = shape
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(B, H, Lq, D, generator=gen, device=dev)
    k = torch.randn(B, H, Lk, D, generator=gen, device=dev)
    v = torch.randn(B, H, Lk, D, generator=gen, device=dev)
    kernel, plain = _fns(name)
    before = dict(flash.LAUNCHES)
    out = kernel(q, k, v)
    torch.cuda.synchronize()
    assert flash.LAUNCHES[name + "_f32"] == before[name + "_f32"] + 1
    assert flash.LAUNCHES[f"{name}_f32.{form}"] == before[f"{name}_f32.{form}"] + 1
    assert out.dtype == torch.float32
    assert (out - plain(q, k, v)).abs().max().item() <= 1e-4


@pytest.mark.parametrize("name", ["flash_attention_fm", "flash_attention"])
@pytest.mark.parametrize("shape,form", [
    ((10, 8, 6144, 40), "sm90"), ((10, 8, 1536, 80), "sm90"), ((2, 1, 9600, 512), "wide")])
def test_f32_forms_hold_a_sharp_softmax(name, shape, form):
    """The fp32 tensor-core forms at the main path's shapes with q x 3
    (scores of std 3: a sharp softmax and a large |O|), within 1e-4 of the
    fp32 plain version: O's accumulation cannot drift over a long kv."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(13)
    q, k, v = (torch.randn(shape, generator=gen, device=dev) for _ in range(3))
    q = q * 3
    kernel, plain = _fns(name)
    before = LAUNCHES[f"{name}_f32.{form}"]
    out = kernel(q, k, v)
    torch.cuda.synchronize()
    assert LAUNCHES[f"{name}_f32.{form}"] == before + 1
    assert (out - plain(q, k, v)).abs().max().item() <= 1e-4


@pytest.mark.parametrize("D,form", [(40, "sm90"), (80, "sm90"), (512, "wide")])
@pytest.mark.parametrize("kw,qscale", [
    (dict(smax=5.0, clamp=True), 4.0),            # scores above smax flattened
    (dict(smax=60.0, clamp=True), 1.0),
    (dict(bf16_exp=True), 1.0),
    (dict(bf16_exp=True, smax=5.0, clamp=True), 4.0),
])
def test_f32_fm_options_match_plain(D, form, kw, qscale):
    """clamp and bf16_exp on the fp32 tensor-core forms, within 1e-4 of the
    fp32 plain version. With bf16_exp, q and k are small integers: q.k is
    then exact in both (the split of an integer is exact), so no score can
    round to another bf16 on one side than on the other."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(11)
    q, k, v = (torch.randn(1, 2, 600, D, generator=gen, device=dev) for _ in range(3))
    if kw.get("bf16_exp"):
        q, k = (torch.randint(-2, 3, (1, 2, 600, D), generator=gen, device=dev).float()
                for _ in range(2))
    q = q * qscale
    before = LAUNCHES[f"flash_attention_fm_f32.{form}"]
    out = flash.flash_attention_fm(q, k, v, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES[f"flash_attention_fm_f32.{form}"] == before + 1
    assert torch.isfinite(out).all()
    assert (out - flash.flash_attention_fm_plain(q, k, v, **kw)).abs().max().item() <= 1e-4


@pytest.mark.parametrize("name", ["flash_attention_fm", "flash_attention"])
def test_unaligned_f32_takes_the_simt_form(name):
    """fp32 inputs off a 16-byte boundary cannot carry a tensor map: the
    CUDA-core form takes them, by the wrapper's rule."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(12)
    n = 1 * 2 * 300 * 40
    q, k, v = (torch.randn(n + 1, generator=gen, device=dev)[1:].view(1, 2, 300, 40)
               for _ in range(3))
    assert flash.f32_form(name + "_f32", q, k, v) == "simt"
    kernel, plain = _fns(name)
    before = LAUNCHES[f"{name}_f32.simt"]
    out = kernel(q, k, v)
    torch.cuda.synchronize()
    assert LAUNCHES[f"{name}_f32.simt"] == before + 1
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
    big = torch.zeros(1, 1, 8, 520, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D <= 512"):
        flash.flash_attention_fm(big, big, big)


@pytest.mark.parametrize("form", ["wide", "wide_mma"])
@pytest.mark.parametrize("bf16_exp", [False, True])
def test_fm_wide_heads_match_plain(bf16_exp, form):
    """fm / fm16 on the VAE's D = 512 in bf16, against the plain version, in
    both wide forms: the warpgroup kernel (what the wrapper picks for these
    inputs) and the fixed shift on the split-D mma.sync kernel (launched by
    name), with clamp too. With bf16_exp, q and k are small integers and the
    scale a power of two: every score is then exact in any summation order,
    so no shifted score can round to another bf16 in the kernel than in the
    plain version."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn(1, 1, 1000, 512, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    scale = None
    if bf16_exp:
        q, k = _exact_qk(gen, q.shape)
        scale = 2.0 ** -5                           # D^-0.5 rounded down
    assert flash.bf16_form("flash_attention_fm", q, k, v) == "wide"
    for kw in ({"bf16_exp": bf16_exp, "scale": scale},
               {"bf16_exp": bf16_exp, "scale": scale, "smax": 2.0, "clamp": True}):
        before = dict(LAUNCHES)
        if form == "wide":
            out = flash.flash_attention_fm(q, k, v, **kw)
        else:
            out = flash.launch_form("flash_attention_fm", form, q, k, v, **kw)
        torch.cuda.synchronize()
        assert LAUNCHES["flash_attention_fm"] == before["flash_attention_fm"] + 1
        assert LAUNCHES[f"flash_attention_fm.{form}"] == before[f"flash_attention_fm.{form}"] + 1
        assert LAUNCHES["flash_attention"] == before["flash_attention"]
        _check_fm(q, k, v, out, **kw)


def _exact_qk(gen, shape):
    """q and k as bf16 integers in [-2, 2]: q.k is exact in fp32."""
    return tuple(torch.randint(-2, 3, shape, generator=gen, device=gen.device)
                 .to(torch.bfloat16) for _ in range(2))


def _check_fm(q, k, v, out, **kw):
    """The fixed-shift kernel's bar: 2x the bf16 plain version's error + 1e-3;
    with bf16_exp, plus the plain version's own change when q.k is summed in
    the other order of d (a score near a bf16 rounding boundary may round
    either way)."""
    plain = flash.flash_attention_fm_plain
    ref = plain(q.float(), k.float(), v.float(), **kw)
    err_bf16 = (plain(q, k, v, **kw).float() - ref).abs().max().item()
    if kw.get("bf16_exp"):
        rev = plain(q.float().flip(-1).contiguous(), k.float().flip(-1).contiguous(),
                    v.float(), **kw)
        err_bf16 += (rev - ref).abs().max().item()
    assert torch.isfinite(out).all()
    err = (out.float() - ref).abs().max().item()
    assert err <= 2 * err_bf16 + 1e-3, (err, err_bf16)


@pytest.mark.parametrize("D", [40, 80])
@pytest.mark.parametrize("kw,qscale", [
    ({}, 1.0),
    (dict(smax=5.0, clamp=True), 4.0),            # scores above smax flattened
    (dict(smax=60.0, clamp=True), 1.0),
    (dict(bf16_exp=True), 1.0),
    (dict(bf16_exp=True, smax=5.0, clamp=True), 4.0),
    ({}, "30"),                                   # logits near +-30
])
def test_sm90_fm_options_match_plain(D, kw, qscale):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(8)
    q, k, v = (torch.randn(1, 2, 700, D, generator=gen, device=dev) for _ in range(3))
    if qscale == "30":
        # each query row along one key's direction: that logit is about +30,
        # its negative -30
        k[:, :, :2] = torch.nn.functional.normalize(k[:, :, :2], dim=-1) * D ** 0.25 * 30 ** 0.5
        q[:, :, :350] = k[:, :, :1].expand(-1, -1, 350, -1)
        q[:, :, 350:] = -k[:, :, 1:2].expand(-1, -1, 350, -1)
    else:
        q = q * qscale
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    before = LAUNCHES["flash_attention_fm.sm90"]
    out = flash.flash_attention_fm(q, k, v, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_fm.sm90"] == before + 1
    _check_fm(q, k, v, out, **kw)


@pytest.mark.parametrize("name,D", [("flash_attention_fm", 40), ("flash_attention_t", 40),
                                    ("flash_attention", 512), ("flash_attention_fm", 512)])
def test_unaligned_inputs_take_the_mma_form(name, D):
    """A base that is not 16-byte aligned cannot carry a tensor map: the
    mma.sync form takes it (at D = 512 the split-D kernel: #1's wide_mma), by
    the wrapper's rule and not on a failure."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(9)
    n = 1 * 2 * 300 * D
    q, k, v = (torch.randn(n + 1, generator=gen, device=dev).to(torch.bfloat16)[1:]
               .view(1, 2, 300, D) for _ in range(3))
    form = "wide_mma" if name == "flash_attention_fm" and D > 160 else "mma"
    assert flash.bf16_form(name, q, k, v) == form
    kernel, plain = _fns(name)
    before = dict(LAUNCHES)
    out = kernel(q, k, v)
    torch.cuda.synchronize()
    assert LAUNCHES[f"{name}.{form}"] == before[f"{name}.{form}"] + 1
    ref = plain(q.float(), k.float(), v.float())
    _close_bf16(out, ref, plain(q, k, v))


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
    """bf16_exp on the mma.sync form at D = 40 (launched by name: the wrapper
    sends these aligned inputs to the warpgroup form), and on the fp32 kernel."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn(2, 2, 700, 40, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    before = LAUNCHES["flash_attention_fm.mma"]
    out = flash.launch_form("flash_attention_fm", "mma", q, k, v, bf16_exp=True)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_fm.mma"] == before + 1
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


@pytest.mark.parametrize("D,unaligned", [(13, False), (40, True)])
def test_fm_bf16_exp_takes_the_mma_form_by_rule(D, unaligned):
    """bf16_exp where the wrapper's rule picks the mma.sync form: a head with
    D % 8 != 0, and inputs that are not 16-byte aligned."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(10)
    n = 1 * 2 * 700 * D
    q, k, v = (torch.randn(n + int(unaligned), generator=gen, device=dev)
               .to(torch.bfloat16)[int(unaligned):].view(1, 2, 700, D) for _ in range(3))
    assert flash.bf16_form("flash_attention_fm", q, k, v) == "mma"
    before = dict(LAUNCHES)
    out = flash.flash_attention_fm(q, k, v, bf16_exp=True)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_fm"] == before["flash_attention_fm"] + 1
    assert LAUNCHES["flash_attention_fm.mma"] == before["flash_attention_fm.mma"] + 1
    _check_fm(q, k, v, out, bf16_exp=True)


@pytest.mark.parametrize("shape,dtype,form", [
    ((2, 320, 64, 96), torch.bfloat16, "two_read"),
    ((2, 1280, 8, 12), torch.bfloat16, "two_read"),
    ((1, 96, 7, 9), torch.bfloat16, "two_read"),        # H * W not a multiple of 8
    ((2, 320, 64, 96), torch.float32, "two_read"),
    ((10, 320, 64, 96), torch.bfloat16, "cluster"),     # config 2's level 0
    ((10, 320, 64, 96), torch.float32, "cluster"),      # 240 KB a group: a cluster of 8
    ((10, 960, 64, 96), torch.bfloat16, "cluster"),     # 45 KB parts
    ((10, 416, 67, 93), torch.bfloat16, "cluster"),     # ragged, 8 parts: groups off 16-byte lines
    ((1, 96, 7, 9), torch.float32, "two_read"),
    ((1, 416, 128, 256), torch.float32, "two_read"),    # 1.7 MB a group: past what a cluster holds
    ((2, 320, 96, 96), torch.bfloat16, "two_read"),     # config 4's region calls, level 0
    ((2, 640, 48, 48), torch.bfloat16, "two_read"),     # and level 1
    ((4, 320, 128, 128), torch.bfloat16, "cluster"),    # config 5's norm_out (42 MB)
    ((4, 2560, 32, 32), torch.bfloat16, "two_read"),    # its widest up-block concat
])
def test_group_norm_kernel_matches_plain(shape, dtype, form):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(4)
    x = (torch.randn(shape, generator=gen, device=dev) * 3 + 1).to(dtype)
    w = (1 + 0.2 * torch.randn(shape[1], generator=gen, device=dev)).to(dtype)
    b = (0.2 * torch.randn(shape[1], generator=gen, device=dev)).to(dtype)
    before = dict(LAUNCHES)
    out = fused_group_norm(x, 32, w, b, 1e-5)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_group_norm"] == before["fused_group_norm"] + 1 and out.dtype == dtype
    assert (LAUNCHES[f"fused_group_norm.{form}"]
            == before[f"fused_group_norm.{form}"] + 1)
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


@pytest.mark.parametrize("shape,dtype", [
    ((1, 96, 7, 9), torch.bfloat16),      # one CTA, parts off 16-byte lines
    ((2, 1280, 8, 12), torch.bfloat16),   # one CTA a group
    ((2, 640, 32, 48), torch.bfloat16),   # two
    ((3, 96, 7, 9), torch.float32),
])
def test_group_norm_cluster_form_at_any_split(shape, dtype):
    """The cluster form, launched where the rule picks two_read (small
    tensors), at clusters of one and two CTAs and ragged parts."""
    from mdu_tpu_torch.ops.kernels import group_norm as gn_mod

    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(6)
    x = (torch.randn(shape, generator=gen, device=dev) * 3 + 1).to(dtype)
    w = (1 + 0.2 * torch.randn(shape[1], generator=gen, device=dev)).to(dtype)
    b = (0.2 * torch.randn(shape[1], generator=gen, device=dev)).to(dtype)
    before = LAUNCHES["fused_group_norm.cluster"]
    out = gn_mod.launch_form("cluster", x, 32, w, b, 1e-5)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_group_norm.cluster"] == before + 1
    ref = fused_group_norm_plain(x.float(), 32, w.float(), b.float(), 1e-5)
    if dtype == torch.bfloat16:
        _close_bf16(out, ref, fused_group_norm_plain(x, 32, w, b, 1e-5))
    else:
        assert (out - ref).abs().max() <= 1e-4


@pytest.mark.parametrize("h,w,th,tw,ov,BC,normalize,dtype", [
    (64, 256, 64, 96, 48, 4, False, torch.float32),     # config 2
    (64, 256, 64, 96, 48, 4, True, torch.float32),
    (61, 97, 24, 24, 8, 3, True, torch.float32),
    (64, 256, 64, 96, 48, 4, True, torch.bfloat16),
    (192, 192, 96, 96, 48, 4, False, torch.float32),    # config 4: 9 tiles of 96
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


@pytest.mark.parametrize("h,w,BC", [(256, 256, 4), (40, 56, 3)])
def test_tile_blend_kernel_on_mod_weighted_tiles(h, w, BC):
    """Mixture of Diffusers: tiles pre-weighted by gaussian x 1 / sum(weights)
    (config 3's 256^2 canvas, 9 tiles of 96 at overlap 8, first), summed
    raw; the same order of fp32 sums: exact."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(6)
    tile = 96 if h == 256 else 16
    plan = plan_tiled_diffusion(Method.MIX_DIFF, h, w, tile, tile, 8, tile_bs=8)
    ptw = torch.as_tensor(mod_tile_weights(plan), device=dev)
    tiles = torch.randn(len(plan.bboxes), BC, tile, tile, generator=gen, device=dev)
    tiles = tiles * ptw[:, None]
    wts = torch.as_tensor(plan.weights[0, 0], device=dev)
    table = BlendTable(h, w, plan.bboxes)
    before = LAUNCHES["fused_tile_blend"]
    out = fused_tile_blend(tiles, wts, h, w, plan.bboxes, False, table)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_tile_blend"] == before + 1
    ref = fused_tile_blend_plain(tiles, wts, h, w, plan.bboxes, False, table)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    # a constant field comes back: the weights sum to 1 on every pixel
    ones = fused_tile_blend(ptw[:, None].expand(-1, BC, -1, -1).contiguous(), wts, h, w,
                            plan.bboxes, False, table)
    torch.testing.assert_close(ones, torch.ones_like(ones), rtol=0, atol=1e-5)


@pytest.mark.parametrize("B,H,W,C,Co,dtype,form", [
    (2, 64, 96, 320, 320, torch.bfloat16, "sm90"),   # config 2's four widths
    (2, 64, 96, 640, 320, torch.bfloat16, "sm90"),
    (2, 32, 48, 320, 640, torch.bfloat16, "sm90"),
    (2, 32, 48, 640, 640, torch.bfloat16, "sm90"),
    (2, 45, 21, 128, 200, torch.bfloat16, "sm90"),   # H, W, Co off the 32 x 8 x 160 tile
    (1, 7, 9, 64, 24, torch.bfloat16, "sm90"),       # one partial tile and box
    (1, 7, 9, 64, 20, torch.bfloat16, "mma"),        # Co % 8 != 0
    (2, 16, 16, 24, 8, torch.bfloat16, "mma"),       # tiny UNet widths
    (2, 7, 9, 12, 20, torch.bfloat16, "mma"),        # odd H, W, C: no 16-byte loads
    (2, 96, 96, 320, 320, torch.bfloat16, "sm90"),   # config 4's region calls, level 0
    (2, 48, 48, 640, 640, torch.bfloat16, "sm90"),   # and level 1
    (4, 128, 128, 320, 320, torch.bfloat16, "sm90"),  # config 5's level 0
    (2, 8, 12, 1280, 1280, torch.bfloat16, "sm90"),  # config 2 under NHWC: above 640
    (2, 16, 24, 1280, 1280, torch.bfloat16, "sm90"),  # channels (JAX drops NCHW's limit)
    (2, 16, 24, 640, 1280, torch.bfloat16, "sm90"),
    (2, 32, 48, 960, 640, torch.bfloat16, "sm90"),
    (2, 32, 48, 1280, 640, torch.bfloat16, "sm90"),
    (2, 64, 96, 320, 320, torch.float32, "sm90"),   # config 2's four widths
    (2, 64, 96, 640, 320, torch.float32, "sm90"),
    (2, 32, 48, 320, 640, torch.float32, "sm90"),
    (2, 32, 48, 640, 640, torch.float32, "sm90"),
    (2, 32, 48, 320, 64, torch.float32, "sm90"),
    (2, 45, 21, 128, 200, torch.float32, "sm90"),    # H, W, Co off the 32 x 8 x 80 tile
    (1, 7, 9, 48, 24, torch.float32, "sm90"),        # one partial tile and box
    (1, 7, 9, 64, 20, torch.float32, "simt"),        # Co % 8 != 0
    (1, 7, 9, 12, 20, torch.float32, "simt"),        # tiny UNet widths
])
@pytest.mark.parametrize("fuse_act", [True, False])
def test_conv3x3_kernel_matches_plain(B, H, W, C, Co, dtype, form, fuse_act):
    dev = _card()
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(B, H, W, C, generator=gen, device=dev).to(dtype)
    w = (torch.randn(3, 3, C, Co, generator=gen, device=dev) / (9 * C) ** 0.5).to(dtype)
    a = 1 + 0.5 * torch.randn(B, C, generator=gen, device=dev)
    sh = 0.2 * torch.randn(B, C, generator=gen, device=dev)
    name = "fused_conv3x3" if dtype == torch.bfloat16 else "fused_conv3x3_f32"
    before = dict(LAUNCHES)
    out = fused_conv3x3(x, w, a, sh, fuse_act=fuse_act, packed=pack_conv3x3_weight(w))
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before[name] + 1 and out.shape == (B, H, W, Co)
    if form is not None:
        assert LAUNCHES[f"{name}.{form}"] == before[f"{name}.{form}"] + 1
    ref = fused_conv3x3_plain(x.float(), w.float(), a, sh, fuse_act=fuse_act)
    if dtype == torch.bfloat16:
        _close_bf16(out, ref, fused_conv3x3_plain(x, w, a, sh, fuse_act=fuse_act))
    else:
        assert (out - ref).abs().max() <= 1e-4


@pytest.mark.parametrize("C,unaligned", [(12, False), (24, False), (64, True)])
def test_conv3x3_takes_the_mma_form_by_rule(C, unaligned):
    """C = 12 and 24 (the tiny UNet) and an x off a 16-byte boundary go to the
    mma.sync form, by the wrapper's rule and not on a failure, and match the
    plain version there."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(7)
    B, H, W, Co = 2, 9, 11, 40
    n = B * H * W * C
    base = torch.randn(n + 1, generator=gen, device=dev).to(torch.bfloat16)
    x = (base[1:] if unaligned else base[:n]).view(B, H, W, C)
    assert (x.data_ptr() % 16 != 0) == unaligned
    w = (torch.randn(3, 3, C, Co, generator=gen, device=dev) / (9 * C) ** 0.5).to(torch.bfloat16)
    a = 1 + 0.5 * torch.randn(B, C, generator=gen, device=dev)
    sh = 0.2 * torch.randn(B, C, generator=gen, device=dev)
    packed = pack_conv3x3_weight(w)
    assert conv3x3_mod.conv_form(x, packed, a, sh) == "mma"
    before = LAUNCHES["fused_conv3x3.mma"]
    out = fused_conv3x3(x, w, a, sh, fuse_act=True, packed=packed)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_conv3x3.mma"] == before + 1
    ref = fused_conv3x3_plain(x.float(), w.float(), a, sh, fuse_act=True)
    _close_bf16(out, ref, fused_conv3x3_plain(x, w, a, sh, fuse_act=True))


@pytest.mark.parametrize("C,unaligned", [(12, False), (24, False), (64, True)])
def test_conv3x3_f32_takes_the_simt_form_by_rule(C, unaligned):
    """In fp32, C = 12 and 24 (the tiny UNet) and an x off a 16-byte boundary
    go to the CUDA-core form, by the wrapper's rule and not on a failure,
    and match the plain version there within 1e-4."""
    dev = _card()
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(8)
    B, H, W, Co = 2, 9, 11, 40
    n = B * H * W * C
    base = torch.randn(n + 1, generator=gen, device=dev)
    x = (base[1:] if unaligned else base[:n]).view(B, H, W, C)
    assert (x.data_ptr() % 16 != 0) == unaligned
    w = torch.randn(3, 3, C, Co, generator=gen, device=dev) / (9 * C) ** 0.5
    a = 1 + 0.5 * torch.randn(B, C, generator=gen, device=dev)
    sh = 0.2 * torch.randn(B, C, generator=gen, device=dev)
    packed = pack_conv3x3_weight(w)
    assert conv3x3_mod.conv_f32_form(x, packed, a, sh) == "simt"
    before = LAUNCHES["fused_conv3x3_f32.simt"]
    out = fused_conv3x3(x, w, a, sh, fuse_act=True, packed=packed)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_conv3x3_f32.simt"] == before + 1
    ref = fused_conv3x3_plain(x, w, a, sh, fuse_act=True)
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


@pytest.mark.parametrize("mode", ["stream-host", "stream-device"])
def test_streamed_decode_matches_lockstep(mode):
    """The SD VAE at full width, random weights: a [1, 4, 64, 64] latent at
    tile 24 (4 tiles of 46, 2116 tokens at the mid-block) in groups of 2,
    bf16, streamed against lockstep, both held to 2x the bf16 lockstep's
    error against the fp32 lockstep + 1e-3 of its largest value; #2 runs
    once for each group at the attention segment."""
    from mdu_tpu_torch.models import AutoencoderKL, VAEConfig, random_state_dict
    from mdu_tpu_torch.tiling.streaming_vae import streaming_tiled_vae
    from mdu_tpu_torch.tiling.tiled_vae import tiled_vae_decode

    dev = _card()
    sd = random_state_dict(AutoencoderKL(VAEConfig()), 1, torch.float32, dev)
    vaes = {}
    for dtype in (torch.float32, torch.bfloat16):
        vaes[dtype] = AutoencoderKL(VAEConfig(), dtype=dtype).to(dev).eval()
        vaes[dtype].load_state_dict({k: v.to(dtype) for k, v in sd.items()})
    z = torch.randn(1, 4, 64, 64, generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev)
    with torch.inference_mode():
        ref = tiled_vae_decode(vaes[torch.float32], z, tile_size=24).float()
        lock = tiled_vae_decode(vaes[torch.bfloat16], z, tile_size=24).float()
        before = flash.LAUNCHES["flash_attention"]
        got = streaming_tiled_vae(vaes[torch.bfloat16], z, "decoder", 24, group_size=2,
                                  host_resident=(mode == "stream-host"))
        torch.cuda.synchronize()
    assert flash.LAUNCHES["flash_attention"] - before == 2
    assert got.dtype == torch.bfloat16 and got.shape == (1, 3, 512, 512)
    tol = 2 * (lock - ref).abs().max().item() + 1e-3 * ref.abs().max().item()
    assert (got.float() - ref).abs().max().item() <= tol


def test_tiny_deepcache_txt2img_matches_cpu():
    """The tiny pipeline (random weights drawn on the CPU) under DeepCache
    N = 2: MultiDiffusion over a 32 x 64 latent (tiles of 32: 1024 tokens at
    level 0, a flash kernel), Euler 4 steps, on the card in fp32 against the
    CPU, within 1e-4 of the largest value; the cached steps launch #1 too."""
    from mdu_tpu_torch import DiffusionPipeline, SamplerConfig, TiledDiffusionConfig
    from mdu_tpu_torch.models import (AutoencoderKL, UNet2DCondition, random_state_dict,
                                      tiny_unet_config, tiny_vae_config)

    dev = _card()
    gen = torch.Generator().manual_seed(5)
    c = {"crossattn": torch.randn(1, 7, 16, generator=gen) * 0.1}
    u = {"crossattn": torch.randn(1, 7, 16, generator=gen) * 0.1}
    noise = torch.randn(1, 4, 32, 64, generator=gen)
    td = TiledDiffusionConfig(tile_w=32, tile_h=32, overlap=16, tile_bs=3)
    out = {}
    for device in ("cpu", dev):
        unet = UNet2DCondition(tiny_unet_config())
        unet.load_state_dict(random_state_dict(unet, 0, device="cpu"))
        pipe = DiffusionPipeline(unet, AutoencoderKL(tiny_vae_config()), device=device)
        before = flash.LAUNCHES["flash_attention_fm_f32"]
        out[str(device)] = pipe._txt2img_from_noise(
            noise, c, u, SamplerConfig(steps=4, deepcache=2), 0, td, decode=False).latents.cpu()
        if device != "cpu":
            # 2 full calls x 5 level-0 attentions + 2 cached calls x 5
            assert flash.LAUNCHES["flash_attention_fm_f32"] - before == 20
    ref = out["cpu"]
    assert (out[str(dev)] - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


# (kernel, (B, H, Lq, Lk, D)) of the backward kernel: the train step's UNet
# levels at SD1.5's 512^2 (4096 tokens at D = 40, 1024 at 80), SD2 / SDXL's
# D = 64, the widest head (160), ragged Lq != Lk, D off 16 and a lone tile
BWD_CASES = [("flash_attention_fm", (2, 8, 4096, 4096, 40)),
             ("flash_attention_fm", (2, 8, 1024, 1024, 80)),
             ("flash_attention", (2, 10, 1024, 1024, 64)),
             ("flash_attention_t", (2, 8, 576, 576, 160)),
             ("flash_attention_fm", (1, 3, 1000, 777, 40)),
             ("flash_attention_t", (1, 2, 77, 513, 13)),
             ("flash_attention", (1, 1, 40, 30, 4))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,shape", BWD_CASES)
def test_backward_kernel_matches_autograd_of_the_plain_version(name, shape, dtype):
    """The gradient through each wrapper on the card (one backward launch)
    against autograd through the fp32 plain version: fp32 within 1e-4 of the
    largest gradient, bf16 within 2x the bf16 plain version's error + 1e-3 of
    it."""
    dev = _card()
    B, H, Lq, Lk, D = shape
    gen = torch.Generator(device=dev).manual_seed(1)
    base = [torch.randn(B, H, L, D, generator=gen, device=dev) for L in (Lq, Lk, Lk)]
    do = torch.randn(B, H, Lq, D, generator=gen, device=dev)
    kernel, plain = _fns(name)

    def grads(fn, dt):
        ts = [x.to(dt).requires_grad_() for x in base]
        return torch.autograd.grad(fn(*ts), ts, do.to(dt))

    ref = grads(plain, torch.float32)
    before = flash.LAUNCHES["flash_attention_bwd"]
    got = grads(kernel, dtype)
    torch.cuda.synchronize()
    assert flash.LAUNCHES["flash_attention_bwd"] == before + 1
    own = grads(plain, dtype) if dtype == torch.bfloat16 else None
    for i, (g, r) in enumerate(zip(got, ref)):
        scale = r.abs().max().item()
        err = (g.float() - r).abs().max().item()
        if dtype == torch.float32:
            assert err <= 1e-4 * scale, (i, err, scale)
        else:
            assert err <= 2 * (own[i].float() - r).abs().max().item() + 1e-3 * scale


def test_backward_kernel_refuses_wide_heads_and_the_clamp():
    dev = _card()
    q = torch.randn(1, 1, 600, 512, device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP item 28"):
        flash.flash_attention(q, q, q)
    q = torch.randn(1, 1, 600, 40, device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError, match="clamp"):
        flash.flash_attention_fm(q, q, q, clamp=True)
    with torch.no_grad():                 # no gradient asked: the forward runs
        assert flash.flash_attention_fm(q, q, q, clamp=True).shape == q.shape


def test_kernels_without_a_backward_raise_under_grad():
    """#4, #5 and #6 raise where autograd would need their gradient (they
    used to hand back a tensor without one); under no_grad they run."""
    dev = _card()
    x = torch.randn(2, 64, 16, 16, device=dev, requires_grad=True)
    w, b = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    with pytest.raises(NotImplementedError, match="MDU_FUSED_GN"):
        fused_group_norm(x, 32, w, b)
    xh = torch.randn(2, 16, 16, 64, device=dev, requires_grad=True)
    wh = torch.randn(3, 3, 64, 64, device=dev)
    with pytest.raises(NotImplementedError, match="MDU_FUSED_CONV"):
        fused_conv3x3(xh, wh)
    bboxes = split_grid(32, 32, 16, 16, 8)
    tiles = torch.randn(len(bboxes), 4, 16, 16, device=dev, requires_grad=True)
    weights = torch.as_tensor(paint_count(32, 32, bboxes)[0, 0], device=dev)
    with pytest.raises(NotImplementedError, match="MDU_FUSED_BLEND"):
        fused_tile_blend(tiles, weights, 32, 32, bboxes)
    with torch.no_grad():
        assert fused_group_norm(x, 32, w, b).shape == x.shape
