"""The port's CUDA kernels against their plain PyTorch versions, on the card.

bf16 kernels are held to 2x the bf16 plain version's error (against the plain
version in fp32) + 1e-3; fp32 kernels to 1e-4 of the plain version in fp32.

Imports torch and the port only (the card's machine has no JAX). Every test
decides in its body whether a card is present and skips without one. Run:

    python -m pytest -o addopts='' -m gpu tests/test_torch_kernels_gpu.py
"""
import pytest
import torch

from mdu_tpu_torch.ops.kernels import flash

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
            "flash_attention": (flash.flash_attention, flash.flash_attention_plain)}[name]


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
    with pytest.raises(ValueError, match="D <="):
        flash.flash_attention_fm(big, big, big)
