#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``mdu_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases kernels,reference,txt2img]

Phases, one JSON line each (all of them unless ``--phases`` names some;
``device`` and ``build`` always run):

1. ``device``    the card's name and count; the ``nvidia-smi`` name and power
                 limit line is printed as it is.
2. ``build``     builds every CUDA kernel from ``mdu_tpu_torch/csrc`` (one
                 nvcc per source, in parallel), with the ptxas register and
                 shared-memory lines.
3. ``kernels``   each bf16 kernel at its config-2 shapes and one ragged shape,
                 held against its plain PyTorch version run in fp32 on the
                 same inputs: the kernel's max abs error must stay within 2x
                 the bf16 plain version's error + 1e-3. Each fp32 kernel at
                 the first config-2 shape, within 1e-4 of its plain version.
                 Times from CUDA events: kernel, plain version, and one
                 PyTorch call that computes the same function as a yardstick
                 only (the port never calls it): ``F.scaled_dot_product_attention``
                 for attention, ``F.group_norm`` for GroupNorm, cuDNN's
                 ``F.conv2d`` on the pre-activated input for the fused conv
                 ("conv alone": no one call computes the fused function),
                 none for the tile blend. Bounds: max(flops / peak, bytes /
                 3.35 TB/s), peak 989 TF/s in bf16 and 67 TF/s in fp32, bytes
                 = each input read once and each output written once.
4. ``reference`` a tiny pipeline, sized so that its attention reaches the
                 flash kernels, on the card against the same pipeline on the
                 CPU: fp32 within 1e-4 of the largest value; bf16 within 2x
                 the CPU bf16 run's error against CPU fp32, + 1e-3 of it.
                 Once with no flag (the fm kernel must launch) and once with
                 MDU_FLASH=trans MDU_FUSED_GN=1 MDU_FUSED_CONV=1
                 MDU_FUSED_BLEND=1 (each flagged kernel must launch; in fp32
                 the trans attention is flash_attention_f32's kernel).
5. ``txt2img``   config 2 through ``DiffusionPipeline.txt2img``: SD1.5 UNet and
                 VAE with random bf16 weights, MultiDiffusion at 2048 x 512
                 (tile 96, overlap 48, tile_bs 8), Euler 20 steps at CFG 7,
                 exact tiled decode (tile 128); 1 warm and 2 timed images,
                 with no flag and then with the four flags. Launch counts are
                 set to 0 just before each image and read just after; each
                 kernel's launches per image must equal the pinned count
                 (and a kernel of the path launched 0 times fails the run).

Then a ``done`` line with the script's seconds, a ``{"kernels": [...]}`` line
(every kernel of the port), the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that.
TF32 is off for matmuls and convolutions.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12       # H100 SXM fp32 on the CUDA cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
F32_TOL = 1e-4                # fp32 kernels against their plain versions
CFG2 = dict(width=2048, height=512, steps=20, cfg=7.0, tile=96, overlap=48,
            tile_bs=8, decoder_tile=128)
FLAGS = {"MDU_FLASH": "trans", "MDU_FUSED_GN": "1", "MDU_FUSED_CONV": "1",
         "MDU_FUSED_BLEND": "1"}
# launches per config-2 image; every other kernel must launch 0 times
EXPECTED_LAUNCHES = {"flash_attention_fm": 200, "flash_attention": 1}
EXPECTED_FLAGGED = {"flash_attention_t": 200, "flash_attention": 1,
                    "fused_group_norm": 340, "fused_conv3x3": 320,
                    "fused_tile_blend": 20}
KERNELS = {
    "flash_attention_fm": dict(
        source="mdu_tpu_torch/csrc/flash_attention_fm.cu",
        replaces="mdu_tpu/ops/pallas/flash_attention.py:215",
        # UNet self-attention of config 2, levels 0 and 1; then a ragged shape
        shapes=[(10, 8, 6144, 40), (10, 8, 1536, 80), (1, 2, 513, 40)]),
    "flash_attention": dict(
        source="mdu_tpu_torch/csrc/flash_attention.cu",
        replaces="mdu_tpu/ops/pallas/flash_attention.py:335",
        # VAE mid-block attention of config 2's decode; then a ragged shape
        shapes=[(2, 1, 9600, 512), (1, 1, 1000, 512)]),
    "flash_attention_t": dict(
        source="mdu_tpu_torch/csrc/flash_attention_t.cu",
        replaces="mdu_tpu/ops/pallas/flash_attention.py:282",
        # under MDU_FLASH=trans: config 2's UNet self-attention; then ragged
        shapes=[(10, 8, 6144, 40), (10, 8, 1536, 80), (1, 2, 513, 40)]),
    "fused_group_norm": dict(
        source="mdu_tpu_torch/csrc/group_norm.cu",
        replaces="mdu_tpu/ops/pallas/group_norm.py:33",
        # [B, C, H, W], groups 32: config 2's level 0 and level 3; then a
        # ragged H * W (no 16-byte vectors)
        shapes=[(10, 320, 64, 96), (10, 1280, 8, 12), (1, 96, 7, 9)]),
    "fused_tile_blend": dict(
        source="mdu_tpu_torch/csrc/tile_blend.cu",
        replaces="mdu_tpu/ops/pallas/fused_blend.py:92",
        # config 2's latent canvas 64 x 256, tiles 64 x 96 at overlap 48, B*C
        # = 4; then a ragged canvas
        shapes=[(64, 256, 64, 96, 48, 4), (61, 97, 24, 24, 8, 3)]),
    "fused_conv3x3": dict(
        source="mdu_tpu_torch/csrc/conv3x3.cu",
        replaces="mdu_tpu/ops/pallas/conv3x3.py:96",
        # [B, H, W, C] -> Co: config 2's level-0 and level-1 ResBlock convs;
        # then odd H, W and C (no 16-byte vectors)
        shapes=[(10, 64, 96, 320, 320), (10, 32, 48, 640, 640), (2, 7, 9, 12, 20)]),
}
# the fp32 forms: the kernel they are counted under, and where it lives
F32_KERNELS = {
    "flash_attention_fm_f32": ("flash_attention_fm", "mdu_tpu_torch/csrc/flash_attention_f32.cu"),
    "flash_attention_f32": ("flash_attention", "mdu_tpu_torch/csrc/flash_attention_f32.cu"),
    "fused_conv3x3_f32": ("fused_conv3x3", "mdu_tpu_torch/csrc/conv3x3.cu"),
}


class SmokeFailure(RuntimeError):
    pass


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, itemsize: int = 2):
    """(bound ms, what bounds it) for the work and the bytes of one call."""
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attention_bound(B, H, L, D, itemsize=2):
    return bound(4.0 * B * H * L * L * D,            # QK^T and PV
                 4.0 * B * H * L * D * itemsize,     # q, k, v read; o written
                 itemsize)


def _dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def _record(name, shape, dtype, out, ref, err_plain, kernel_fn, plain_fn, lib_fn,
            bound_ms, bound_by, iters, plain_iters=3, **extra):
    """Check one kernel output against the fp32 plain version, time kernel,
    plain version and yardstick, emit a ``kernel_check`` line."""
    import torch

    err = (out.float() - ref.float()).abs().max().item()
    tol = 2.0 * err_plain + 1e-3 if dtype == torch.bfloat16 else F32_TOL
    require(bool(torch.isfinite(out).all()), f"{name} {shape}: non-finite output")
    require(err <= tol, f"{name} {shape}: max abs err {err} > {tol}")
    ms = cuda_ms(kernel_fn, iters)
    plain_ms = cuda_ms(plain_fn, plain_iters, warmup=1)
    lib_ms = cuda_ms(lib_fn, iters) if lib_fn is not None else None
    check = dict(shape=list(shape), dtype=_dtype_name(dtype), max_abs_err=err,
                 plain_err=err_plain if dtype == torch.bfloat16 else 0.0, tol=tol, ms=ms,
                 plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                 bound_by=bound_by, **extra)
    emit("kernel_check", name=name, **check)
    return check


def check_attention(gen, summary):
    """bf16 flash kernels at every shape of KERNELS, fp32 at the first; #1
    also with bf16_exp (MDU_FLASH=fm16) at its first shape."""
    import functools

    import torch
    import torch.nn.functional as F

    from mdu_tpu_torch.ops.kernels import flash

    fns = {"flash_attention_fm": (flash.flash_attention_fm, flash.flash_attention_fm_plain),
           "flash_attention": (flash.flash_attention, flash.flash_attention_plain),
           "flash_attention_t": (flash.flash_attention_t, flash.flash_attention_t_plain)}
    for name, (kernel, plain) in fns.items():
        variants = [(torch.bfloat16, name, KERNELS[name]["shapes"], {})]
        if name != "flash_attention_t":        # its fp32 form is flash_attention_f32's
            variants.append((torch.float32, name + "_f32", KERNELS[name]["shapes"][:1], {}))
        if name == "flash_attention_fm":
            variants.append((torch.bfloat16, name + "_bf16_exp",
                             KERNELS[name]["shapes"][:1], {"bf16_exp": True}))
        for dtype, key, shapes, kw in variants:
            kern = functools.partial(kernel, **kw)
            pl = functools.partial(plain, **kw)
            checks = []
            for shape in shapes:
                B, H, L, D = shape
                q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                           for _ in range(3))
                out = kern(q, k, v)
                torch.cuda.synchronize()
                ref = pl(q.float(), k.float(), v.float())
                err_plain = ((pl(q, k, v).float() - ref).abs().max().item()
                             if dtype == torch.bfloat16 else 0.0)
                extra = {}
                if kw.get("bf16_exp"):
                    # rounding the shifted score to bf16 (an ulp of 0.125 near
                    # -30) makes the function ambiguous wherever an fp32 score
                    # sits near a rounding boundary; the fp32 plain version
                    # with q.k summed in the reverse order of d measures that,
                    # and adds to the bar
                    rev = pl(q.float().flip(-1).contiguous(), k.float().flip(-1).contiguous(),
                             v.float())
                    amb = (rev - ref).abs().max().item()
                    err_plain += amb
                    extra["order_ambiguity"] = amb
                    del rev
                big = L * L * B * H > 1e8
                iters = (20 if big else 50) if dtype == torch.bfloat16 else (3 if big else 10)
                bound_ms, bound_by = attention_bound(B, H, L, D, q.element_size())
                checks.append(_record(
                    key, shape, dtype, out, ref, err_plain, lambda: kern(q, k, v),
                    lambda: pl(q, k, v), lambda: F.scaled_dot_product_attention(q, k, v),
                    bound_ms, bound_by, iters, **extra))
                del q, k, v, out, ref
            summary[key] = checks


def check_group_norm(gen, summary):
    import torch
    import torch.nn.functional as F

    from mdu_tpu_torch.ops.kernels import fused_group_norm, fused_group_norm_plain

    G, eps = 32, 1e-6
    checks = []
    for shape in KERNELS["fused_group_norm"]["shapes"]:
        C = shape[1]
        x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1).to(torch.bfloat16)
        w = (1 + 0.2 * torch.randn(C, generator=gen, device="cuda")).to(torch.bfloat16)
        b = (0.2 * torch.randn(C, generator=gen, device="cuda")).to(torch.bfloat16)
        out = fused_group_norm(x, G, w, b, eps)
        torch.cuda.synchronize()
        ref = fused_group_norm_plain(x.float(), G, w.float(), b.float(), eps)
        err_plain = (fused_group_norm_plain(x, G, w, b, eps).float() - ref).abs().max().item()
        bound_ms, bound_by = bound(8.0 * x.numel(), 2.0 * x.numel() * 2 + 4.0 * C)
        checks.append(_record(
            "fused_group_norm", shape, torch.bfloat16, out, ref, err_plain,
            lambda: fused_group_norm(x, G, w, b, eps),
            lambda: fused_group_norm_plain(x, G, w, b, eps),
            lambda: F.group_norm(x, G, w, b, eps), bound_ms, bound_by, 50))
    # fp32 (a model built in fp32) at the first shape
    shape = KERNELS["fused_group_norm"]["shapes"][0]
    x = torch.randn(shape, generator=gen, device="cuda") * 3 + 1
    w = 1 + 0.2 * torch.randn(shape[1], generator=gen, device="cuda")
    b = 0.2 * torch.randn(shape[1], generator=gen, device="cuda")
    out = fused_group_norm(x, G, w, b, eps)
    torch.cuda.synchronize()
    ref = fused_group_norm_plain(x, G, w, b, eps)
    bound_ms, bound_by = bound(8.0 * x.numel(), 2.0 * x.numel() * 4 + 8.0 * shape[1], 4)
    checks.append(_record(
        "fused_group_norm", shape, torch.float32, out, ref, 0.0,
        lambda: fused_group_norm(x, G, w, b, eps),
        lambda: fused_group_norm_plain(x, G, w, b, eps),
        lambda: F.group_norm(x, G, w, b, eps), bound_ms, bound_by, 50))
    summary["fused_group_norm"] = checks


def check_tile_blend(gen, summary):
    """The config-2 canvas (tiles fp32, as the latents are) with normalize
    False (what the scheduler asks) and True; bf16 tiles; a ragged canvas."""
    import torch

    from mdu_tpu_torch.ops.kernels import BlendTable, fused_tile_blend, fused_tile_blend_plain
    from mdu_tpu_torch.utils.grid import paint_count, split_grid

    checks = []
    specs = KERNELS["fused_tile_blend"]["shapes"]
    for (h, w, th, tw, ov, BC), dtype, normalize in (
            (specs[0], torch.float32, False), (specs[0], torch.float32, True),
            (specs[0], torch.bfloat16, False), (specs[1], torch.float32, True)):
        bbs = split_grid(w, h, tw, th, ov)
        table = BlendTable(h, w, bbs)
        tiles = torch.randn(len(bbs), BC, th, tw, generator=gen, device="cuda").to(dtype)
        wts = torch.as_tensor(paint_count(w, h, bbs)[0, 0], device="cuda")
        out = fused_tile_blend(tiles, wts, h, w, bbs, normalize, table)
        torch.cuda.synchronize()
        ref = fused_tile_blend_plain(tiles.cpu().float(), wts.cpu(), h, w, bbs, normalize,
                                     table).cuda()
        err_plain = ((fused_tile_blend_plain(tiles.cpu(), wts.cpu(), h, w, bbs, normalize,
                                             table).cuda().float() - ref).abs().max().item()
                     if dtype == torch.bfloat16 else 0.0)
        isz = tiles.element_size()
        nbytes = tiles.numel() * isz + BC * h * w * isz + (wts.numel() * 4 if normalize else 0)
        bound_ms, bound_by = bound(float(tiles.numel()), nbytes, isz)
        checks.append(_record(
            "fused_tile_blend", (len(bbs), BC, th, tw, h, w), dtype, out, ref, err_plain,
            lambda: fused_tile_blend(tiles, wts, h, w, bbs, normalize, table),
            lambda: fused_tile_blend_plain(tiles, wts, h, w, bbs, normalize, table),
            None, bound_ms, bound_by, 200, normalize=normalize))
    summary["fused_tile_blend"] = checks


def check_conv(gen, summary):
    """bf16 at every shape of KERNELS with and without fuse_act; fp32 at the
    first shape with fuse_act. The yardstick is cuDNN's conv alone, on the
    pre-activated channels-last input."""
    import torch
    import torch.nn.functional as F

    from mdu_tpu_torch.ops.kernels import (fused_conv3x3, fused_conv3x3_plain,
                                           pack_conv3x3_weight)

    shapes = KERNELS["fused_conv3x3"]["shapes"]
    runs = [(s, torch.bfloat16, act, "fused_conv3x3") for s in shapes for act in (True, False)]
    runs.append((shapes[0], torch.float32, True, "fused_conv3x3_f32"))
    checks = {"fused_conv3x3": [], "fused_conv3x3_f32": []}
    for (B, H, W, C, Co), dtype, act, key in runs:
        x = torch.randn(B, H, W, C, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(3, 3, C, Co, generator=gen, device="cuda") / (9 * C) ** 0.5).to(dtype)
        a = 1 + 0.5 * torch.randn(B, C, generator=gen, device="cuda")
        sh = 0.2 * torch.randn(B, C, generator=gen, device="cuda")
        packed = pack_conv3x3_weight(w)
        out = fused_conv3x3(x, w, a, sh, fuse_act=act, packed=packed)
        torch.cuda.synchronize()
        ref = fused_conv3x3_plain(x.float(), w.float(), a, sh, fuse_act=act)
        err_plain = ((fused_conv3x3_plain(x, w, a, sh, fuse_act=act).float() - ref)
                     .abs().max().item() if dtype == torch.bfloat16 else 0.0)
        if act:
            xf = x.float() * a[:, None, None, :] + sh[:, None, None, :]
            xa = (xf * torch.sigmoid(xf)).to(dtype)
        else:
            xa = x
        xa = xa.permute(0, 3, 1, 2)                      # NCHW view, channels-last memory
        w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        isz = x.element_size()
        flops = 2.0 * B * H * W * 9 * C * Co
        nbytes = (x.numel() + w.numel() + B * H * W * Co) * isz + (2 * B * C * 4 if act else 0)
        bound_ms, bound_by = bound(flops, nbytes, isz)
        checks[key].append(_record(
            key, (B, H, W, C, Co), dtype, out, ref, err_plain,
            lambda: fused_conv3x3(x, w, a, sh, fuse_act=act, packed=packed),
            lambda: fused_conv3x3_plain(x, w, a, sh, fuse_act=act),
            lambda: F.conv2d(xa, w_oihw, padding=1), bound_ms, bound_by,
            20 if dtype == torch.bfloat16 else 5, fuse_act=act,
            library="F.conv2d on the pre-activated input (conv alone)"))
    summary.update(checks)


def phase_kernels():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {}
    check_attention(gen, summary)
    check_group_norm(gen, summary)
    check_tile_blend(gen, summary)
    check_conv(gen, summary)
    return summary


@contextlib.contextmanager
def flags_set(flags):
    """The kernel flags set in ``os.environ`` for a ``with`` block (the port
    reads them at call time), and restored after it."""
    saved = {k: os.environ.get(k) for k in flags}
    os.environ.update(flags)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _tiny_run(device: str, dtype):
    """Tiny MultiDiffusion txt2img + exact tiled decode at a size whose UNet
    level-0 and VAE mid-block attention reach the flash kernels on the card:
    returns (latents, image) on the CPU in fp32."""
    import torch

    from mdu_tpu_torch import (DiffusionPipeline, SamplerConfig,
                               TiledDiffusionConfig, TiledVAEConfig)
    from mdu_tpu_torch.models import (AutoencoderKL, UNet2DCondition,
                                      random_state_dict, tiny_unet_config,
                                      tiny_vae_config)

    unet = UNet2DCondition(tiny_unet_config(), dtype=dtype)
    vae = AutoencoderKL(tiny_vae_config(), dtype=dtype)
    # drawn on the CPU so that both devices get the same weights
    unet.load_state_dict(random_state_dict(unet, 0, dtype, device="cpu"))
    vae.load_state_dict(random_state_dict(vae, 1, dtype, device="cpu"))
    pipe = DiffusionPipeline(unet, vae, device=device)
    gen = torch.Generator().manual_seed(5)
    c = {"crossattn": (torch.randn(1, 7, 16, generator=gen) * 0.1).to(dtype)}
    u = {"crossattn": (torch.randn(1, 7, 16, generator=gen) * 0.1).to(dtype)}
    noise = torch.randn(1, 4, 32, 64, generator=gen)
    res = pipe._txt2img_from_noise(
        noise, c, u, SamplerConfig(steps=3), 0,
        TiledDiffusionConfig(tile_w=32, tile_h=32, overlap=16, tile_bs=3),
        decode=False)
    img = pipe._decode_tensor(res.latents, TiledVAEConfig(
        decoder_tile_size=16, fast_decoder=False))
    return res.latents.float().cpu(), img.float().cpu()


def phase_reference():
    """The tiny pipeline on the card against the same pipeline on the CPU
    (plain versions): in fp32 within 1e-4 of the largest CPU value; in bf16
    within 2x the CPU bf16 run's own error against the CPU fp32 run plus
    1e-3 of the largest value. With no flag each card run must launch its fm
    kernel; with the four flags, each flagged kernel."""
    import torch

    from mdu_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    runs = [({}, {torch.float32: ["flash_attention_fm_f32"],
                  torch.bfloat16: ["flash_attention_fm"]}),
            (FLAGS, {torch.float32: ["flash_attention_f32", "fused_group_norm",
                                     "fused_conv3x3_f32", "fused_tile_blend"],
                     torch.bfloat16: ["flash_attention_t", "fused_group_norm",
                                      "fused_conv3x3", "fused_tile_blend"]})]
    for flags, must_launch in runs:
        with flags_set(flags):
            ref = _tiny_run("cpu", torch.float32)
            ref_bf16 = _tiny_run("cpu", torch.bfloat16)
            for dtype in (torch.float32, torch.bfloat16):
                reset_launches()
                got = _tiny_run("cuda", dtype)
                launches = dict(LAUNCHES)
                for key in must_launch[dtype]:
                    require(launches[key] > 0,
                            f"tiny {dtype} pipeline (flags {flags}) launched no {key}")
                fields = {"flags": flags, "launches": launches}
                for i, part in enumerate(("latent", "image")):
                    scale = ref[i].abs().max().item()
                    err = (got[i] - ref[i]).abs().max().item()
                    if dtype == torch.float32:
                        tol = 1e-4 * scale
                    else:
                        tol = 2.0 * (ref_bf16[i] - ref[i]).abs().max().item() + 1e-3 * scale
                    require(bool(torch.isfinite(got[i]).all()),
                            f"tiny {dtype} {part} (flags {flags}): non-finite")
                    require(err <= tol, f"tiny {dtype} {part} (flags {flags}): max abs "
                                        f"err {err} > {tol}")
                    fields.update({f"{part}_max_abs_err": err, f"{part}_tol": tol})
                emit("reference", dtype=_dtype_name(dtype), **fields)


def build_config2():
    """Config 2's pipeline, conds and settings: SD1.5 UNet and VAE with random
    bf16 weights drawn on the card. Returns (pipe, cond, uncond, sampler,
    tiled_diffusion, tiled_vae)."""
    import torch

    from mdu_tpu_torch import (DiffusionPipeline, Method, SamplerConfig,
                               TiledDiffusionConfig, TiledVAEConfig)
    from mdu_tpu_torch.models import (AutoencoderKL, UNet2DCondition, VAEConfig,
                                      random_state_dict, sd15_unet_config)

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    with torch.device("meta"):
        unet = UNet2DCondition(sd15_unet_config(), dtype=bf16)
        vae = AutoencoderKL(VAEConfig(), dtype=bf16)
    unet.load_state_dict(random_state_dict(unet, 0, bf16, dev), strict=True, assign=True)
    vae.load_state_dict(random_state_dict(vae, 1, bf16, dev), strict=True, assign=True)
    pipe = DiffusionPipeline(unet, vae)              # the card, by default
    require(pipe.device.type == "cuda", "pipeline did not resolve to the card")
    gen = torch.Generator(device=dev).manual_seed(2)
    cond = {"crossattn": (torch.randn(1, 77, 768, generator=gen, device=dev) * 0.1).to(bf16)}
    uncond = {"crossattn": (torch.randn(1, 77, 768, generator=gen, device=dev) * 0.1).to(bf16)}
    sp = SamplerConfig(name="Euler", steps=CFG2["steps"], cfg_scale=CFG2["cfg"])
    td = TiledDiffusionConfig(method=Method.MULTI_DIFF, tile_w=CFG2["tile"],
                              tile_h=CFG2["tile"], overlap=CFG2["overlap"],
                              tile_bs=CFG2["tile_bs"])
    tv = TiledVAEConfig(decoder_tile_size=CFG2["decoder_tile"], fast_decoder=False)
    return pipe, cond, uncond, sp, td, tv


def run_config2(pipe, cond, uncond, sp, td, tv, expected, label, n=2):
    """1 warm image and ``n`` timed ones; launches per image must equal
    ``expected`` (0 for every kernel it does not name). Returns the
    launches of the warm image and the ``txt2img`` line's fields."""
    import torch

    from mdu_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    def image(seed):
        res = pipe.txt2img(cond, uncond, width=CFG2["width"], height=CFG2["height"],
                           sampler=sp, seed=seed, tiled_diffusion=td, tiled_vae=tv)
        torch.cuda.synchronize()
        return res

    reset_launches()
    t0 = time.perf_counter()
    res = image(0)
    first_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    want = {k: expected.get(k, 0) for k in launches}
    require(launches == want, f"{label}: launches per image {launches}, expected {want}")
    require(tuple(res.images.shape) == (1, 512, 2048, 3),
            f"{label}: output shape {tuple(res.images.shape)}")
    require(bool(torch.isfinite(res.latents).all()), f"{label}: non-finite latents")

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    for seed in range(1, n + 1):
        res = image(seed)
    timed_s = time.perf_counter() - t0
    per_image = {k: v / n for k, v in LAUNCHES.items()}
    require(per_image == launches, f"{label}: launches per image differ: "
                                   f"{per_image} vs {launches}")
    require(bool(torch.isfinite(res.latents).all()), f"{label}: non-finite latents")
    return launches, dict(first_image_s=first_s, img_per_min=60.0 * n / timed_s,
                          seconds_per_image=timed_s / n,
                          max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                          output_shape=list(res.images.shape), finite=True,
                          launches_per_image=launches)


def phase_txt2img():
    """Config 2 with no flag, then with the four flags: returns the launches
    per image of each run."""
    t0 = time.perf_counter()
    pipe, cond, uncond, sp, td, tv = build_config2()
    setup_s = time.perf_counter() - t0
    out = {}
    for label, flags, expected in (("default", {}, EXPECTED_LAUNCHES),
                                   ("flagged", FLAGS, EXPECTED_FLAGGED)):
        with flags_set(flags):
            launches, fields = run_config2(pipe, cond, uncond, sp, td, tv, expected, label)
        emit("txt2img", config="config 2: MultiDiffusion txt2img 2048x512, SD1.5 bf16",
             run=label, flags=flags, sampler=sp.name, steps=sp.steps,
             cfg_scale=sp.cfg_scale, tile=[td.tile_h, td.tile_w], overlap=td.overlap,
             tile_bs=td.tile_bs, decoder_tile=tv.decoder_tile_size, setup_s=setup_s,
             expected_launches=expected, **fields)
        out[label] = launches
    return out


def kernel_rows(checks, launches):
    """The ``{"kernels": [...]}`` rows: every kernel at its main (first)
    config-2 shape, with its launches per image in the config-2 run that
    takes it (the flagged run for the flagged kernels)."""
    rows = []
    names = list(KERNELS) + list(F32_KERNELS)
    for name in names:
        if name not in checks:
            continue
        base = F32_KERNELS[name][0] if name in F32_KERNELS else name
        source = F32_KERNELS[name][1] if name in F32_KERNELS else KERNELS[name]["source"]
        main = checks[name][0]
        run = "default" if base in ("flash_attention_fm", "flash_attention") else "flagged"
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=KERNELS[base]["replaces"],
                         launches=launches.get(run, {}).get(name, 0), launches_run=run,
                         max_abs_err=max(c["max_abs_err"] for c in checks[name]),
                         ms=main["ms"], plain_ms=main["plain_ms"],
                         bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                         library_ms=main["library_ms"], shape=main["shape"],
                         dtype=main["dtype"]))
    return rows


def main() -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="kernels,reference,txt2img",
                    help="comma-separated phases after device and build")
    phases = set(ap.parse_args().phases.split(","))
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "mdu_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} holds no mdu_tpu_torch package", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for flag in FLAGS:                   # each run below sets the flags it wants
        os.environ.pop(flag, None)

    smi = nvidia_smi_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    emit("device", kind=kind, count=count, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)

    from mdu_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    report = build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         libraries={k: v["path"].rsplit("/", 1)[-1] for k, v in report.items()},
         ptxas={k: v["ptxas"] for k, v in report.items()})

    checks, launches = {}, {}
    if "kernels" in phases:
        checks = phase_kernels()
        emit("kernels", kernels={k: [dict(shape=c["shape"], dtype=c["dtype"],
                                          max_abs_err=c["max_abs_err"], tol=c["tol"])
                                     for c in v] for k, v in checks.items()})
    if "reference" in phases:
        phase_reference()
    if "txt2img" in phases:
        launches = phase_txt2img()

    emit("done", seconds=time.perf_counter() - t_start, phases=sorted(phases))
    print(json.dumps({"kernels": kernel_rows(checks, launches)}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
