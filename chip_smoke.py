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
                 the bf16 plain version's error + 1e-3. The fp32 kernels of
                 #1 and #2 (and #1 with ``bf16_exp``) at config 2's shapes,
                 the VAE's, a ragged one and an odd D, each within 1e-4 of
                 its plain version; each fp32 line names its form (sm90, wide
                 or simt, which must be the one its shape calls for), and at
                 the config-2-sized shapes the CUDA-core simt form runs on
                 the same inputs, held to the same bar and timed. Its bound
                 is three TF32 passes at 495 TFLOP/s (``fma_bound_ms``: fp32
                 on the CUDA cores); for attention SDPA is timed also under
                 the efficient-attention backend, with the default call's
                 backend named. The fp32 #1 and #2 also at the main path's
                 three shapes with q x 3 (``_f32_sharp``: scores of std 3,
                 a sharp softmax), each launch counted under its form, within
                 1e-4. #4 at six shapes config 2 runs under MDU_FUSED_GN=1
                 and a ragged one in bf16, and in fp32 at level 0 and at a
                 group past what a cluster holds: each line names the form
                 ``gn_plan`` picks (cluster or two_read) and its counter must
                 move; at config 2's shapes the other form runs on the same
                 inputs too, held to the same bar and timed; a constant
                 group must give the bias. #5's first line also times an
                 empty kernel on its grid through the same launch path
                 (``floor_ms``, ``floor_device_ms``). #6 in fp32 at config
                 2's four shapes with
                 ``fuse_act``, the first without, a ragged shape off its
                 tile (sm90) and C = 12 (simt), in the same way. #1 and #3
                 also at D = 13 (their mma.sync forms), #1 and its
                 ``bf16_exp`` at the VAE's [2, 1, 9600, 512] (the wide form),
                 #1 with ``clamp`` there too, ``bf16_exp`` also at D = 13
                 (every ``bf16_exp`` line on small-integer q and k and a
                 power-of-two scale: each score exact, none ambiguous, and
                 the plain version the same to the bit with q.k summed in
                 reverse); #1 and #2 at D = 200 (wide) and 300 (D % 8 != 0:
                 the split-D mma.sync kernel); each line names the form the
                 wrapper took, which must be the one its shape calls for. At
                 config 2's shapes #1 and #3 take their warpgroup (sm90)
                 form, #2 and #1 at D = 512 their warpgroup (wide) form, and the
                 earlier mma.sync form runs on the same inputs too, held to
                 the same bar and timed (``earlier_ms``); the line adds the
                 MUFU exp floor
                 (``mufu_floor_ms``: one ex2 per score at 16 a clock per SM
                 on 132 SMs, at the ``clocks.max.sm`` nvidia-smi reads).
                 #6 at config 2's four shapes takes its warpgroup (sm90)
                 form, and its mma.sync form runs beside it in the same way;
                 its tiny and unaligned shapes take the mma.sync form.
                 Times from CUDA events around a loop of calls (``ms``, which
                 includes the wrapper's host time where that is longer than
                 the kernel's): kernel, plain version, and one
                 PyTorch call that computes the same function as a yardstick
                 only (the port never calls it): ``F.scaled_dot_product_attention``
                 for attention, ``F.group_norm`` for GroupNorm, cuDNN's
                 ``F.conv2d`` on the pre-activated input for the fused conv
                 ("conv alone": no one call computes the fused function),
                 none for the tile blend. ``device_ms`` and
                 ``library_device_ms``: the device time alone of the kernel's
                 and the yardstick's launches (torch.profiler's kernel
                 durations, summed, per call). Bounds: max(flops / peak, bytes /
                 3.35 TB/s), peak 989 TF/s in bf16 and 67 TF/s in fp32, bytes
                 = each input read once and each output written once.
4. ``reference`` a tiny pipeline, sized so that its attention reaches the
                 flash kernels, on the card against the same pipeline on the
                 CPU: fp32 within 1e-4 of the largest value; bf16 within 2x
                 the CPU bf16 run's error against CPU fp32, + 1e-3 of it.
                 Once with no flag (the fm kernel must launch; in fp32 its
                 sm90 form) and once with MDU_FLASH=trans MDU_FUSED_GN=1
                 MDU_FUSED_CONV=1 MDU_FUSED_BLEND=1 (each flagged kernel must
                 launch; in fp32 the trans attention is flash_attention_f32's
                 sm90 form).
5. ``txt2img``   config 2 through ``DiffusionPipeline.txt2img``: SD1.5 UNet and
                 VAE with random bf16 weights, MultiDiffusion at 2048 x 512
                 (tile 96, overlap 48, tile_bs 8), Euler 20 steps at CFG 7,
                 exact tiled decode (tile 128); 1 warm and 2 timed images,
                 with no flag, with the four flags and with MDU_FLASH=fm
                 (the VAE's D = 512 through #1's wide form). Then one image
                 of config 2 built in fp32 (the JAX CLI's default dtype)
                 under MDU_FUSED_CONV=1: #6 in fp32, #1 and #2 in fp32.
                 Launch counts are set to 0 just before each image and read
                 just after; each kernel's launches per image must equal the
                 pinned count (and a kernel of the path launched 0 times
                 fails the run).

Then a ``done`` line with the script's seconds, a ``{"kernels": [...]}`` line
(every kernel of the port), the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that.
TF32 is off for matmuls and convolutions.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12       # H100 SXM fp32 on the CUDA cores
PEAK_TF32_FLOPS = 495e12      # H100 SXM dense TF32 (the fp32 attention's three passes)
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
F32_TOL = 1e-4                # fp32 kernels against their plain versions
CFG2 = dict(width=2048, height=512, steps=20, cfg=7.0, tile=96, overlap=48,
            tile_bs=8, decoder_tile=128)
FLAGS = {"MDU_FLASH": "trans", "MDU_FUSED_GN": "1", "MDU_FUSED_CONV": "1",
         "MDU_FUSED_BLEND": "1"}
# launches per config-2 image; every other kernel must launch 0 times
# ("name.form" counts the launches of one form of a kernel)
EXPECTED_LAUNCHES = {"flash_attention_fm": 200, "flash_attention_fm.sm90": 200,
                     "flash_attention": 1, "flash_attention.wide": 1}
EXPECTED_FLAGGED = {"flash_attention_t": 200, "flash_attention_t.sm90": 200,
                    "flash_attention": 1, "flash_attention.wide": 1, "fused_group_norm": 340,
                    "fused_group_norm.cluster": 120, "fused_group_norm.two_read": 220,
                    "fused_conv3x3": 320, "fused_conv3x3.sm90": 320, "fused_tile_blend": 20}
EXPECTED_FM = {"flash_attention_fm": 201, "flash_attention_fm.sm90": 200,
               "flash_attention_fm.wide": 1}
CONFIG2_RUNS = (("default", {}, EXPECTED_LAUNCHES), ("flagged", FLAGS, EXPECTED_FLAGGED),
                ("fm", {"MDU_FLASH": "fm"}, EXPECTED_FM))
# one image of config 2 built in fp32, under MDU_FUSED_CONV=1
F32_RUN = ("fp32 conv", {"MDU_FUSED_CONV": "1"},
           {"fused_conv3x3_f32": 320, "fused_conv3x3_f32.sm90": 320,
            "flash_attention_fm_f32": 200, "flash_attention_fm_f32.sm90": 200,
            "flash_attention_f32": 1, "flash_attention_f32.wide": 1})
MUFU_PER_SM_CLOCK = 16        # ex2 a clock per SM (H100)
N_SMS = 132
KERNELS = {
    "flash_attention_fm": dict(
        source="mdu_tpu_torch/csrc/flash_attention_fm.cu",
        replaces="mdu_tpu/ops/pallas/flash_attention.py:215",
        # UNet self-attention of config 2, levels 0 and 1; a ragged shape; the
        # VAE mid-block under MDU_FLASH=fm (the wide form); D = 13 (mma.sync);
        # the wide form ragged, and at D = 200 (off 64); D = 300 (wide_mma:
        # D % 8 != 0)
        shapes=[(10, 8, 6144, 40), (10, 8, 1536, 80), (1, 2, 513, 40), (2, 1, 9600, 512),
                (1, 1, 700, 13), (1, 1, 1000, 512), (1, 2, 1000, 200), (1, 1, 500, 300)],
        # fp32: the same shapes (sm90, sm90, sm90, wide, simt)
        f32_shapes=[(10, 8, 6144, 40), (10, 8, 1536, 80), (1, 2, 513, 40), (2, 1, 9600, 512),
                    (1, 1, 700, 13)]),
    "flash_attention": dict(
        source="mdu_tpu_torch/csrc/flash_attention.cu",
        replaces="mdu_tpu/ops/pallas/flash_attention.py:335",
        # VAE mid-block attention of config 2's decode; a ragged shape; D =
        # 200 (off 64); D = 300 (D % 8 != 0: the split-D mma.sync form)
        shapes=[(2, 1, 9600, 512), (1, 1, 1000, 512), (1, 2, 1000, 200), (1, 1, 500, 300)],
        # fp32: the VAE's (wide form), ragged, config 2's level 0 as
        # MDU_FLASH=trans sends it (sm90), an odd D (simt)
        f32_shapes=[(2, 1, 9600, 512), (1, 1, 1000, 512), (10, 8, 6144, 40), (1, 1, 700, 13)]),
    "flash_attention_t": dict(
        source="mdu_tpu_torch/csrc/flash_attention_t.cu",
        replaces="mdu_tpu/ops/pallas/flash_attention.py:282",
        # under MDU_FLASH=trans: config 2's UNet self-attention; ragged; D = 13
        shapes=[(10, 8, 6144, 40), (10, 8, 1536, 80), (1, 2, 513, 40), (1, 1, 700, 13)]),
    "fused_group_norm": dict(
        source="mdu_tpu_torch/csrc/group_norm.cu",
        replaces="mdu_tpu/ops/pallas/group_norm.py:33",
        # [B, C, H, W], groups 32: what config 2 runs under MDU_FUSED_GN=1.
        # The transformer norms of levels 0, 1, 2 and the mid-block (with
        # norm_out, 120 / 100 / 100 / 20 launches per image under the four
        # flags); the widest ResBlock norm (2560 channels, a skip concat);
        # the largest ResBlock group (level 0's first up ResBlock, 960
        # channels with its skip: 360 KB a group in bf16); then a ragged H * W
        # (no 16-byte lines). Level 0 and the 960 channels take the cluster
        # form, the others (which fit L2) the two_read form.
        shapes=[(10, 320, 64, 96), (10, 640, 32, 48), (10, 1280, 16, 24), (10, 1280, 8, 12),
                (10, 2560, 16, 24), (10, 960, 64, 96), (1, 96, 7, 9)],
        # fp32 (a model built in fp32): level 0 (a cluster of 8); a group
        # past what a cluster holds (1.7 MB: the two_read form)
        f32_shapes=[(10, 320, 64, 96), (1, 416, 128, 256)]),
    "fused_tile_blend": dict(
        source="mdu_tpu_torch/csrc/tile_blend.cu",
        replaces="mdu_tpu/ops/pallas/fused_blend.py:92",
        # config 2's latent canvas 64 x 256, tiles 64 x 96 at overlap 48, B*C
        # = 4; then a ragged canvas
        shapes=[(64, 256, 64, 96, 48, 4), (61, 97, 24, 24, 8, 3)]),
    "fused_conv3x3": dict(
        source="mdu_tpu_torch/csrc/conv3x3.cu",
        replaces="mdu_tpu/ops/pallas/conv3x3.py:96",
        # [B, H, W, C] -> Co: config 2's four ResBlock conv shapes (the first
        # two are its level-0 and level-1 convs); H and W off the warpgroup
        # form's 32 x 8 tile; Co off its 160 channels; odd H, W and C (the
        # mma.sync form, no 16-byte vectors)
        shapes=[(10, 64, 96, 320, 320), (10, 32, 48, 640, 640), (10, 64, 96, 640, 320),
                (10, 32, 48, 320, 640), (2, 45, 21, 320, 320), (2, 32, 48, 128, 200),
                (2, 7, 9, 12, 20)],
        # fp32: config 2's four shapes (sm90); H, W and Co off the 32 x 8 x 80
        # tile (sm90); C = 12 (simt)
        f32_shapes=[(10, 64, 96, 320, 320), (10, 32, 48, 640, 640), (10, 64, 96, 640, 320),
                    (10, 32, 48, 320, 640), (2, 45, 21, 320, 200), (2, 7, 9, 12, 20)]),
}
# config-2-sized fp32 attention shapes, where the CUDA-core (simt) form runs
# beside the tensor-core form on the same inputs
F32_CONFIG2 = [(10, 8, 6144, 40), (10, 8, 1536, 80), (2, 1, 9600, 512)]
# the fp32 kernels: the TPU kernel they replace, and where they live
F32_KERNELS = {
    "flash_attention_fm_f32": ("flash_attention_fm",
                               "mdu_tpu_torch/csrc/flash_attention_f32_sm90.cuh"),
    "flash_attention_f32": ("flash_attention", "mdu_tpu_torch/csrc/flash_attention_f32_sm90.cuh"),
    "fused_conv3x3_f32": ("fused_conv3x3", "mdu_tpu_torch/csrc/conv3x3_f32_sm90.cuh"),
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


def bound(flops: float, nbytes: float, itemsize: int = 2, peak: float = None):
    """(bound ms, what bounds it) for the work and the bytes of one call."""
    peak = peak or (PEAK_BF16_FLOPS if itemsize == 2 else PEAK_FP32_FLOPS)
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attention_bound(B, H, L, D, itemsize=2, passes=1, peak=None):
    return bound(passes * 4.0 * B * H * L * L * D,   # QK^T and PV
                 4.0 * B * H * L * D * itemsize,     # q, k, v read; o written
                 itemsize, peak)


def sdpa_backend(q, k, v) -> str:
    """The backend that F.scaled_dot_product_attention picks for q, k, v."""
    import torch
    from torch.nn.attention import SDPBackend

    try:
        idx = int(torch._fused_sdp_choice(q, k, v))
    except (AttributeError, RuntimeError, TypeError) as exc:
        return f"unknown ({type(exc).__name__})"
    names = {int(b.value): n for n, b in SDPBackend.__members__.items()}
    return names.get(idx, str(idx))


def _dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def device_ms(fn, iters: int):
    """Device time of one call: the durations of the kernels (and copies)
    that ``iters`` calls put on the card, summed by torch.profiler, over
    ``iters``. The host's time between launches does not count. None (not
    measured) when two profiled windows in a row show no device activity,
    as one cuDNN convolution did."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = 0.0
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                dt = getattr(evt, "device_time", None)
                total_us += evt.cuda_time if dt is None else dt
        if total_us > 0:
            return total_us / 1e3 / iters
    return None


def _record(name, shape, dtype, out, ref, err_plain, kernel_fn, plain_fn, lib_fn,
            bound_ms, bound_by, iters, plain_iters=3, **extra):
    """Check one kernel output against the fp32 plain version, time kernel,
    plain version and yardstick (CUDA events around a loop of calls; the
    kernel and the yardstick also on the device alone), emit a
    ``kernel_check`` line."""
    import torch

    err = (out.float() - ref.float()).abs().max().item()
    tol = 2.0 * err_plain + 1e-3 if dtype == torch.bfloat16 else F32_TOL
    require(bool(torch.isfinite(out).all()), f"{name} {shape}: non-finite output")
    require(err <= tol, f"{name} {shape}: max abs err {err} > {tol}")
    ms = cuda_ms(kernel_fn, iters)
    dev_ms = device_ms(kernel_fn, iters)
    plain_ms = cuda_ms(plain_fn, plain_iters, warmup=1)
    lib_ms = cuda_ms(lib_fn, iters) if lib_fn is not None else None
    lib_dev_ms = device_ms(lib_fn, iters) if lib_fn is not None else None
    check = dict(shape=list(shape), dtype=_dtype_name(dtype), max_abs_err=err,
                 plain_err=err_plain, tol=tol, ms=ms,
                 device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                 library_device_ms=lib_dev_ms, bound_ms=bound_ms, bound_by=bound_by, **extra)
    emit("kernel_check", name=name, **check)
    return check


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def check_attention(gen, summary):
    """bf16 flash kernels at every shape of KERNELS, fp32 at every
    ``f32_shapes``; #1 also with bf16_exp (MDU_FLASH=fm16) at its first
    shape, at D = 512 and at D = 13, and in fp32 at its first shape. Each
    line names the form the wrapper took, which must be the one its shape
    calls for. Where the warpgroup form runs at a config-2 shape, the earlier
    form (bf16: mma.sync; fp32: the CUDA-core simt form) is checked and timed
    on the same inputs beside it. fp32 lines bound the kernel by three TF32
    passes and give the fp32 FMA bound beside it, and time SDPA also under
    the efficient-attention backend."""
    import functools

    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from mdu_tpu_torch.ops.kernels import flash

    clock_hz = max_sm_clock_hz()
    fns = {"flash_attention_fm": (flash.flash_attention_fm, flash.flash_attention_fm_plain),
           "flash_attention": (flash.flash_attention, flash.flash_attention_plain),
           "flash_attention_t": (flash.flash_attention_t, flash.flash_attention_t_plain)}

    def sdpa_efficient(q, k, v):
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q, k, v)

    for name, (kernel, plain) in fns.items():
        shapes = KERNELS[name]["shapes"]
        variants = [(torch.bfloat16, name, shapes, {})]
        if name != "flash_attention_t":        # its fp32 form is flash_attention_f32's
            f32_shapes = KERNELS[name]["f32_shapes"]
            variants.append((torch.float32, name + "_f32", f32_shapes, {}))
            # a sharp softmax (q x 3: scores of std 3, a large |O|) at the
            # main path's shapes, where a chain of truncating tensor-core
            # additions into O would miss the bar
            variants.append((torch.float32, name + "_f32_sharp", F32_CONFIG2, {"qscale": 3.0}))
        if name == "flash_attention_fm":
            variants.append((torch.bfloat16, name + "_bf16_exp",
                             [shapes[0], (2, 1, 9600, 512), (1, 1, 700, 13)],
                             {"bf16_exp": True}))
            # scores above smax = 2 (a few % of them) flattened
            variants.append((torch.bfloat16, name + "_clamp", [(2, 1, 9600, 512)],
                             {"smax": 2.0, "clamp": True}))
            variants.append((torch.float32, name + "_f32_bf16_exp", f32_shapes[:1],
                             {"bf16_exp": True}))
        for dtype, key, var_shapes, var_kw in variants:
            checks = []
            for shape in var_shapes:
                B, H, L, D = shape
                q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                           for _ in range(3))
                kw = dict(var_kw)
                qscale = kw.pop("qscale", None)
                if qscale is not None:
                    q = q * qscale
                if kw.get("bf16_exp"):
                    # rounding the shifted score to bf16 (an ulp of 0.125 near
                    # -30) makes the function ambiguous wherever a score sits
                    # near a rounding boundary: q and k are small integers and
                    # the scale D^-0.5 rounded down to a power of two (scores
                    # of std 1.4-1.8, as random inputs give), so that every
                    # score is exact in any order and no rounding can go
                    # either way
                    q, k = (torch.randint(-2, 3, shape, generator=gen, device="cuda").to(dtype)
                            for _ in range(2))
                    kw["scale"] = 2.0 ** -math.ceil(math.log2(D) / 2)
                kern = functools.partial(kernel, **kw)
                pl = functools.partial(plain, **kw)
                launches_before = dict(flash.LAUNCHES)
                out = kern(q, k, v)
                torch.cuda.synchronize()
                ref = pl(q.float(), k.float(), v.float())
                err_plain = ((pl(q, k, v).float() - ref).abs().max().item()
                             if dtype == torch.bfloat16 else 0.0)
                extra = {}
                if kw.get("bf16_exp"):
                    # the fp32 plain version with q.k summed in the reverse
                    # order of d: the same to the bit when no score is ambiguous
                    rev = pl(q.float().flip(-1).contiguous(), k.float().flip(-1).contiguous(),
                             v.float())
                    amb = (rev - ref).abs().max().item()
                    require(amb == 0.0, f"{key} {shape}: the plain version moves by {amb} "
                                        "when q.k is summed in reverse: a score is ambiguous")
                    extra.update(order_ambiguity=amb, scale=kw["scale"])
                    del rev
                big = L * L * B * H > 1e8
                iters = (20 if big else 50) if dtype == torch.bfloat16 else (3 if big else 10)
                lib_fn = lambda: F.scaled_dot_product_attention(q, k, v)
                mufu = B * H * L * L / (N_SMS * MUFU_PER_SM_CLOCK * clock_hz) * 1e3
                if dtype == torch.bfloat16 and name in flash.FORMS:
                    form = flash.bf16_form(name, q, k, v)
                    if D > flash.MMA_MAX_D:
                        want = ("wide" if D % 8 == 0 else
                                "wide_mma" if name == "flash_attention_fm" else "mma")
                    else:
                        want = "mma" if D % 8 or name == "flash_attention" else "sm90"
                    require(form == want, f"{key} {shape}: form {form}, expected {want}")
                    extra["form"] = form
                    earlier = {"sm90": "mma",
                               "wide": "wide_mma" if name == "flash_attention_fm" else "mma"}
                    if (form == "sm90" and shape in shapes[:2]) or (
                            form == "wide" and shape == (2, 1, 9600, 512)):
                        # the mma.sync form that config 2 took before, on the
                        # same inputs: held to the same bar, and timed
                        early = functools.partial(flash.launch_form, name, earlier[form],
                                                  q, k, v, **kw)
                        early_err = (early().float() - ref).abs().max().item()
                        require(early_err <= 2.0 * err_plain + 1e-3,
                                f"{key} {shape} {earlier[form]} form: max abs err {early_err}")
                        extra["earlier_max_abs_err"] = early_err
                        extra["earlier_ms"] = cuda_ms(early, iters)
                        extra["earlier_device_ms"] = device_ms(early, iters)
                        extra["earlier_form"] = earlier[form]
                    extra["mufu_floor_ms"] = mufu
                    extra["sm_clock_max_mhz"] = clock_hz / 1e6
                if dtype == torch.float32:
                    fname = name + "_f32"
                    form = flash.f32_form(fname, q, k, v)
                    want = ("sm90" if D <= flash.F32_SM90_MAX_D else "wide") if D % 4 == 0 \
                        else "simt"
                    require(form == want, f"{key} {shape}: form {form}, expected {want}")
                    require(flash.LAUNCHES[f"{fname}.{form}"]
                            == launches_before[f"{fname}.{form}"] + 1,
                            f"{key} {shape}: no launch counted under {fname}.{form}")
                    extra["form"] = form
                    if qscale is not None:
                        extra["qscale"] = qscale
                    elif shape in F32_CONFIG2:
                        # the CUDA-core form that fp32 took before, on the
                        # same inputs: held to the same bar, and timed
                        early = functools.partial(flash.launch_f32_form, fname, "simt", q, k, v,
                                                  **kw)
                        early_err = (early() - ref).abs().max().item()
                        require(early_err <= F32_TOL,
                                f"{key} {shape} simt form: max abs err {early_err}")
                        extra.update(earlier_form="simt", earlier_max_abs_err=early_err,
                                     earlier_ms=cuda_ms(early, iters),
                                     earlier_device_ms=device_ms(early, iters))
                    extra["fma_bound_ms"] = attention_bound(B, H, L, D, 4)[0]
                    extra["mufu_floor_ms"] = mufu
                    extra["sm_clock_max_mhz"] = clock_hz / 1e6
                    extra["bound_basis"] = "3 TF32 passes at 495 TFLOP/s"
                    extra["library_backend"] = sdpa_backend(q, k, v)
                    try:
                        sdpa_efficient(q, k, v)
                        eff = lambda: sdpa_efficient(q, k, v)
                        extra["library_efficient_ms"] = cuda_ms(eff, iters)
                        extra["library_efficient_device_ms"] = device_ms(eff, iters)
                    except RuntimeError as exc:            # the backend does not take it
                        extra["library_efficient_ms"] = None
                        extra["library_efficient_error"] = str(exc).splitlines()[0][:200]
                    bound_ms, bound_by = attention_bound(B, H, L, D, 4, passes=3,
                                                         peak=PEAK_TF32_FLOPS)
                else:
                    bound_ms, bound_by = attention_bound(B, H, L, D, q.element_size())
                checks.append(_record(
                    key, shape, dtype, out, ref, err_plain, lambda: kern(q, k, v),
                    lambda: pl(q, k, v), lib_fn, bound_ms, bound_by, iters, **extra))
                del q, k, v, out, ref
            summary[key] = checks


def check_group_norm(gen, summary):
    """bf16 at every shape of KERNELS, fp32 at every ``f32_shapes``. Each line
    names the form that ``gn_plan`` picks, whose launch counter must move; at
    config 2's shapes the other form runs on the same inputs too (where a
    group fits a cluster), held to the same bar and timed (``other_*``).
    Then a constant group: its variance clamps at 0, and the output is the
    bias."""
    import torch
    import torch.nn.functional as F

    from mdu_tpu_torch.ops.kernels import LAUNCHES, fused_group_norm, fused_group_norm_plain
    from mdu_tpu_torch.ops.kernels import group_norm as gn_mod

    G, eps = 32, 1e-6
    spec = KERNELS["fused_group_norm"]
    runs = ([(s, torch.bfloat16) for s in spec["shapes"]]
            + [(s, torch.float32) for s in spec["f32_shapes"]])
    checks = []
    for shape, dtype in runs:
        B, C, H, W = shape
        x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1).to(dtype)
        w = (1 + 0.2 * torch.randn(C, generator=gen, device="cuda")).to(dtype)
        b = (0.2 * torch.randn(C, generator=gen, device="cuda")).to(dtype)
        form, cluster, part = gn_mod.gn_plan(B, C, G, H, W, x.element_size())
        before = LAUNCHES[f"fused_group_norm.{form}"]
        out = fused_group_norm(x, G, w, b, eps)
        torch.cuda.synchronize()
        require(LAUNCHES[f"fused_group_norm.{form}"] == before + 1,
                f"fused_group_norm {shape}: no launch of its {form} form")
        ref = fused_group_norm_plain(x.float(), G, w.float(), b.float(), eps)
        err_plain = ((fused_group_norm_plain(x, G, w, b, eps).float() - ref).abs().max().item()
                     if dtype == torch.bfloat16 else 0.0)
        tol = 2.0 * err_plain + 1e-3 if dtype == torch.bfloat16 else F32_TOL
        extra = {"form": form, "cluster": cluster, "part": part}
        other = "two_read" if form == "cluster" else "cluster"
        if B == 10 and gn_mod.cluster_split(C // G * H * W, x.element_size()):
            alt = lambda: gn_mod.launch_form(other, x, G, w, b, eps)
            alt_err = (alt().float() - ref).abs().max().item()
            require(alt_err <= tol, f"fused_group_norm {shape} {other} form: max abs err "
                                    f"{alt_err}")
            extra.update(other_form=other, other_max_abs_err=alt_err,
                         other_ms=cuda_ms(alt, 50), other_device_ms=device_ms(alt, 50))
        isz = x.element_size()
        bound_ms, bound_by = bound(8.0 * x.numel(), 2.0 * x.numel() * isz + 2.0 * C * isz, isz)
        checks.append(_record(
            "fused_group_norm", shape, dtype, out, ref, err_plain,
            lambda: fused_group_norm(x, G, w, b, eps),
            lambda: fused_group_norm_plain(x, G, w, b, eps),
            lambda: F.group_norm(x, G, w, b, eps), bound_ms, bound_by, 50,
            plain_iters=1 if x.numel() > 5e7 else 3, **extra))
        # a constant first group: var = 0 exactly, so the output is the bias
        x[:, :C // G] = 5.0
        out = fused_group_norm(x, G, w, b, eps)
        first = out[:, :C // G].float()
        require(bool(torch.isfinite(out).all()) and bool(
            (first == b[:C // G].float()[None, :, None, None]).all()),
            f"fused_group_norm {shape}: a constant group does not give the bias")
        del x, out, ref
    summary["fused_group_norm"] = checks


def check_tile_blend(gen, summary):
    """The config-2 canvas (tiles fp32, as the latents are) with normalize
    False (what the scheduler asks) and True; bf16 tiles; a ragged canvas.
    The first line also times the launch floor (``floor_ms``,
    ``floor_device_ms``): an empty kernel on #5's grid."""
    import torch

    from mdu_tpu_torch.ops.kernels import BlendTable, fused_tile_blend, fused_tile_blend_plain
    from mdu_tpu_torch.ops.kernels.tile_blend import tile_blend_floor
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
        extra = {}
        if not checks:
            # the launch floor: an empty kernel on the same grid, through the
            # same checks and launch path
            floor = lambda: tile_blend_floor(tiles, wts, h, w, bbs, normalize, table)
            extra.update(floor_ms=cuda_ms(floor, 200), floor_device_ms=device_ms(floor, 200))
        checks.append(_record(
            "fused_tile_blend", (len(bbs), BC, th, tw, h, w), dtype, out, ref, err_plain,
            lambda: fused_tile_blend(tiles, wts, h, w, bbs, normalize, table),
            lambda: fused_tile_blend_plain(tiles, wts, h, w, bbs, normalize, table),
            None, bound_ms, bound_by, 200, normalize=normalize, **extra))
    summary["fused_tile_blend"] = checks


def check_conv(gen, summary):
    """bf16 at every shape of KERNELS with and without fuse_act; fp32 at every
    ``f32_shapes`` with fuse_act and at the first without. Each line names
    the form the wrapper took, which must be the one its shape calls for; at
    config 2's four shapes the earlier form (bf16: mma.sync; fp32: the
    CUDA-core simt form) runs on the same inputs too, held to the same bar
    and timed (``earlier_ms``). fp32 lines bound the kernel by three TF32
    passes and give the fp32 FMA bound beside it. The yardstick is cuDNN's
    conv alone, on the pre-activated channels-last input (TF32 off)."""
    import torch
    import torch.nn.functional as F

    from mdu_tpu_torch.ops.kernels import (fused_conv3x3, fused_conv3x3_plain,
                                           pack_conv3x3_weight)
    from mdu_tpu_torch.ops.kernels import conv3x3 as conv_mod

    shapes = KERNELS["fused_conv3x3"]["shapes"]
    f32_shapes = KERNELS["fused_conv3x3"]["f32_shapes"]
    runs = [(s, torch.bfloat16, act, "fused_conv3x3") for s in shapes for act in (True, False)]
    runs += [(s, torch.float32, True, "fused_conv3x3_f32") for s in f32_shapes]
    runs.append((f32_shapes[0], torch.float32, False, "fused_conv3x3_f32"))
    checks = {"fused_conv3x3": [], "fused_conv3x3_f32": []}
    for (B, H, W, C, Co), dtype, act, key in runs:
        bf16 = dtype == torch.bfloat16
        x = torch.randn(B, H, W, C, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(3, 3, C, Co, generator=gen, device="cuda") / (9 * C) ** 0.5).to(dtype)
        a = 1 + 0.5 * torch.randn(B, C, generator=gen, device="cuda")
        sh = 0.2 * torch.randn(B, C, generator=gen, device="cuda")
        packed = pack_conv3x3_weight(w)
        out = fused_conv3x3(x, w, a, sh, fuse_act=act, packed=packed)
        torch.cuda.synchronize()
        ref = fused_conv3x3_plain(x.float(), w.float(), a, sh, fuse_act=act)
        err_plain = ((fused_conv3x3_plain(x, w, a, sh, fuse_act=act).float() - ref)
                     .abs().max().item() if bf16 else 0.0)
        tol = 2.0 * err_plain + 1e-3 if bf16 else F32_TOL
        iters = 20 if bf16 else 5
        extra = {}
        ops = (x, packed, a, sh) if act else (x, packed)
        if bf16:
            form = conv_mod.conv_form(*ops)
            want = "sm90" if C % conv_mod.SM90_CHUNK == 0 and Co % 8 == 0 else "mma"
            earlier = "mma"
        else:
            form = conv_mod.conv_f32_form(*ops)
            want = "sm90" if C % conv_mod.F32_SM90_CHUNK == 0 and Co % 8 == 0 else "simt"
            earlier = "simt"
        require(form == want, f"{key} {(B, H, W, C, Co)}: form {form}, expected {want}")
        extra["form"] = form
        if (B, H, W, C, Co) in shapes[:4] and form != earlier:
            # the form that config 2 took before, on the same inputs: held to
            # the same bar, and timed
            launch = conv_mod.launch_form if bf16 else conv_mod.launch_f32_form
            early = lambda: launch(earlier, x, packed, a, sh, act)
            early_err = (early().float() - ref).abs().max().item()
            require(early_err <= tol,
                    f"{key} {(B, H, W, C, Co)} {earlier} form: max abs err {early_err}")
            extra.update(earlier_form=earlier, earlier_max_abs_err=early_err,
                         earlier_ms=cuda_ms(early, iters),
                         earlier_device_ms=device_ms(early, iters))
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
        if bf16:
            bound_ms, bound_by = bound(flops, nbytes, isz)
        else:
            extra["fma_bound_ms"] = bound(flops, nbytes, isz)[0]
            extra["bound_basis"] = "3 TF32 passes at 495 TFLOP/s"
            bound_ms, bound_by = bound(3 * flops, nbytes, isz, PEAK_TF32_FLOPS)
        checks[key].append(_record(
            key, (B, H, W, C, Co), dtype, out, ref, err_plain,
            lambda: fused_conv3x3(x, w, a, sh, fuse_act=act, packed=packed),
            lambda: fused_conv3x3_plain(x, w, a, sh, fuse_act=act),
            lambda: F.conv2d(xa, w_oihw, padding=1), bound_ms, bound_by, iters, fuse_act=act,
            library="F.conv2d on the pre-activated input (conv alone)", **extra))
        del x, w, packed, out, ref, xa, w_oihw
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
    kernel (in fp32 its sm90 form: the heads are D = 4 and 16); with the four
    flags, each flagged kernel."""
    import torch

    from mdu_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    runs = [({}, {torch.float32: ["flash_attention_fm_f32", "flash_attention_fm_f32.sm90"],
                  torch.bfloat16: ["flash_attention_fm"]}),
            (FLAGS, {torch.float32: ["flash_attention_f32", "flash_attention_f32.sm90",
                                     "fused_group_norm", "fused_conv3x3_f32",
                                     "fused_tile_blend"],
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


def build_config2(dtype=None):
    """Config 2's pipeline, conds and settings: SD1.5 UNet and VAE with random
    weights drawn on the card, bf16 unless ``dtype`` says otherwise. Returns
    (pipe, cond, uncond, sampler, tiled_diffusion, tiled_vae)."""
    import torch

    from mdu_tpu_torch import (DiffusionPipeline, Method, SamplerConfig,
                               TiledDiffusionConfig, TiledVAEConfig)
    from mdu_tpu_torch.models import (AutoencoderKL, UNet2DCondition, VAEConfig,
                                      random_state_dict, sd15_unet_config)

    dev, bf16 = torch.device("cuda"), dtype or torch.bfloat16
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
    """Config 2 with no flag, with the four flags and with MDU_FLASH=fm; then
    config 2 built in fp32 under MDU_FUSED_CONV=1 (1 warm and 1 timed
    image): returns the launches per image of each run."""
    import torch

    out = {}
    runs = [(None, CONFIG2_RUNS, 2), (torch.float32, (F32_RUN,), 1)]
    for dtype, config_runs, n in runs:
        t0 = time.perf_counter()
        pipe, cond, uncond, sp, td, tv = build_config2(dtype)
        setup_s = time.perf_counter() - t0
        for label, flags, expected in config_runs:
            with flags_set(flags):
                launches, fields = run_config2(pipe, cond, uncond, sp, td, tv, expected, label,
                                               n)
            emit("txt2img", config="config 2: MultiDiffusion txt2img 2048x512, SD1.5 "
                                   + ("fp32" if dtype == torch.float32 else "bf16"),
                 run=label, flags=flags, sampler=sp.name, steps=sp.steps,
                 cfg_scale=sp.cfg_scale, tile=[td.tile_h, td.tile_w], overlap=td.overlap,
                 tile_bs=td.tile_bs, decoder_tile=tv.decoder_tile_size, setup_s=setup_s,
                 expected_launches=expected, **fields)
            out[label] = launches
        del pipe, cond, uncond
        torch.cuda.empty_cache()
    return out


def kernel_rows(checks, launches):
    """The ``{"kernels": [...]}`` rows: every kernel at its main (first)
    config-2 shape, with its launches per image in the config-2 run that
    takes it (the flagged run for the flagged kernels, the fp32 image for the
    fp32 kernels). A kernel with forms also lists the forms checked, the
    launches of each form in that run, and every config-2 shape with the
    earlier form's time (attention with the MUFU floor, fp32 with the FMA
    bound and, for attention, SDPA under both backends); #1's wide form has
    its own row (launches from the MDU_FLASH=fm run)."""
    rows = []
    c2_fields = ("shape", "form", "fuse_act", "ms", "device_ms", "earlier_form", "earlier_ms",
                 "earlier_device_ms", "bound_ms", "fma_bound_ms", "mufu_floor_ms",
                 "library_ms", "library_device_ms", "library_backend", "library_efficient_ms",
                 "library_efficient_device_ms", "plain_ms", "max_abs_err",
                 "earlier_max_abs_err", "cluster", "dtype", "other_form", "other_device_ms",
                 "other_max_abs_err")
    conv_c2 = KERNELS["fused_conv3x3"]["shapes"][:4]
    # kernel -> (config-2 run that takes it, its config-2 shapes)
    where = {"flash_attention_fm": ("default", KERNELS["flash_attention_fm"]["shapes"][:2]),
             "flash_attention": ("default", [(2, 1, 9600, 512)]),
             "flash_attention_t": ("flagged", KERNELS["flash_attention_t"]["shapes"][:2]),
             "fused_group_norm": ("flagged", KERNELS["fused_group_norm"]["shapes"][:6]),
             "fused_tile_blend": ("flagged", []),
             "fused_conv3x3": ("flagged", conv_c2),
             "flash_attention_fm_f32": ("fp32 conv", F32_CONFIG2[:2]),
             "flash_attention_f32": ("fp32 conv", F32_CONFIG2[2:]),
             "fused_conv3x3_f32": ("fp32 conv", conv_c2)}
    templates = {"flash_attention_fm": "mdu_tpu_torch/csrc/flash_attention_sm90.cuh",
                 "flash_attention_t": "mdu_tpu_torch/csrc/flash_attention_sm90.cuh",
                 "flash_attention": "mdu_tpu_torch/csrc/flash_attention_wide_sm90.cuh"}

    def row(name, key, checked, run, c2, source, launch_key=None, **extra):
        main = checked[0]
        got = launches.get(run, {})
        forms = sorted({c["form"] for c in checked if c.get("form")})
        if forms:
            extra.update(forms=forms,
                         form_launches={k.split(".", 1)[1]: v for k, v in got.items()
                                        if k.startswith(key + ".")})
        c2_checks = [c for c in checked if tuple(c["shape"]) in c2 and c.get("fuse_act", True)
                     and c["dtype"] == main["dtype"]]
        if c2_checks:
            extra["config2_shapes"] = [{f: c.get(f) for f in c2_fields if f in c}
                                       for c in c2_checks]
        return dict(name=name, route="cuda", source=source,
                    replaces=KERNELS[F32_KERNELS[key][0] if key in F32_KERNELS else key]
                    ["replaces"], launches=got.get(launch_key or key, 0), launches_run=run,
                    max_abs_err=max(c["max_abs_err"] for c in checked),
                    ms=main["ms"], device_ms=main["device_ms"], plain_ms=main["plain_ms"],
                    bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                    library_ms=main["library_ms"], library_device_ms=main["library_device_ms"],
                    shape=main["shape"], dtype=main["dtype"],
                    **{f: main[f] for f in ("form", "earlier_form", "earlier_ms",
                                            "earlier_device_ms", "fma_bound_ms",
                                            "mufu_floor_ms", "bound_basis", "library_backend",
                                            "library_efficient_ms", "floor_ms",
                                            "floor_device_ms") if f in main},
                    **extra)

    for name in list(KERNELS) + list(F32_KERNELS):
        if name not in checks:
            continue
        run, c2 = where[name]
        source = F32_KERNELS[name][1] if name in F32_KERNELS else KERNELS[name]["source"]
        extra = {"template": templates[name]} if name in templates else {}
        if name + "_sharp" in checks:
            extra["sharp_softmax"] = [{f: c.get(f) for f in ("shape", "form", "qscale",
                                                             "max_abs_err", "tol", "ms",
                                                             "device_ms")}
                                      for c in checks[name + "_sharp"]]
        rows.append(row(name, name, checks[name], run, c2, source, **extra))
        wide = [c for c in checks[name] if c.get("form") == "wide"]
        if wide and name == "flash_attention_fm":
            rows.append(row(name + ".wide", name, wide, "fm", [(2, 1, 9600, 512)],
                            "mdu_tpu_torch/csrc/flash_attention_wide_sm90.cuh",
                            launch_key=name + ".wide", entry="mdu_flash_attention_fm_wide"))
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
