#!/usr/bin/env python3
"""Where the time of one config-2, config-3, config-4 or config-5 image goes
in the PyTorch port, on the card.

    python3 scripts/profile_torch_config2.py [--config 2|3|4|5] [--dtype bfloat16|float32]
                                             [--out PATH]

Builds config 2 exactly as ``chip_smoke.py`` does (SD1.5 random weights, in
bf16 unless ``--dtype float32`` asks for an fp32 model, as the JAX CLI's
default dtype gives;
MultiDiffusion 2048 x 512, Euler 20 steps at CFG 7, exact tiled decode), or
with ``--config 3`` config 3 as ``chip_smoke.build_config3`` does (bf16 only:
MoD img2img x4 of a 512 x 512 image with noise inversion, exact tiled encode
and decode; the noise-inversion cache is freed before every image), or with
``--config 4`` config 4 as ``chip_smoke.build_config4`` does (bf16 only:
MultiDiffusion txt2img at 1536 x 1536 with four BACKGROUND regions, exact
tiled decode), or with ``--config 5`` config 5 as ``chip_smoke.build_config5``
does (bf16 only: SDXL DemoFusion x3 with ControlNet from 1024 x 1024, no
decode; its warm-up image is a x2 one, which has every shape, and so is its
profiled image: phases 1 and 2, 90 of the x3 image's 270 guided calls, whose
phase 2 calls have the shapes of phase 3's: the profiler took more than 15
minutes over a x3 image's events on the card's host), runs one
warm-up image, one image timed on the host clock (ending in a
synchronize), then one image under ``torch.profiler``. Prints one JSON line:
the wall time of the image
without the profiler, the device time summed over kernels, the device busy
share of the profiled image, and the device time by kernel family and by the
20 largest kernels (also written to PATH with --out), and the launches of
#4 by input shape in the warm-up image. TF32 is off. The
kernel flags (MDU_FLASH, MDU_FUSED_GN, MDU_FUSED_CONV, MDU_FUSED_BLEND) are
taken from the environment as they are, and echoed in the result, as is
the dtype.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# kernel-name patterns -> family, first match wins
FAMILIES = [
    # the fp32 kernels (csrc/flash_attention_f32.cu): the tensor-core forms
    # by their policy, the CUDA-core form by FIXED (demangled or not)
    ("flash_attention_fm (fp32)", r"flash_f32_(sm90|wide)_kernel.*Fixed"
                                  r"|flash_f32_kernel<\d+, true|flash_f32_kernelILi\d+ELb1"),
    ("flash_attention (fp32)", r"flash_f32_"),
    # the warpgroup kernels by their policy; #1's wide forms are #2's kernels
    # with the fixed shift (FIXED = true in the mma.sync one; demangled or not)
    ("flash_attention_fm", r"flash_fm_kernel|flash_(wide_)?sm90_kernel.*FixedShift"
                           r"|flash_kernel<\d+, true|flash_kernelILi\d+ELb1"),
    ("flash_attention_t", r"flash_t_kernel|flash_sm90_kernel.*Online"),
    ("flash_attention", r"flash_kernel|flash_wide_sm90_kernel"),
    ("fused_group_norm", r"gn_(cluster|two_read)_kernel"),
    ("fused_tile_blend", r"blend_kernel"),
    ("fused_conv3x3", r"conv_bf16_kernel|conv_sm90_kernel|conv_f32_kernel|conv_f32_sm90_kernel"),
    ("conv (cuDNN / implicit GEMM)", r"conv|implicit|cudnn|xmma_fprop|sm90_xmma|winograd|fprop"),
    ("matmul (cuBLAS)", r"gemm|cutlass|cublas|nvjet|sm90_"),
    ("softmax", r"softmax"),
    ("reduction (norm stats)", r"reduce|Reduce"),
    ("elementwise / copy", r"elementwise|vectorized|Copy|copy|fill|unrolled|index|cat"),
]


def family(name: str) -> str:
    for fam, pat in FAMILIES:
        if re.search(pat, name):
            return fam
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the result as JSON to this file")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="the models' dtype (default bfloat16, as config 2 runs)")
    ap.add_argument("--config", choices=("2", "3", "4", "5"), default="2",
                    help="config 2 (txt2img, the default), config 3 (img2img, bf16), "
                         "config 4 (regional txt2img, bf16) or config 5 (SDXL DemoFusion "
                         "with ControlNet, bf16)")
    args = ap.parse_args()
    if args.config != "2" and args.dtype != "bfloat16":
        ap.error(f"config {args.config} runs in bf16")

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_config2: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke

    from mdu_tpu_torch.ops.kernels import build

    build.build_all()
    if args.config == "3":
        pipe, cond, uncond, sp, td, tv, img = chip_smoke.build_config3()

        def image(seed):
            pipe.free_cache()
            pipe.img2img(img, cond, uncond, sampler=sp, seed=seed, tiled_diffusion=td,
                         tiled_vae=tv)
            torch.cuda.synchronize()
    elif args.config == "5":
        import dataclasses

        pipe, cond, uncond, cfg, sp = chip_smoke.build_config5()
        size = chip_smoke.CFG5["size"]

        def image(seed):
            # the warm-up (seed 0) and the profiled image (seed 2) at x2
            scale = 2 if seed in (0, 2) else cfg.scale_factor
            pipe.demofusion(cond, uncond, size, size,
                            dataclasses.replace(cfg, scale_factor=scale), sp, seed=seed,
                            decode=False)
            torch.cuda.synchronize()
    elif args.config == "4":
        pipe, cond, uncond, sp, td, tv, rc = chip_smoke.build_config4()

        def image(seed):
            pipe.free_cache()
            pipe.txt2img(cond, uncond, width=chip_smoke.CFG4["width"],
                         height=chip_smoke.CFG4["height"], sampler=sp, seed=seed,
                         tiled_diffusion=td, tiled_vae=tv, region_conds=rc)
            torch.cuda.synchronize()
    else:
        pipe, cond, uncond, sp, td, tv = chip_smoke.build_config2(getattr(torch, args.dtype))

        def image(seed):
            pipe.txt2img(cond, uncond, width=2048, height=512, sampler=sp, seed=seed,
                         tiled_diffusion=td, tiled_vae=tv)
            torch.cuda.synchronize()

    # the warm-up image also counts #4's launches by shape (under MDU_FUSED_GN)
    from mdu_tpu_torch.models import layers

    gn_shapes = {}
    fused_gn = layers.fused_group_norm

    def counted_gn(x, *a, **kw):
        key = str(list(x.shape))
        gn_shapes[key] = gn_shapes.get(key, 0) + 1
        return fused_gn(x, *a, **kw)

    layers.fused_group_norm = counted_gn
    image(0)                                      # warm-up
    layers.fused_group_norm = fused_gn
    t0 = time.perf_counter()
    image(1)
    wall_s = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        image(2)
        prof_wall_s = time.perf_counter() - t0

    kernels = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dt = getattr(evt, "device_time", None)
        if dt is None:
            dt = evt.cuda_time
        k = kernels.setdefault(evt.name, [0.0, 0])
        k[0] += dt / 1e3                             # us -> ms
        k[1] += 1
    total_ms = sum(v[0] for v in kernels.values())
    fams = {}
    for name, (ms, n) in kernels.items():
        f = fams.setdefault(family(name), [0.0, 0])
        f[0] += ms
        f[1] += n
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:20]
    result = {
        "device": torch.cuda.get_device_name(0),
        "config": int(args.config),
        "profiled_scale": 2 if args.config == "5" else None,
        "dtype": args.dtype,
        "flags": {k: os.environ[k] for k in sorted(chip_smoke.FLAGS) if k in os.environ},
        "nvidia_smi": chip_smoke.nvidia_smi_line(),
        "image_wall_s": wall_s,
        "profiled_image_wall_s": prof_wall_s,
        "device_kernel_ms": total_ms,
        "device_busy_share_profiled": total_ms / 1e3 / prof_wall_s,
        "families_ms": {k: {"ms": v[0], "launches": v[1], "share": v[0] / total_ms}
                        for k, v in sorted(fams.items(), key=lambda kv: -kv[1][0])},
        "top_kernels": [{"name": n[:120], "ms": v[0], "launches": v[1]} for n, v in top],
        "fused_group_norm_shapes": gn_shapes,
    }
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
