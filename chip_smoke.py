#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``mdu_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:

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
                 Times from CUDA events: kernel, plain version, and
                 ``F.scaled_dot_product_attention`` as a yardstick only (the
                 port never calls it), beside the bound
                 max(flops / peak, bytes / 3.35 TB/s), peak 989 TF/s in bf16
                 and 67 TF/s in fp32.
4. ``reference`` a tiny pipeline, sized so that its attention reaches the
                 flash kernels, on the card against the same pipeline on the
                 CPU: fp32 within 1e-4 of the largest value; bf16 within 2x
                 the CPU bf16 run's error against CPU fp32, + 1e-3 of it.
5. ``txt2img``   config 2 through ``DiffusionPipeline.txt2img``: SD1.5 UNet and
                 VAE with random bf16 weights, MultiDiffusion at 2048 x 512
                 (tile 96, overlap 48, tile_bs 8), Euler 20 steps at CFG 7,
                 exact tiled decode (tile 128). Launch counts are set to 0
                 just before each image and read just after; a kernel of the
                 path launched 0 times fails the run.

Then a ``done`` line with the script's seconds, a ``{"kernels": [...]}`` line
(the kernels of the main path), the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that.
TF32 is off for matmuls and convolutions.
"""
from __future__ import annotations

import json
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
EXPECTED_LAUNCHES = {"flash_attention_fm": 200, "flash_attention": 1}
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


def attention_bound(B, H, L, D, itemsize=2):
    flops = 4.0 * B * H * L * L * D                 # QK^T and PV
    nbytes = 4.0 * B * H * L * D * itemsize         # q, k, v read; o written
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _time_check(kernel, plain, q, k, v, iters):
    import torch.nn.functional as F

    ms = cuda_ms(lambda: kernel(q, k, v), iters)
    plain_ms = cuda_ms(lambda: plain(q, k, v), 3, warmup=1)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters)
    return ms, plain_ms, lib_ms


def phase_kernels():
    """bf16 kernels at every shape of KERNELS, fp32 kernels at the first."""
    import torch

    from mdu_tpu_torch.ops.kernels import flash

    fns = {"flash_attention_fm": (flash.flash_attention_fm, flash.flash_attention_fm_plain),
           "flash_attention": (flash.flash_attention, flash.flash_attention_plain)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {}
    for name, spec in KERNELS.items():
        kernel, plain = fns[name]
        for dtype in (torch.bfloat16, torch.float32):
            key = name if dtype == torch.bfloat16 else name + "_f32"
            shapes = spec["shapes"] if dtype == torch.bfloat16 else spec["shapes"][:1]
            checks = []
            for shape in shapes:
                B, H, L, D = shape
                q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                           for _ in range(3))
                out = kernel(q, k, v)
                torch.cuda.synchronize()
                ref = plain(q.float(), k.float(), v.float())
                err = (out.float() - ref).abs().max().item()
                if dtype == torch.bfloat16:
                    # the bf16 plain version's own error against fp32 sets the bar
                    err_plain = (plain(q, k, v).float() - ref).abs().max().item()
                    tol = 2.0 * err_plain + 1e-3
                else:
                    err_plain, tol = 0.0, F32_TOL
                require(bool(torch.isfinite(out).all()), f"{key} {shape}: non-finite output")
                require(err <= tol, f"{key} {shape}: max abs err {err} > {tol}")
                big = L * L * B * H > 1e8
                iters = (20 if big else 50) if dtype == torch.bfloat16 else (3 if big else 10)
                ms, plain_ms, lib_ms = _time_check(kernel, plain, q, k, v, iters)
                bound_ms, bound_by = attention_bound(B, H, L, D, q.element_size())
                check = dict(shape=list(shape), dtype=str(dtype).split(".")[-1],
                             max_abs_err=err, plain_err=err_plain, tol=tol, ms=ms,
                             plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
                emit("kernel_check", name=key, **check)
                checks.append(check)
                del q, k, v, out, ref
            summary[key] = checks
    return summary


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
    1e-3 of the largest value. Each card run must launch its fm kernel."""
    import torch

    from mdu_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    ref = _tiny_run("cpu", torch.float32)
    ref_bf16 = _tiny_run("cpu", torch.bfloat16)
    for dtype, key in ((torch.float32, "flash_attention_fm_f32"),
                       (torch.bfloat16, "flash_attention_fm")):
        reset_launches()
        got = _tiny_run("cuda", dtype)
        launches = dict(LAUNCHES)
        require(launches[key] > 0, f"tiny {dtype} pipeline launched no {key}")
        fields = {"launches": launches}
        for i, part in enumerate(("latent", "image")):
            scale = ref[i].abs().max().item()
            err = (got[i] - ref[i]).abs().max().item()
            if dtype == torch.float32:
                tol = 1e-4 * scale
            else:
                tol = 2.0 * (ref_bf16[i] - ref[i]).abs().max().item() + 1e-3 * scale
            require(bool(torch.isfinite(got[i]).all()), f"tiny {dtype} {part}: non-finite")
            require(err <= tol, f"tiny {dtype} {part}: max abs err {err} > {tol}")
            fields.update({f"{part}_max_abs_err": err, f"{part}_tol": tol})
        emit("reference", dtype=str(dtype).split(".")[-1], **fields)


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


def phase_txt2img():
    import torch

    from mdu_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    pipe, cond, uncond, sp, td, tv = build_config2()
    setup_s = time.perf_counter() - t0

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
    for name in EXPECTED_LAUNCHES:
        require(launches[name] > 0, f"{name} was launched 0 times on the main path")
    require(tuple(res.images.shape) == (1, 512, 2048, 3),
            f"output shape {tuple(res.images.shape)}")
    require(bool(torch.isfinite(res.latents).all()), "non-finite latents")

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    n = 2
    t0 = time.perf_counter()
    for seed in range(1, n + 1):
        res = image(seed)
    timed_s = time.perf_counter() - t0
    per_image = {k: v / n for k, v in LAUNCHES.items()}
    require(per_image == launches, f"launches per image differ: {per_image} vs {launches}")
    emit("txt2img", config="config 2: MultiDiffusion txt2img 2048x512, SD1.5 bf16",
         sampler=sp.name, steps=sp.steps, cfg_scale=sp.cfg_scale,
         tile=[td.tile_h, td.tile_w], overlap=td.overlap, tile_bs=td.tile_bs,
         decoder_tile=tv.decoder_tile_size, setup_s=setup_s, first_image_s=first_s,
         img_per_min=60.0 * n / timed_s, seconds_per_image=timed_s / n,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         output_shape=list(res.images.shape), finite=True,
         launches_per_image=launches, expected_launches=EXPECTED_LAUNCHES)
    return launches


def main() -> int:
    t_start = time.perf_counter()
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

    checks = phase_kernels()
    emit("kernels", kernels={k: [dict(shape=c["shape"], max_abs_err=c["max_abs_err"],
                                      tol=c["tol"]) for c in v]
                             for k, v in checks.items()})
    phase_reference()
    launches = phase_txt2img()

    rows = []
    for name, spec in KERNELS.items():
        main = checks[name][0]          # the first shape: the main path's largest
        rows.append(dict(name=name, route="cuda", source=spec["source"],
                         replaces=spec["replaces"], launches=launches[name],
                         max_abs_err=max(c["max_abs_err"] for c in checks[name]),
                         ms=main["ms"], plain_ms=main["plain_ms"],
                         bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                         library_ms=main["library_ms"], shape=main["shape"]))
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
