#!/usr/bin/env python3
"""Config-2 images per minute of the PyTorch port under each kernel flag, on
the card.

    python3 scripts/flags_torch_config2.py [--images N] [--out PATH]

Builds config 2 exactly as ``chip_smoke.py`` does (SD1.5 bf16 random
weights, MultiDiffusion 2048 x 512, Euler 20 steps at CFG 7, exact tiled
decode), then runs it under these settings of the JAX package's flags, in
this order and then in reverse (so that each setting is measured twice, in
turns): none; all four (MDU_FLASH=trans MDU_FUSED_GN=1 MDU_FUSED_CONV=1
MDU_FUSED_BLEND=1); each of the four alone. Each run is 1 warm image and
``--images`` timed ones (host clock ending in a synchronize), with the peak
device memory of the timed ones and the kernel launches per image. Prints one
JSON line (also written to PATH with --out). TF32 is off.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ALL = {"MDU_FLASH": "trans", "MDU_FUSED_GN": "1", "MDU_FUSED_CONV": "1",
       "MDU_FUSED_BLEND": "1"}
SETTINGS = [("none", {}), ("all", ALL)] + [(k, {k: v}) for k, v in ALL.items()]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=2, help="timed images a run")
    ap.add_argument("--out", help="also write the result as JSON to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("flags_torch_config2: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke

    from mdu_tpu_torch.ops.kernels import LAUNCHES, build, reset_launches

    build.build_all()
    for k in ALL:
        os.environ.pop(k, None)
    pipe, cond, uncond, sp, td, tv = chip_smoke.build_config2()

    def image(seed):
        res = pipe.txt2img(cond, uncond, width=2048, height=512, sampler=sp, seed=seed,
                           tiled_diffusion=td, tiled_vae=tv)
        torch.cuda.synchronize()
        return res

    runs = []
    for label, flags in SETTINGS + SETTINGS[::-1]:
        with chip_smoke.flags_set(flags):
            reset_launches()
            res = image(0)                            # warm
            launches = {k: v for k, v in LAUNCHES.items() if v}
            if not bool(torch.isfinite(res.latents).all()):
                raise RuntimeError(f"{label}: non-finite latents")
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for seed in range(1, args.images + 1):
                image(seed)
            s = (time.perf_counter() - t0) / args.images
        runs.append(dict(setting=label, flags=flags, seconds_per_image=s,
                         img_per_min=60.0 / s,
                         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                         launches_per_image=launches))
        print(json.dumps({"run": runs[-1]}), flush=True)
    by = {}
    for r in runs:
        by.setdefault(r["setting"], []).append(r["img_per_min"])
    result = {"device": torch.cuda.get_device_name(0),
              "nvidia_smi": chip_smoke.nvidia_smi_line(),
              "timed_images_per_run": args.images,
              "img_per_min": {k: v for k, v in by.items()}, "runs": runs}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
