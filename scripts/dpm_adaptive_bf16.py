#!/usr/bin/env python3
"""DPM adaptive in bf16 on the card against the CPU, over several inputs.

    python3 scripts/dpm_adaptive_bf16.py [--seeds N]

For each of N noise seeds, the tiny pipeline of ``chip_smoke.py`` (untiled 32
x 32 latent, DPM adaptive over 3 steps, CFG 7) runs on the CPU in fp32 and in
bf16 and on the card in bf16, twice there: with PyTorch's default cuBLAS
setting, which lets a bf16 matmul reduce in reduced precision, and with
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`` off.
Each run records the controller's accept / reject decisions and the factor of
each (``sample_dpm_adaptive(decisions=, factors=)``). At the first decision
every run sees the same x, s and h, so the factors there differ by each
device's rounding of the bf16 model alone. Prints the card's name and power
limit as nvidia-smi gives them, then one JSON line per seed: the decision
counts, whether the decisions are the same, ``chip_smoke._first_difference``
of the default card run, and the first factor of every run with the gaps
|card - CPU bf16| and |CPU bf16 - CPU fp32| (bf16's rounding on the CPU);
then a summary line.
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run(device, dtype, seed, reduced=True):
    """(decisions, factors) of DPM adaptive on the tiny pipeline."""
    import torch

    import chip_smoke
    from mdu_tpu_torch import SamplerConfig
    from mdu_tpu_torch.samplers import samplers

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    pipe, c, u, gen = chip_smoke._tiny_pipeline(device, dtype)
    noise = torch.randn(1, 4, 32, 32, generator=torch.Generator().manual_seed(1000 + seed))
    decisions, factors = [], []
    adaptive = samplers.SAMPLERS["DPM adaptive"]
    samplers.SAMPLERS["DPM adaptive"] = functools.partial(adaptive, decisions=decisions,
                                                          factors=factors)
    try:
        pipe._txt2img_from_noise(noise, c, u, SamplerConfig(name="DPM adaptive", steps=3), 0,
                                 None, decode=False)
    finally:
        samplers.SAMPLERS["DPM adaptive"] = adaptive
    return decisions, factors


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=6)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("dpm_adaptive_bf16: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke
    from mdu_tpu_torch.ops.kernels import build

    build.build_all()
    print(chip_smoke.nvidia_smi_line())
    bf16, f32 = torch.bfloat16, torch.float32
    ratios, same, same_exact = [], 0, 0
    for seed in range(args.seeds):
        runs = {"cpu_fp32": run("cpu", f32, seed), "cpu_bf16": run("cpu", bf16, seed),
                "card_bf16": run("cuda", bf16, seed),
                "card_bf16_full_reduction": run("cuda", bf16, seed, reduced=False)}
        dec = {k: v[0] for k, v in runs.items()}
        fac = {k: v[1] for k, v in runs.items()}
        first = {k: v[0] for k, v in fac.items()}
        gap, rounding = (abs(first["card_bf16"] - first["cpu_bf16"]),
                         abs(first["cpu_bf16"] - first["cpu_fp32"]))
        ratios.append(gap / rounding if rounding else float("inf"))
        same += dec["card_bf16"] == dec["cpu_bf16"]
        same_exact += dec["card_bf16_full_reduction"] == dec["cpu_bf16"]
        diff = chip_smoke._first_difference(
            {("cuda", "bfloat16"): dec["card_bf16"], ("cpu", "bfloat16"): dec["cpu_bf16"],
             ("cpu", "float32"): dec["cpu_fp32"]},
            {("cuda", "bfloat16"): fac["card_bf16"], ("cpu", "bfloat16"): fac["cpu_bf16"],
             ("cpu", "float32"): fac["cpu_fp32"]})
        if diff is not None:
            for k in ("card_factors", "cpu_factors", "card_s", "cpu_s"):
                diff[k] = diff[k][-3:]
        print(json.dumps({"seed": seed, "decisions": {k: len(v) for k, v in dec.items()},
                          "card_decides_as_cpu_bf16": dec["card_bf16"] == dec["cpu_bf16"],
                          "fp32_decides_as_cpu_bf16": dec["cpu_fp32"] == dec["cpu_bf16"],
                          "first_factor": first, "first_factor_gap": gap,
                          "bf16_rounding_of_first_factor": rounding,
                          "full_reduction_gap": abs(first["card_bf16_full_reduction"]
                                                    - first["cpu_bf16"]),
                          "first_difference": diff}), flush=True)
    ratios.sort()
    print(json.dumps({"summary": True, "seeds": args.seeds, "card_decides_as_cpu": same,
                      "card_full_reduction_decides_as_cpu": same_exact,
                      "gap_over_rounding_sorted": ratios}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
