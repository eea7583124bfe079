"""Readings that a cell's limits are set from, on the card, in one process:

* the program: for each of ``--seeds`` run seeds, the weights and conds of
  that seed, one image through the timed entry at the cell's own size, and
  the judge's numbers for it (``lower``: the largest over the seeds);
* the control: for each of ``--controls`` seeds, the plain reference
  computed in float8 (e4m3, one scale a tensor) in the program's place,
  judged the same way (``upper``: the smallest over the seeds).

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 --controls 3

Prints one JSON line a reading and a summary line last.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=7_000_000_001)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark.harness import inputs
    from benchmark.harness.manifest import load_cell
    from benchmark.harness.program import Program
    from benchmark.reference.judge import Reference, judge
    from benchmark.reference.nets import shapes_of

    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, ROOT)
    wl, cfg = cell.workload, cell.config
    dev = torch.device(args.device)
    dtype = getattr(torch, cfg["dtype"])
    img2img = wl["entry"] == "img2img"
    shapes = ([("unet." + n, s) for n, s in shapes_of("unet", cfg["unet"])]
              + [("vae." + n, s) for n, s in shapes_of("vae", cfg["vae"])])

    def free():
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    readings = {"program": [], "control": []}
    for kind, n in (("program", args.seeds), ("control", args.controls)):
        for i in range(n):
            seed = inputs.derive(args.first_seed, (0 if kind == "program" else 500) + i, 62)
            t0 = time.perf_counter()
            weights = inputs.make_weights(shapes, seed, dtype, dev)
            conds = inputs.make_conds(wl, cfg, seed, dtype, dev)
            s_k = inputs.image_seed(seed, 0)
            inp = inputs.make_image(wl, s_k) if img2img else None
            if kind == "program":
                prog = Program(cfg, wl, weights, conds, dev)
                res = prog.image(s_k, inp, capture=True)
                traj, latents, image, ok = res.traj, res.latents, res.image, res.ok
                prog.close()
                del prog, res
            else:
                ctl = Reference(cfg, wl, weights, conds, dev, precision="fp8")
                with torch.no_grad():
                    traj, latents, image = ctl.generate(s_k, inp)
                image, ok = image[0], True
                del ctl
            free()
            t1 = time.perf_counter()
            ref = Reference(cfg, wl, weights, conds, dev)
            del weights
            numbers = judge(ref, s_k, traj, latents, image, inp)
            del ref, traj, latents
            free()
            readings[kind].append(numbers)
            print(json.dumps({"kind": kind, "seed": seed, "ok": ok, "numbers": numbers,
                              "make_s": t1 - t0, "judge_s": time.perf_counter() - t1}),
                  flush=True)
    keys = sorted({k for r in readings["program"] + readings["control"] for k in r})
    summary = {k: {"lower": max((r[k] for r in readings["program"] if k in r), default=None),
                   "upper": min((r[k] for r in readings["control"] if k in r), default=None)}
               for k in keys}
    print(json.dumps({"kind": "summary", "workload": args.workload, "readings": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
