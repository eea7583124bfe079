#!/usr/bin/env python3
"""The host's part of a call of the small kernels (#4, #5), in several source
trees, on the card.

    python3 scripts/host_cost.py [--iters N] TREE [TREE ...]

Each TREE holds a copy of the port: ``.`` for this checkout, or a ``git
archive`` of another commit unpacked into a directory that ``.gitignore``
lists (``_trees/``). For every tree in turns (first to last, then last to
first) a fresh process imports that tree's ``mdu_tpu_torch``, builds its
kernel libraries, and calls #4 (bf16, config 2's [10, 320, 64, 96] and [10,
1280, 8, 12], groups 32) and #5 (config 2's canvas: 5 tiles [4, 64, 96] onto
[4, 64, 256], fp32, normalize False, as the scheduler calls it) through the
tree's own wrappers: ``ms`` by CUDA events around a loop of calls,
``device_ms`` by torch.profiler's kernel durations per call, and ``host_ms``
= ms - device_ms, the time of a call that the device does not hide. Prints
the card's name and power limit as nvidia-smi gives them, then one JSON line
per tree and turn.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one_tree(tree: str, iters: int) -> dict:
    """The cases, timed through the port of ``tree`` (imported from there)."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    import chip_smoke
    import mdu_tpu_torch
    from mdu_tpu_torch.ops.kernels import BlendTable, fused_group_norm, fused_tile_blend
    from mdu_tpu_torch.utils.grid import paint_count, split_grid

    got = Path(mdu_tpu_torch.__file__).resolve().parents[1]
    if got != Path(tree).resolve():
        raise RuntimeError(f"imported the port from {got}, not {tree}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {}
    for shape in ((10, 320, 64, 96), (10, 1280, 8, 12)):
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.ones(shape[1], device="cuda", dtype=torch.bfloat16)
        b = torch.zeros(shape[1], device="cuda", dtype=torch.bfloat16)
        cases[f"fused_group_norm {list(shape)} bf16"] = (
            lambda x=x, w=w, b=b: fused_group_norm(x, 32, w, b, 1e-6))
    bbs = split_grid(256, 64, 96, 64, 48)
    table = BlendTable(64, 256, bbs)
    tiles = torch.randn(len(bbs), 4, 64, 96, generator=gen, device="cuda")
    wts = torch.as_tensor(paint_count(256, 64, bbs)[0, 0], device="cuda")
    cases["fused_tile_blend 5 x [4, 64, 96] -> [4, 64, 256] fp32"] = (
        lambda: fused_tile_blend(tiles, wts, 64, 256, bbs, False, table))
    out = {}
    for name, fn in cases.items():
        ms = chip_smoke.cuda_ms(fn, iters, warmup=5)
        dev = chip_smoke.device_ms(fn, iters)
        out[name] = {"ms": ms, "device_ms": dev, "host_ms": None if dev is None else ms - dev}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one_tree(args.trees[0], args.iters)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("host_cost: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    for turn, order in enumerate((args.trees, args.trees[::-1])):
        for tree in order:
            res = subprocess.run([sys.executable, __file__, "--one", "--iters", str(args.iters),
                                  tree], capture_output=True, text=True, cwd=ROOT)
            if res.returncode != 0:
                print(res.stderr, file=sys.stderr)
                return res.returncode
            print(json.dumps({"tree": tree, "turn": turn,
                              "cases": json.loads(res.stdout.strip().splitlines()[-1])}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
