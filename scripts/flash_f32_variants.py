#!/usr/bin/env python3
"""Time versions of the fp32 flash-attention forms against each other, on the card.

    python3 scripts/flash_f32_variants.py TREE [TREE ...]

Each TREE is a directory that holds ``mdu_tpu_torch/csrc`` (for example a
``git archive`` of one commit, unpacked into a directory that ``.gitignore``
lists). The script builds ``csrc/flash_attention_f32.cu`` of every tree with
nvcc (one process each, in parallel, into ``TREE/_variant_build``), checks
each version's tensor-core forms against the fp32 plain version at a few
shapes (1e-4), and times each at config 2's fp32 shapes: #1 (fixed shift) at
[10, 8, 6144, 40] and [10, 8, 1536, 80] in the sm90 form, #2 (online) at
[10, 8, 6144, 40] (sm90) and [2, 1, 9600, 512] (wide). Each version is timed
twice, in turns (first to last, then last to first), by CUDA events around
a loop of launches. SDPA's time on the same inputs is printed beside them.
Prints one JSON line per shape and, before them, the card's name and power
limit as nvidia-smi gives them.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [((10, 8, 6144, 40), True), ((10, 8, 1536, 80), True), ((10, 8, 6144, 40), False),
          ((2, 1, 9600, 512), False)]
CHECKS = [(1, 2, 513, 513, 40), (1, 1, 70, 90, 4), (2, 8, 1536, 1536, 80), (1, 1, 300, 300, 160),
          (1, 1, 1000, 1000, 512), (1, 1, 100, 130, 164)]


def build(trees):
    from mdu_tpu_torch.ops.kernels import build as kbuild

    procs = {}
    for tree in trees:
        out_dir = Path(tree) / "_variant_build"
        out_dir.mkdir(parents=True, exist_ok=True)
        out = out_dir / "libflash_attention_f32.so"
        cmd = [kbuild._nvcc(), *kbuild.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-o", str(out),
               str(Path(tree) / "mdu_tpu_torch" / "csrc" / "flash_attention_f32.cu")]
        procs[tree] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    libs = {}
    for tree, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tree}:\n{log}")
        libs[tree] = ctypes.CDLL(str(out))
    return libs


def run(lib, fixed, q, k, v):
    """One launch of the tensor-core form that the shape calls for."""
    import torch

    B, H, L, D = q.shape
    o = torch.empty_like(q)
    form = "sm90" if D <= 160 else "wide"
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p = [ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, o)]
    ints = [ctypes.c_int(x) for x in (B * H, L, k.shape[2], D)]
    scale = ctypes.c_float(D ** -0.5)
    if fixed:
        err = getattr(lib, f"mdu_flash_attention_fm_f32_{form}")(
            *p, *ints, scale, ctypes.c_float(30.0), ctypes.c_int(0), ctypes.c_int(0), stream)
    else:
        err = getattr(lib, f"mdu_flash_attention_f32_{form}")(*p, *ints, scale, stream)
    if err != 0:
        raise RuntimeError(f"launch failed with cudaError {err}")
    return o


def event_ms(fn, iters=5):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    trees = sys.argv[1:]
    import torch
    import torch.nn.functional as F

    if not trees or not torch.cuda.is_available():
        print(__doc__.strip().splitlines()[2], file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    from mdu_tpu_torch.ops.kernels import flash

    libs = build(trees)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, H, Lq, Lk, D in CHECKS:
        q = torch.randn(B, H, Lq, D, generator=gen, device="cuda")
        k, v = (torch.randn(B, H, Lk, D, generator=gen, device="cuda") for _ in range(2))
        for fixed in (True, False):
            plain = flash.flash_attention_fm_plain if fixed else flash.flash_attention_plain
            ref = plain(q, k, v)
            for tree, lib in libs.items():
                err = (run(lib, fixed, q, k, v) - ref).abs().max().item()
                if not err <= 1e-4:
                    raise RuntimeError(f"{tree} {(B, H, Lq, Lk, D)} fixed={fixed}: err {err}")
    for shape, fixed in SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
        ms = {tree: [] for tree in libs}
        for order in (list(libs), list(libs)[::-1]):
            for tree in order:
                ms[tree].append(event_ms(lambda: run(libs[tree], fixed, q, k, v)))
        print(json.dumps(dict(shape=list(shape), fixed_shift=fixed, ms=ms,
                              sdpa_ms=event_ms(lambda: F.scaled_dot_product_attention(q, k, v)))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
