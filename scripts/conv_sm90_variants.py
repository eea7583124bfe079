#!/usr/bin/env python3
"""Time versions of the warpgroup form of the fused conv3x3 kernel (#6) against
each other, on the card, in one process.

    python3 scripts/conv_sm90_variants.py A.cu B.cu ...

Each argument is a version of ``mdu_tpu_torch/csrc/conv3x3.cu`` (for example
one taken from an earlier commit with ``git show <commit>:mdu_tpu_torch/csrc/
conv3x3.cu > _trees/conv_<commit>.cu``), compiled as the port builds its
kernels, with this tree's ``csrc/`` on the include path; each must export
``mdu_conv3x3_sm90`` with the port's signature. At config 2's four shapes and
one ragged shape every version is checked against the fp32 plain version
(within 2x the bf16 plain version's error + 1e-3, with and without the
activation) and timed with CUDA events over 30 launches, in turns (the
versions in order, then in reverse), with the activation and, once, without
it. Prints the ``nvidia-smi`` name and power limit, then one JSON line per
shape.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(10, 64, 96, 320, 320), (10, 64, 96, 640, 320), (10, 32, 48, 320, 640),
          (10, 32, 48, 640, 640), (2, 45, 21, 320, 200)]


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from mdu_tpu_torch.ops.kernels import build, fused_conv3x3_plain, pack_conv3x3_weight

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    out = Path(tempfile.mkdtemp())
    procs = {}
    for src in sys.argv[1:]:
        name = Path(src).stem
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler",
             "-fPIC", "-Xptxas", "-v", "-I", str(build.CSRC), "-o", str(out / f"{name}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log, file=sys.stderr)
            return 1
        print(name, json.dumps([ln for ln in build._ptxas_lines(log) if "sm90" in ln
                                or "spill" in ln or "registers" in ln][-8:]))
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))

    def call(lib, x, packed, a, sh, act):
        B, H, W, C = x.shape
        Co = packed.shape[0]
        y = torch.empty(B, H, W, Co, dtype=x.dtype, device="cuda")
        args = [ctypes.c_void_p(t.data_ptr()) for t in (x, packed, a, sh, y)]
        args += [ctypes.c_int(v) for v in (B, H, W, C, C, Co, int(act))]
        fn = lib.mdu_conv3x3_sm90
        fn.argtypes = [type(v) for v in args] + [ctypes.c_void_p]
        err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err != 0:
            raise RuntimeError(f"launch failed with cudaError {err}")
        return y

    def ms(fn, n=30):
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, H, W, C, Co in SHAPES:
        x = torch.randn(B, H, W, C, generator=gen, device="cuda").bfloat16()
        w = (torch.randn(3, 3, C, Co, generator=gen, device="cuda") / (9 * C) ** 0.5).bfloat16()
        a = 1 + 0.5 * torch.randn(B, C, generator=gen, device="cuda")
        sh = 0.2 * torch.randn(B, C, generator=gen, device="cuda")
        packed = pack_conv3x3_weight(w)
        res = {"shape": [B, H, W, C, Co]}
        for act in (True, False):
            ref = fused_conv3x3_plain(x.float(), w.float(), a, sh, fuse_act=act)
            bar = 2 * (fused_conv3x3_plain(x, w, a, sh, fuse_act=act).float() - ref
                       ).abs().max().item() + 1e-3
            for name, lib in libs.items():
                err = (call(lib, x, packed, a, sh, act).float() - ref).abs().max().item()
                if err > bar:
                    raise RuntimeError(f"{name} {res['shape']} act={act}: err {err} > {bar}")
                res[f"{name}_err_act{int(act)}"] = err
            res[f"bar_act{int(act)}"] = bar
        for name in list(libs) + list(libs)[::-1]:
            res.setdefault(f"{name}_ms", []).append(
                ms(lambda: call(libs[name], x, packed, a, sh, True)))
        for name in libs:
            res[f"{name}_noact_ms"] = ms(lambda: call(libs[name], x, packed, a, sh, False))
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
