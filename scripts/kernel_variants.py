#!/usr/bin/env python3
"""Time versions of the port's CUDA kernels against each other, on the card.

    python3 scripts/kernel_variants.py [--iters N] --case CASE [--case CASE ...] TREE [TREE ...]

Each TREE is a directory that holds ``mdu_tpu_torch/csrc``: ``.`` for this
checkout, or a ``git archive`` of another commit unpacked into a directory
that ``.gitignore`` lists (``_trees/``). The script builds, for every tree,
the kernel libraries that the cases need (one nvcc per tree and source, all
at once, into ``TREE/_variant_build``) and launches each tree's library
through this checkout's wrappers, so a tree's entry points must keep this
checkout's C signatures.

A CASE is ``KERNEL.FORM:SHAPE[:KEY=VALUE...]``:

* attention, ``flash_attention_fm``, ``flash_attention``,
  ``flash_attention_t`` (bf16; the forms of ``flash.FORMS``) and
  ``flash_attention_fm_f32``, ``flash_attention_f32`` (fp32; ``sm90``,
  ``wide``, ``simt``): SHAPE ``B,H,L,D`` or ``B,H,Lq,Lk,D``; options
  ``scale``, ``smax``, ``clamp``, ``bf16_exp`` (``flash_attention_fm*``),
  and ``qscale``, a factor on q (random q and k give scores of std 1 at the
  default scale; ``qscale=3`` sharpens the softmax and enlarges the output).
  With ``bf16_exp=1`` q and k are small integers and the scale D^-0.5
  rounded down to a power of two, so that no score is ambiguous (as in
  ``chip_smoke.py``);
* the fused conv, ``fused_conv3x3`` (bf16; ``sm90``, ``mma``) and
  ``fused_conv3x3_f32`` (fp32; ``sm90``, ``simt``): SHAPE ``B,H,W,C,Co``;
  option ``fuse_act`` (default 1);
* the fused GroupNorm, ``fused_group_norm`` (bf16) and
  ``fused_group_norm_f32`` (``cluster``, ``two_read``): SHAPE ``B,C,H,W``,
  32 groups; the cluster form takes this checkout's split
  (``cluster_split``).

For example ``--case flash_attention.wide:2,1,9600,512 --case
fused_conv3x3_f32.sm90:10,64,96,320,320:fuse_act=0``. Every output is held
against the plain version in fp32 on the same inputs (bf16: 2x the bf16
plain version's error + 1e-3; fp32: 1e-4); the verdict is printed, not
enforced, so that a version that misses the bar is still timed. Each version
is timed twice, in turns (first tree to last, then last to first), by CUDA
events around a loop of ``--iters`` launches (``ms``) and by torch.profiler's
kernel durations over as many (``device_ms``, which leaves out the host's
time between launches). Prints the card's name and
power limit as nvidia-smi gives them, then one JSON line per case.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = 1e-4


def parse_case(text: str):
    """(kernel, form, shape, options) of one ``KERNEL.FORM:SHAPE[:K=V...]``."""
    head, shape, *opts = text.split(":")
    kernel, form = head.rsplit(".", 1)
    options = {}
    for opt in opts:
        key, value = opt.split("=")
        options[key] = (bool(int(value)) if key in ("clamp", "bf16_exp", "fuse_act")
                        else float(value))
    return kernel, form, tuple(int(n) for n in shape.split(",")), options


def attention_case(kernel, form, shape, opts, gen):
    """(library, launch, reference, bar) of one attention case."""
    import torch

    from mdu_tpu_torch.ops.kernels import flash

    f32 = kernel.endswith("_f32")
    B, H, Lq, *rest = shape
    Lk, D = (rest[0], rest[1]) if len(rest) == 2 else (Lq, rest[0])
    dtype = torch.float32 if f32 else torch.bfloat16
    q = torch.randn(B, H, Lq, D, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(B, H, Lk, D, generator=gen, device="cuda").to(dtype) for _ in range(2))
    if opts.get("bf16_exp"):
        q = torch.randint(-2, 3, q.shape, generator=gen, device="cuda").to(dtype)
        k = torch.randint(-2, 3, k.shape, generator=gen, device="cuda").to(dtype)
        opts.setdefault("scale", 2.0 ** -math.ceil(math.log2(D) / 2))
    q = q * opts.pop("qscale", 1.0)
    plain = {"flash_attention_fm": flash.flash_attention_fm_plain,
             "flash_attention": flash.flash_attention_plain,
             "flash_attention_t": flash.flash_attention_t_plain}[kernel.removesuffix("_f32")]
    if f32:
        library = "flash_attention_f32"
        run = lambda: flash.launch_f32_form(kernel, form, q, k, v, **opts)
    else:
        library = flash.FORMS[kernel][form][0]
        run = lambda: flash.launch_form(kernel, form, q, k, v, **opts)
    ref = plain(q.float(), k.float(), v.float(), **opts)
    bar = F32_TOL if f32 else 2 * (plain(q, k, v, **opts).float() - ref).abs().max().item() + 1e-3
    return library, run, ref, bar


def conv_case(kernel, form, shape, opts, gen):
    """(library, launch, reference, bar) of one fused-conv case."""
    import torch

    from mdu_tpu_torch.ops.kernels import conv3x3

    f32 = kernel.endswith("_f32")
    B, H, W, C, Co = shape
    act = opts.get("fuse_act", True)
    dtype = torch.float32 if f32 else torch.bfloat16
    x = torch.randn(B, H, W, C, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(3, 3, C, Co, generator=gen, device="cuda") / (9 * C) ** 0.5).to(dtype)
    a = 1 + 0.5 * torch.randn(B, C, generator=gen, device="cuda")
    sh = 0.2 * torch.randn(B, C, generator=gen, device="cuda")
    packed = conv3x3.pack_conv3x3_weight(w)
    launch = conv3x3.launch_f32_form if f32 else conv3x3.launch_form
    run = lambda: launch(form, x, packed, a, sh, act)
    ref = conv3x3.fused_conv3x3_plain(x.float(), w.float(), a, sh, fuse_act=act)
    bar = F32_TOL if f32 else 2 * (conv3x3.fused_conv3x3_plain(x, w, a, sh, fuse_act=act)
                                   .float() - ref).abs().max().item() + 1e-3
    return "conv3x3", run, ref, bar


def gn_case(kernel, form, shape, opts, gen):
    """(library, launch, reference, bar) of one GroupNorm case."""
    import torch

    from mdu_tpu_torch.ops.kernels import group_norm

    dtype = torch.float32 if kernel.endswith("_f32") else torch.bfloat16
    x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1).to(dtype)
    w = (1 + 0.2 * torch.randn(shape[1], generator=gen, device="cuda")).to(dtype)
    b = (0.2 * torch.randn(shape[1], generator=gen, device="cuda")).to(dtype)
    run = lambda: group_norm.launch_form(form, x, 32, w, b)
    ref = group_norm.fused_group_norm_plain(x.float(), 32, w.float(), b.float())
    bar = F32_TOL if dtype == torch.float32 else 2 * (group_norm.fused_group_norm_plain(
        x, 32, w, b).float() - ref).abs().max().item() + 1e-3
    return "group_norm", run, ref, bar


def build(trees, libraries):
    """{(tree, library): loaded library}, one nvcc each, all started at once."""
    from mdu_tpu_torch.ops.kernels import build as kbuild

    procs = {}
    for tree in trees:
        out_dir = Path(tree) / "_variant_build"
        out_dir.mkdir(parents=True, exist_ok=True)
        for library in libraries:
            out = out_dir / f"lib{library}.so"
            src = Path(tree) / "mdu_tpu_torch" / "csrc" / kbuild.SOURCES[library]
            cmd = [kbuild._nvcc(), *kbuild.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                   "-Xcompiler", "-fPIC", "-o", str(out), str(src)]
            procs[tree, library] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for key, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(out))
    return libs


def events_ms(fn, iters: int) -> float:
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--case", action="append", required=True)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke
    from mdu_tpu_torch.ops.kernels import build as kbuild

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for text in args.case:
        kernel, form, shape, opts = parse_case(text)
        make = (conv_case if kernel.startswith("fused_conv3x3") else
                gn_case if kernel.startswith("fused_group_norm") else attention_case)
        cases.append((text, *make(kernel, form, shape, opts, gen)))
    libs = build(args.trees, sorted({case[1] for case in cases}))

    def version(tree, library, run):
        def call():
            kbuild._LIBS[library] = libs[tree, library]
            return run()
        return call

    for text, library, run, ref, bar in cases:
        calls = {tree: version(tree, library, run) for tree in args.trees}
        errs = {tree: (call().float() - ref).abs().max().item() for tree, call in calls.items()}
        times = {tree: [] for tree in args.trees}
        dev = {tree: [] for tree in args.trees}
        for order in (args.trees, args.trees[::-1]):
            for tree in order:
                times[tree].append(events_ms(calls[tree], args.iters))
                dev[tree].append(chip_smoke.device_ms(calls[tree], args.iters))
        print(json.dumps({"case": text, "bar": bar, "versions": [
            {"tree": t, "ms": times[t], "device_ms": dev[t], "max_abs_err": errs[t],
             "within_bar": errs[t] <= bar} for t in args.trees]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
