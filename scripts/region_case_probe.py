#!/usr/bin/env python3
"""The region combinator case that missed its bar once
(``tests/test_torch_regions.py::test_region_combinator_matches_jax[True-MultiDiffusion-False]``):
the port against ``mdu_tpu`` on the CPU, plain and with each piece of
shared state a test worker could carry forced on (a fused-blend flag, the
scan grid's threshold, bf16 matmul precision, 64-bit mode, ``disable_jit``,
executables loaded back from a persistent compile cache). Prints, for each,
the largest difference, the test's bar (1e-6 of the largest value) and the
largest value.

    JAX_PLATFORMS=cpu python3 scripts/region_case_probe.py
"""
import os
import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "tests"), str(ROOT)]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax._src import compilation_cache  # noqa: E402

import test_torch_regions as case  # noqa: E402
from mdu_tpu.tiling.schedulers import make_tiled_denoiser as jax_make  # noqa: E402
from mdu_tpu.tiling.schedulers import plan_tiled_diffusion as jax_plan  # noqa: E402
from mdu_tpu_torch import Method  # noqa: E402
from mdu_tpu_torch.tiling.schedulers import make_tiled_denoiser, plan_tiled_diffusion  # noqa: E402


def run(env=None):
    saved = dict(os.environ)
    os.environ.update(env or {})
    try:
        x = np.random.default_rng(0).normal(size=(2, 4, 16, 32)).astype(np.float32)
        kw = dict(tile_bs=2, draw_background=True)
        plan = plan_tiled_diffusion(Method.MULTI_DIFF, 16, 32, 16, 16, 8,
                                    regions=case.PLAN_REGIONS, **kw)
        jplan = jax_plan(Method.MULTI_DIFF, 16, 32, 16, 16, 8,
                         regions=[case.jspec(r) for r in case.PLAN_REGIONS], **kw)
        want = np.asarray(jax_make(
            jplan, lambda f, s, st, bb, bi: jnp.sin(f) * s + 0.1 * bi + 0.01 * bb[0].x,
            lambda xr, s, st, i: jnp.cos(xr) * s - 0.2 * i)(jnp.asarray(x), jnp.float32(1.5), 0))
        got = make_tiled_denoiser(
            plan, lambda f, s, st, bb, bi: torch.sin(f) * s + 0.1 * bi + 0.01 * bb[0].x,
            lambda xr, s, st, i: torch.cos(xr) * s - 0.2 * i)(
            torch.from_numpy(x), torch.tensor(1.5), 0).numpy()
    finally:
        os.environ.clear()
        os.environ.update(saved)
    scale = float(np.abs(want).max())
    return float(np.abs(got - want).max()), 1e-6 * scale, scale


def main():
    torch.set_num_threads(2)
    print("plain", run())
    print("MDU_FUSED_BLEND=interp", run({"MDU_FUSED_BLEND": "interp"}))
    print("MDU_TILE_SCAN_THRESHOLD=1", run({"MDU_TILE_SCAN_THRESHOLD": "1"}))
    with jax.default_matmul_precision("bfloat16"):
        print("bf16 matmul precision", run())
    with jax.enable_x64(True):
        print("64-bit mode", run())
    with jax.disable_jit():
        print("disable_jit", run())
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    with tempfile.TemporaryDirectory() as cache_dir:
        try:
            jax.config.update("jax_compilation_cache_dir", cache_dir)
            jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
            compilation_cache.reset_cache()
            jax.clear_caches()
            print("compiled into a persistent cache", run())
            jax.clear_caches()
            print("loaded back from it", run())
        finally:
            jax.config.update("jax_compilation_cache_dir", saved[0])
            jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])
            compilation_cache.reset_cache()


if __name__ == "__main__":
    main()
