"""A whole run on the CPU (no look for a card) at a tiny size, sound and with
the timed path broken underneath: ``correct`` comes out true for the sound
program and false for each fault a cell of this benchmark can have (a step
that returns its state unchanged; half of each tile batch left out, the
mean taken over the rest; an answer altered where it is produced). The
control, the plain reference computed in float8 in the program's place,
fails the tiny cell's limits too."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from conftest import tiny_cell

from benchmark.harness import runner

# set from the tiny cells' own readings on the CPU (program: step_err 0.10 to
# 0.30, decode_rms 0.68 to 0.88; float8 control 0.91 and 7.3)
TINY_LIMITS = {"step_err": 0.6, "decode_rms": 3.0}
TINY_LIMITS_IMG2IMG = dict(TINY_LIMITS, start_err=0.5)


def state_unchanged(monkeypatch):
    from mdu_tpu_torch.pipeline import DiffusionPipeline

    monkeypatch.setattr(DiffusionPipeline, "_make_denoised_fn",
                        lambda self, *a, **kw: (lambda x, sigma, step: x))


def half_the_batch(monkeypatch):
    from mdu_tpu_torch import pipeline
    from mdu_tpu_torch.utils.grid import batch_bboxes, paint_count

    plan_fn = pipeline.plan_tiled_diffusion

    def half(*a, **kw):
        p = plan_fn(*a, **kw)
        kept = [b for bb in p.batched for b in bb[:max(1, len(bb) // 2)]]
        return dataclasses.replace(p, bboxes=tuple(kept), batched=tuple(
            tuple(b) for b in batch_bboxes(kept, p.tile_bs)),
            weights=paint_count(p.w, p.h, kept))

    monkeypatch.setattr(pipeline, "plan_tiled_diffusion", half)


def answer_altered(monkeypatch):
    from mdu_tpu_torch.pipeline import DiffusionPipeline

    decode = DiffusionPipeline._decode

    def altered(self, *a, **kw):
        img = decode(self, *a, **kw).copy()
        h = img.shape[1] // 2
        img[:, :h] = np.clip(img[:, :h].astype(np.int32) + 24, 0, 255).astype(np.uint8)
        return img

    monkeypatch.setattr(DiffusionPipeline, "_decode", altered)


FAULTS = {"state_unchanged": state_unchanged, "half_the_batch": half_the_batch,
          "answer_altered": answer_altered}


@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_correct_reads_the_timed_path(bench_copy, monkeypatch, fault):
    tiny_cell(bench_copy, "sd15_pano_md", "tiny_pano", TINY_LIMITS)
    if fault is not None:
        FAULTS[fault](monkeypatch)
    out = runner.run("tiny_pano", 31_415_926_535, 4.0, False, "cpu", bench_copy)
    assert out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert out["correct"] is (fault is None), out["checks"]


@pytest.mark.parametrize("base,limits", [("sd15_upscale_mod", TINY_LIMITS_IMG2IMG),
                                         ("sd15_regions_md", TINY_LIMITS)])
def test_the_other_entries_judge_correct(bench_copy, base, limits):
    tiny_cell(bench_copy, base, "tiny_cell", limits)
    out = runner.run("tiny_cell", 27_182_818_284, 6.0, True, "cpu", bench_copy)
    assert out["correct"] is True, out["checks"]
    assert set(out["checks"]) >= set(limits)
    # inversion 10 steps x 2 tile batches + 2 sampling steps x 2; 4 steps x
    # (2 tile batches + 4 regions)
    assert out["metrics"]["unet_calls_per_image"]["value"] == (
        10 * 2 + 2 * 2 if base == "sd15_upscale_mod" else 4 * (2 + 4))


def test_the_control_fails(bench_copy):
    import torch

    from benchmark.harness import inputs
    from benchmark.harness.manifest import load_cell
    from benchmark.reference.judge import Reference, judge, verdict
    from benchmark.reference.nets import shapes_of

    tiny_cell(bench_copy, "sd15_pano_md", "tiny_pano", TINY_LIMITS)
    cell = load_cell("tiny_pano", bench_copy)
    cfg, wl = cell.config, cell.workload
    shapes = ([("unet." + n, s) for n, s in shapes_of("unet", cfg["unet"])]
              + [("vae." + n, s) for n, s in shapes_of("vae", cfg["vae"])])
    for seed in (11, 12, 13):
        weights = inputs.make_weights(shapes, seed, torch.bfloat16, "cpu")
        conds = inputs.make_conds(wl, cfg, seed, torch.bfloat16, "cpu")
        control = Reference(cfg, wl, weights, conds, "cpu", precision="fp8")
        with torch.no_grad():
            traj, latents, image = control.generate(seed)
        numbers = judge(Reference(cfg, wl, weights, conds, "cpu"), seed, traj, latents, image[0])
        assert not verdict(numbers, TINY_LIMITS), numbers
