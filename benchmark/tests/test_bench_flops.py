"""The analytic attention operations agree with ``FlopCounterMode`` over the
plain UNet's own attention products, at a tiny size; the image counts
follow the plan."""
from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import ROOT, TINY_UNET

from benchmark.harness.flops import image_flops, unet_call_flops, unet_calls
from benchmark.reference.nets import Precision, build


@pytest.mark.parametrize("config", ["sd15", "sdxl_base"])
def test_analytic_attention_matches_flop_counter(config):
    spec = json.loads((ROOT / f"benchmark/configs/{config}.json").read_text())["unet"]
    spec.update(TINY_UNET)
    if spec.get("head_dim"):
        spec.update(block_out_channels=[8, 16, 16], num_heads=None, head_dim=8,
                    addition_time_embed_dim=8, addition_pooled_dim=16)
    pooled = spec.get("addition_pooled_dim", 0) if spec.get("addition_embed_type") else 0
    unet = build("unet", spec, device="cpu")
    for p in unet.parameters():
        torch.nn.init.normal_(p, std=0.02)
    x = torch.randn(2, 4, 16, 24)
    t = torch.rand(2) * 900
    ctx = torch.randn(2, 7, spec["cross_attention_dim"])
    extra = (torch.randn(2, pooled), torch.ones(2, 6)) if pooled else (None, None)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        unet(Precision("fp32"), x, t, ctx, *extra)
    measured = counter.get_total_flops()
    analytic = unet_call_flops(json.dumps(spec, sort_keys=True), 2, 16, 24, 7, pooled)
    assert analytic == pytest.approx(measured, rel=1e-9)


def test_unet_calls_follow_the_plan():
    wl = {n: json.loads((ROOT / f"benchmark/workloads/{n}.json").read_text())
          for n in ("sd15_pano_md", "sdxl_pano_md", "sd15_upscale_mod", "sd15_regions_md")}
    counts = {n: len(unet_calls(w)) for n, w in wl.items()}
    assert counts == {"sd15_pano_md": 20, "sdxl_pano_md": 20, "sd15_upscale_mod": 38,
                      "sd15_regions_md": 120}
    assert unet_calls(wl["sd15_pano_md"])[0] == (10, 64, 96)
    assert sorted(set(unet_calls(wl["sd15_regions_md"]))) == [(2, 96, 96), (8, 96, 96),
                                                                  (10, 96, 96)]


def test_image_flops_of_the_panorama():
    wl = json.loads((ROOT / "benchmark/workloads/sd15_pano_md.json").read_text())
    cfg = json.loads((ROOT / "benchmark/configs/sd15.json").read_text())
    f = image_flops(wl, cfg)
    # about 1.1 TFLOP a 64x96 SD1.5 sample, 200 samples, plus one decode
    assert 180e12 < f["unet"] < 300e12
    assert 0 < f["vae"] < 0.1 * f["unet"]
