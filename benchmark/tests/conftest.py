"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with a
tiny configuration and tiny cells, so that a whole run (set-up, window,
judge) takes seconds on the CPU."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_UNET = {"block_out_channels": [8, 16, 16, 16], "cross_attention_dim": 16, "num_heads": 2,
             "norm_num_groups": 4}
TINY_VAE = {"block_out_channels": [8, 8, 16, 16], "norm_num_groups": 4}


def tiny_cell(root: Path, base: str, name: str, limits=None) -> None:
    """Add ``name``, the cell ``base`` cut to a tiny configuration and a few
    steps, to the benchmark copy at ``root``."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "benchmark/configs/sd15.json").read_text())
    cfg["name"] = "tiny"
    cfg["unet"].update(TINY_UNET)
    cfg["vae"].update(TINY_VAE)
    (root / "benchmark/configs/tiny.json").write_text(json.dumps(cfg))
    if not any(c["name"] == "tiny" for c in manifest["configs"]):
        manifest["configs"].append({"name": "tiny", "source": "tests", "reduced": [],
                                    "file": "benchmark/configs/tiny.json", "why": "tests"})
    wl = json.loads((root / f"benchmark/workloads/{base}.json").read_text())
    wl["config"] = "tiny"
    wl["sampler"]["steps"] = 4
    td, tv = wl["tiled_diffusion"], wl["tiled_vae"]
    if wl["entry"] == "img2img":
        wl["image"]["size"] = 64
        td.update(tile_w=16, tile_h=16, overlap=4)
        tv.update(encoder_tile_size=128, decoder_tile_size=16)
    else:
        wl.update(width=384 if not td.get("regions") else 256,
                  height=128 if not td.get("regions") else 256)
        td.update(tile_w=16, tile_h=16, overlap=8)
        tv["decoder_tile_size"] = 16
    if limits is not None:
        wl["limits"] = limits
    (root / f"benchmark/workloads/{name}.json").write_text(json.dumps(wl))
    manifest["workloads"].append({"name": name, "config": "tiny", "traffic": name, "chips": 1,
                                  "why": "tests"})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))


@pytest.fixture
def bench_copy(tmp_path) -> Path:
    """A copy of ``BENCHMARK.json`` and ``benchmark/``."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache", "tests"))
    return tmp_path
