"""One short run of each cell on the card (skips without one): the result
line's shape, and ``correct``."""
from __future__ import annotations

import pytest

from conftest import ROOT

from benchmark.harness import runner
from benchmark.harness.manifest import load_manifest

CELLS = [w["name"] for w in load_manifest(ROOT)["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = runner.run(cell, 1_234_567_890_123, 5.0, False, "cuda", ROOT)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert out["device"]["platform"] == "gpu"
    assert out["correct"] is True, out["checks"]
