"""The manifest and the files it names: every cell, configuration and
metric is found by name, the manifest keeps its documented format and
limits, and a cell added as files is found without an edit."""
from __future__ import annotations

import json
import re

from conftest import ROOT, tiny_cell

from benchmark.harness.manifest import all_cells, load_cell, load_manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_and_metric_is_found_by_name():
    cells = all_cells(ROOT)
    manifest = load_manifest(ROOT)
    assert set(cells) == {w["name"] for w in manifest["workloads"]}
    for name, cell in cells.items():
        assert cell.workload["config"] == cell.entry["config"]
        assert cell.config["name"] == cell.entry["config"]
        assert cell.reported(False) and cell.reported(True)
        assert any(m.name == "setup_s" for m in cell.reported(False))
        for m in cell.metrics:
            assert callable(m.read)


def test_manifest_format():
    m = load_manifest(ROOT)
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert m["paths"] == ["benchmark"] and m["command"][1].startswith("benchmark/")
    assert 1 <= m["run_seconds"] <= 51
    assert 2 + 14 * 24 * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = set()
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for kind in ("end_to_end", "per_layer"):
        for metric in m[kind]:
            assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
            assert metric["better"] in ("lower", "higher")
            assert metric["name"] not in names
            names.add(metric["name"])
            if kind == "end_to_end":
                assert metric["source"] in ("host_clock", "device_trace")
                assert 0.01 <= metric["bound"] <= 0.25
            else:
                assert metric["moves"] in {e["name"] for e in m["end_to_end"]}
                assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200
    for item in m["configs"] + m["workloads"]:
        assert NAME.match(item["name"])
    assert len(json.dumps(m)) < 64 * 1024


def test_a_cell_added_as_files_is_found(bench_copy):
    before = {p.name: p.read_bytes() for p in (bench_copy / "benchmark").rglob("*.py")}
    tiny_cell(bench_copy, "sd15_pano_md", "added_cell")
    cell = load_cell("added_cell", bench_copy)
    assert cell.workload["width"] == 384
    assert cell.config["unet"]["block_out_channels"] == [8, 16, 16, 16]
    assert {p.name: p.read_bytes() for p in (bench_copy / "benchmark").rglob("*.py")} == before
