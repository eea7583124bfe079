"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of the
checkout, a configuration file and a workload file per cell, and a reader
module per metric (``benchmark/metrics/<name>.py``). Adding a cell or a
metric adds files and entries; no file here names one."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclass
class Metric:
    name: str
    unit: str
    kind: str                       # "end_to_end" or "per_layer"
    spec: dict
    read: Callable

    def applies_to(self, cell: str) -> bool:
        return "workloads" not in self.spec or cell in self.spec["workloads"]


@dataclass
class Cell:
    name: str
    entry: dict                     # the workloads entry of BENCHMARK.json
    workload: dict                  # benchmark/workloads/<name>.json
    config: dict                    # the configuration's file
    metrics: List[Metric]

    def reported(self, trace: bool) -> List[Metric]:
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.metrics if m.kind == kind and m.applies_to(self.name)]

    def wants(self, metric: str) -> bool:
        return any(m.name == metric and m.applies_to(self.name) for m in self.metrics)


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_reader(name: str, bench: Path = BENCH) -> Callable:
    """``read(record) -> value or None`` of ``benchmark/metrics/<name>.py``."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}",
                                                  path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_cell(name: str, root: Path = ROOT, manifest: Optional[dict] = None) -> Cell:
    manifest = manifest or load_manifest(root)
    bench = root / "benchmark"
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    with open(root / configs[entry["config"]]["file"]) as f:
        config = json.load(f)
    with open(bench / "workloads" / f"{name}.json") as f:
        workload = json.load(f)
    if workload.get("config") != entry["config"]:
        raise ValueError(f"workload {name}: config {workload.get('config')!r} against "
                         f"BENCHMARK.json's {entry['config']!r}")
    metrics = []
    for kind in ("end_to_end", "per_layer"):
        for m in manifest[kind]:
            metrics.append(Metric(m["name"], m["unit"], kind, m, load_reader(m["name"], bench)))
    return Cell(name, entry, workload, config, metrics)


def all_cells(root: Path = ROOT) -> Dict[str, Cell]:
    manifest = load_manifest(root)
    return {w["name"]: load_cell(w["name"], root, manifest) for w in manifest["workloads"]}
