"""Run one cell of the benchmark of the PyTorch / CUDA port.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, workload and metrics are found by name through
``BENCHMARK.json``. The run needs the card: with no CUDA device it exits
with an error and prints no result. Its last line on standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last); the
numbers compared, each beside its limit, are also the last lines on
standard error. An earlier line names the card, the device count and the
card's power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]


def process_age_s() -> float:
    """Seconds since this process started (Linux), else since this module
    was first run."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_START


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # build and kernel caches inside the checkout, at fixed paths
    cache = ROOT / "benchmark" / "_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(ROOT))

    import torch

    chips = 1
    try:
        from benchmark.harness.manifest import load_cell
        chips = int(load_cell(args.workload, ROOT).entry.get("chips", 1))
    except (OSError, KeyError, ValueError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(json.dumps({"bench": "device", "name": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count(), "power": power_limit(),
                      "workload": args.workload, "seed": args.seed, "trace": args.trace}),
          flush=True)

    from benchmark.harness import runner

    t0 = time.perf_counter() - process_age_s()
    out = runner.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", ROOT,
                     t_start=t0)
    bad = runner.forbidden_modules()
    if bad:
        print(f"benchmark: the process loaded {bad}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    for key, c in out["checks"].items():
        print(f"check {key} {c['value']} limit {c['limit']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
