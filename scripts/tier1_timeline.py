#!/usr/bin/env python3
"""Where the tier-1 suite's time goes, file by file.

    python3 scripts/tier1_timeline.py run LOG [--cold]   # the tier-1 command, timestamped
    python3 scripts/tier1_timeline.py report LOG [--top N]
    python3 scripts/tier1_timeline.py replay LOG [--workers 6]

``run`` runs the suite as the tier-1 command does (6 xdist workers, whole
files per worker, a 1470 s limit) with ``-v -v``, so that every result
names its worker, and writes each output line to LOG behind the seconds
since the start; ``--cold`` first removes the JAX tests' persistent compile
cache. ``report`` reads such a log: for each worker the files in the order
it ran them, each file's start (the previous file's last result on that
worker), end and seconds, the passes, and the slowest files. ``replay``
hands the log's files out again as xdist 3.8.0's ``--dist loadfile`` does
(whole files, in descending test count, ties in collection order, each to
the first worker that is free) with the log's per-file seconds, and prints
when the last file would end: a model of the hand-out, not a measurement.
"""
from __future__ import annotations

import argparse
import heapq
import os
import re
import shutil
import subprocess
import sys
import time
from collections import defaultdict

RESULT = re.compile(r"\s*([\d.]+) \[(gw\d+)\] \[\s*\d+%\] (\w+) (tests/[^:]+)::")
LIMIT_S = 1470
COMMAND = ["timeout", "-k", "10", str(LIMIT_S), "python", "-m", "pytest", "tests/", "-q",
           "-v", "-v", "-m", "not slow", "--continue-on-collection-errors",
           "-p", "no:cacheprovider", "-p", "xdist", "-n", "6", "--dist", "loadfile",
           "-p", "no:randomly"]


def run(log: str, cold: bool) -> int:
    if cold:
        shutil.rmtree("/tmp/jax_test_cache", ignore_errors=True)
    env = {"JAX_PLATFORMS": "cpu", "ALLOW_MULTIPLE_LIBTPU_LOAD": "1", "PYTHONUNBUFFERED": "1"}
    t0 = time.time()
    with open(log, "w") as out:
        proc = subprocess.Popen(COMMAND, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True, env={**os.environ, **env})
        for line in proc.stdout:
            out.write(f"{time.time() - t0:8.1f} {line}")
            out.flush()
        rc = proc.wait()
        out.write(f"RC={rc} SECONDS={time.time() - t0:.0f}\n")
    return rc


def files_by_worker(log: str):
    """{worker: [[file, start, end, results], ...]} and the passes."""
    order = defaultdict(list)
    passed = 0
    with open(log) as f:
        for line in f:
            m = RESULT.match(line)
            if not m:
                continue
            t, worker, status, path = float(m[1]), m[2], m[3], m[4]
            passed += status == "PASSED"
            runs = order[worker]
            if not runs or runs[-1][0] != path:
                start = runs[-1][2] if runs else t
                runs.append([path, start, t, 0])
            runs[-1][2] = t
            runs[-1][3] += 1
    return order, passed


def report(log: str, top: int) -> None:
    order, passed = files_by_worker(log)
    rows = []
    for worker in sorted(order):
        print(worker)
        for path, start, end, n in order[worker]:
            print(f"  {start:8.1f} -> {end:8.1f}  {end - start:8.1f} s  {n:4d}  {path}")
            rows.append((end - start, path, worker, start, end))
    print(f"passed {passed}")
    print(f"slowest {top}:")
    for seconds, path, worker, start, end in sorted(rows, reverse=True)[:top]:
        print(f"  {seconds:8.1f} s  {worker}  {start:8.1f} -> {end:8.1f}  {path}")


def replay(log: str, workers: int) -> None:
    order, _ = files_by_worker(log)
    seconds, counts, first = {}, {}, {}
    for runs in order.values():
        for path, start, end, n in runs:
            seconds[path], counts[path] = end - start, n
            first[path] = start
    queue = sorted(seconds, key=lambda p: (-counts[p], p))
    start0 = min(first.values())
    free = [(start0, i) for i in range(workers)]
    heapq.heapify(free)
    end = 0.0
    for path in queue:
        t, i = heapq.heappop(free)
        heapq.heappush(free, (t + seconds[path], i))
        end = max(end, t + seconds[path])
    print(f"{len(queue)} files, the last would end at {end:.0f} s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("run", "report", "replay"))
    ap.add_argument("log")
    ap.add_argument("--cold", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--workers", type=int, default=6)
    args = ap.parse_args()
    if args.mode == "run":
        return run(args.log, args.cold)
    if args.mode == "report":
        report(args.log, args.top)
    else:
        replay(args.log, args.workers)
    return 0


if __name__ == "__main__":
    sys.exit(main())
