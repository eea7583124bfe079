"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file is compiled on first use into its own shared library
with a plain C interface, under ``mdu_tpu_torch/_build/`` (listed in
``.gitignore``). The library's file name carries a hash of the sources it was
built from, so an edited source is always rebuilt and a stale library is
never loaded. Nothing is built at import time: the CPU tests import every
module on a machine with no ``nvcc``.

``build_all()`` starts one ``nvcc`` per source, all at once, and returns what
each printed with ``-Xptxas -v`` (registers, shared memory, spills).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"

# kernel library -> its source file; every source also includes the headers
SOURCES = {
    "flash_attention_fm": "flash_attention_fm.cu",
    "flash_attention": "flash_attention.cu",
    "flash_attention_f32": "flash_attention_f32.cu",
    "flash_attention_t": "flash_attention_t.cu",
    "group_norm": "group_norm.cu",
    "tile_blend": "tile_blend.cu",
    "conv3x3": "conv3x3.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",
}
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LIBS: Dict[str, ctypes.CDLL] = {}
# one first-use build and load at a time: the tile shards' threads may reach
# the same library together
_LOAD_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(ARCH_FLAGS).encode())
    for path in [CSRC / SOURCES[name]] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD / f"lib{name}-{_digest(name)}.so"


def _command(name: str, out: Path) -> List[str]:
    return [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
            "-o", str(out), str(CSRC / SOURCES[name])]


def _ptxas_lines(log: str) -> List[str]:
    """ptxas's report of each kernel: the function it compiles, registers and
    shared memory, and the ``bytes stack frame, ... spill stores, ... spill
    loads`` line (which does not name ptxas); and any warning."""
    keep = ("Compiling", "registers", "smem", "spill", "warning")
    return [ln.strip() for ln in log.splitlines() if any(w in ln for w in keep)]


def build_all(names=None) -> Dict[str, dict]:
    """Build every missing library in parallel; returns, per library, the
    seconds its nvcc took (0 when it was already built) and the ptxas lines."""
    names = list(names or SOURCES)
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    report: Dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            report[name] = {"seconds": 0.0, "ptxas": [], "path": str(out)}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(_command(name, tmp),
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {
            "seconds": time.perf_counter() - t0,
            "ptxas": _ptxas_lines(log),
            "path": str(out),
        }
    if failures:
        raise RuntimeError("nvcc failed\n" + "\n".join(failures))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if it is missing; built
    and loaded once when several threads ask for it together."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOAD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
    return lib
