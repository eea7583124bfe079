"""Wall time and peak device memory, and profiler traces (counterpart of
``mdu_tpu/utils/telemetry.py``; the reference's ``perfcount`` prints wall
seconds and ``torch.cuda.max_memory_allocated``, ref scripts/tilevae.py:
264-284). The memory figures are the caching allocator's own counts of the
card, not an estimate; on the CPU they are None.
"""
from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Optional

import torch


def _cuda_device(device=None) -> Optional[torch.device]:
    if not torch.cuda.is_available():
        return None
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None \
        else torch.device(device)
    return dev if dev.type == "cuda" else None


def device_memory_mb(device=None) -> Optional[float]:
    """Bytes the allocator holds in tensors on the card now, in MB (None on
    the CPU)."""
    dev = _cuda_device(device)
    return None if dev is None else torch.cuda.memory_allocated(dev) / 2 ** 20


def device_peak_memory_mb(device=None) -> Optional[float]:
    """The most bytes held in tensors on the card since the last
    ``torch.cuda.reset_peak_memory_stats``, in MB (None on the CPU)."""
    dev = _cuda_device(device)
    return None if dev is None else torch.cuda.max_memory_allocated(dev) / 2 ** 20


@contextlib.contextmanager
def perfcount(label: str = "Tiled VAE", stream=None):
    """``with perfcount('Tiled VAE'):`` prints the block's wall seconds (the
    card synchronised at its end) and the peak device memory."""
    stream = stream or sys.stderr
    t0 = time.time()
    yield
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    dt = time.time() - t0
    peak = device_peak_memory_mb()
    if peak is not None:
        print(f"[{label}]: Done in {dt:.3f}s, peak device {peak:.1f} MB", file=stream)
    else:
        print(f"[{label}]: Done in {dt:.3f}s", file=stream)


@contextlib.contextmanager
def profile_trace(log_dir: str = "mdu_tpu_torch_trace"):
    """``with profile_trace(dir):`` records the block with ``torch.profiler``
    (the CPU, and the card where there is one) and writes a Chrome trace to
    ``dir/trace.json`` (open it in Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
