"""The traced run's spans, counters and device trace.

Spans are the benchmark's own, put around the program's stage boundaries
from outside (the program carries none yet):

* ``stage_timer``: seconds per stage, each call ended by a synchronize
  (``sampling`` = ``_sample``, ``decode`` = ``_decode_tensor``, ``encode`` =
  ``_encode``, ``inversion`` = ``noise_inversion``, ``renoise_mask`` = the
  pipeline module's ``get_retouch_mask``), the peak memory of the decode, and
  the UNet calls (a counter around ``pipe.unet.forward``);
* ``stage_ranges``: the same boundaries as ``record_function`` ranges with
  no synchronize, and one range around every ``multi_head_attention`` call,
  for the image profiled on the host and the device.

``summarize`` turns that profile into the idle gaps labelled by the stage
range open on the host, the time by kernel family, and the device time of
the kernels launched inside each attention range; ``device_busy`` turns a
second image, traced on the device alone (the host-side recording slows the
host), into the device's busy time (the union of the intervals in which an
operation ran) and the image's length.
"""
from __future__ import annotations

import bisect
import contextlib
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

STAGES = {"sampling": "_sample", "decode": "_decode_tensor", "encode": "_encode",
          "inversion": "noise_inversion"}
MASK_STAGE = "renoise_mask"
IMAGE_RANGE = "bench.image"
STAGE_PREFIX = "bench.stage."
ATTN_PREFIX = "bench.attn#"

# kernel families by name (demangled or not), first match wins
FAMILIES = [
    ("flash_attention_fm (fp32)", r"flash_f32_(sm90|wide)_kernel.*Fixed"
                                  r"|flash_f32_kernel<\d+, true|flash_f32_kernelILi\d+ELb1"),
    ("flash_attention (fp32)", r"flash_f32_"),
    ("flash_attention_fm", r"flash_fm_kernel|flash_(wide_)?sm90_kernel.*FixedShift"
                           r"|flash_kernel<\d+, true|flash_kernelILi\d+ELb1"),
    ("flash_attention_t", r"flash_t_kernel|flash_sm90_kernel.*Online"),
    ("flash_attention", r"flash_kernel|flash_wide_sm90_kernel"),
    ("fused_group_norm", r"gn_(cluster|two_read)_kernel"),
    ("fused_tile_blend", r"blend_kernel"),
    ("fused_conv3x3", r"conv_bf16_kernel|conv_sm90_kernel|conv_f32_kernel|conv_f32_sm90_kernel"),
    ("conv (cuDNN / implicit GEMM)", r"conv|implicit|cudnn|xmma_fprop|sm90_xmma|winograd|fprop"),
    ("matmul (cuBLAS)", r"gemm|cutlass|cublas|nvjet|sm90_"),
    ("softmax", r"softmax"),
    ("reduction (norm stats)", r"reduce|Reduce"),
    ("memcpy / memset", r"^Memcpy|^Memset|^memcpy|^memset"),
    ("elementwise / copy", r"elementwise|vectorized|Copy|copy|fill|unrolled|index|cat"),
]


def family(name: str) -> str:
    for fam, pat in FAMILIES:
        if re.search(pat, name):
            return fam
    return "other"


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _patched(targets):
    """Set (object, attribute, value) triples, restore them afterwards."""
    saved = [(obj, attr, obj.__dict__.get(attr, None), attr in obj.__dict__)
             for obj, attr, _ in targets]
    try:
        for obj, attr, val in targets:
            setattr(obj, attr, val)
        yield
    finally:
        for obj, attr, old, had in saved:
            if had:
                setattr(obj, attr, old)
            else:
                delattr(obj, attr)


@dataclass
class StageRecord:
    seconds: Dict[str, float] = field(default_factory=dict)
    unet_calls: int = 0
    decode_peak_bytes: Optional[int] = None


@contextlib.contextmanager
def stage_timer(pipe):
    """Synchronised seconds per stage, the decode's peak memory and the UNet
    calls, summed while the block runs."""
    from mdu_tpu_torch import pipeline as pipeline_mod

    rec = StageRecord()
    dev = pipe.device
    cuda = dev.type == "cuda"

    def timed(stage, fn):
        def run(*a, **kw):
            _sync(dev)
            if stage == "decode" and cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            _sync(dev)
            rec.seconds[stage] = rec.seconds.get(stage, 0.0) + time.perf_counter() - t0
            if stage == "decode" and cuda:
                rec.decode_peak_bytes = max(rec.decode_peak_bytes or 0,
                                            torch.cuda.max_memory_allocated(dev))
            return out
        return run

    forward = pipe.unet.forward

    def counted(*a, **kw):
        rec.unet_calls += 1
        return forward(*a, **kw)

    targets = [(pipe, attr, timed(stage, getattr(pipe, attr))) for stage, attr in STAGES.items()]
    targets.append((pipeline_mod, "get_retouch_mask",
                    timed(MASK_STAGE, pipeline_mod.get_retouch_mask)))
    targets.append((pipe.unet, "forward", counted))
    with _patched(targets):
        yield rec


@dataclass
class AttnCall:
    B: int
    H: int
    Lq: int
    Lk: int
    D: int
    itemsize: int


@contextlib.contextmanager
def stage_ranges(pipe):
    """``record_function`` ranges at the stage boundaries and around every
    attention call, no synchronize; yields the attention calls' shapes in
    call order (range ``bench.attn#<i>`` is call i)."""
    from torch.profiler import record_function

    from mdu_tpu_torch import pipeline as pipeline_mod
    from mdu_tpu_torch.models import unet as unet_mod
    from mdu_tpu_torch.models import vae as vae_mod

    calls: List[AttnCall] = []

    def ranged(stage, fn):
        def run(*a, **kw):
            with record_function(STAGE_PREFIX + stage):
                return fn(*a, **kw)
        return run

    def attention(fn):
        def run(q, k, v, num_heads, *a, **kw):
            B, Lq, HD = q.shape
            calls.append(AttnCall(B, num_heads, Lq, k.shape[1], HD // num_heads,
                                  q.element_size()))
            with record_function(f"{ATTN_PREFIX}{len(calls) - 1}"):
                return fn(q, k, v, num_heads, *a, **kw)
        return run

    targets = [(pipe, attr, ranged(stage, getattr(pipe, attr))) for stage, attr in STAGES.items()]
    targets.append((pipeline_mod, "get_retouch_mask",
                    ranged(MASK_STAGE, pipeline_mod.get_retouch_mask)))
    for mod in (unet_mod, vae_mod):
        targets.append((mod, "multi_head_attention", attention(mod.multi_head_attention)))
    with _patched(targets):
        yield calls


# --------------------------------------------------------------- reduction


@dataclass
class Op:
    """A device operation: name, start and end (ns), launch time on the host
    (ns, None when unknown)."""

    name: str
    start: int
    end: int
    launch: Optional[int] = None


@dataclass
class Range:
    name: str
    start: int
    end: int


def union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merged, sorted, non-overlapping intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: int, hi: int) -> List[Tuple[int, int]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy_ns(ops: Sequence[Op], lo: int, hi: int) -> int:
    return sum(e - s for s, e in clip(union([(o.start, o.end) for o in ops]), lo, hi))


def idle_gaps(ops: Sequence[Op], lo: int, hi: int) -> List[Tuple[int, int]]:
    gaps, t = [], lo
    for s, e in clip(union([(o.start, o.end) for o in ops]), lo, hi):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def label_at(ranges: Sequence[Range], t: int, default: str = "other") -> str:
    """The innermost range open at ``t`` (the latest started one)."""
    best = None
    for r in ranges:
        if r.start <= t < r.end and (best is None or r.start > best.start):
            best = r
    return best.name if best is not None else default


def attribute(ops: Sequence[Op], ranges: Sequence[Range]) -> Dict[str, int]:
    """Device ns of the operations launched inside each range (ranges that
    do not overlap one another)."""
    rs = sorted(ranges, key=lambda r: r.start)
    starts = [r.start for r in rs]
    out: Dict[str, int] = {}
    for o in ops:
        if o.launch is None:
            continue
        i = bisect.bisect_right(starts, o.launch) - 1
        if i >= 0 and o.launch < rs[i].end:
            out[rs[i].name] = out.get(rs[i].name, 0) + (o.end - o.start)
    return out


@dataclass
class Trace:
    ops: List[Op]
    ranges: List[Range]


RUNTIME = re.compile(r"^cu[A-Z]|^cuda")


def _call(e, method: str, default=None):
    f = getattr(e, method, None)
    return default if f is None else f()


def from_profiler(prof) -> Trace:
    """Device operations and ``bench.`` ranges of a ``torch.profiler`` run,
    read from its raw events (no event tree is built). A device operation's
    launch is the start of the host op it is linked to, else of the runtime
    call that launched it (by correlation id)."""
    from torch.autograd import DeviceType

    ops_start: Dict[int, int] = {}
    runtime_start: Dict[int, int] = {}
    ranges, pending = [], []
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns()
        end = _call(e, "end_ns") or start + e.duration_ns()
        bench = name.startswith("bench.")
        if e.device_type() == DeviceType.CUDA:
            if not bench and not _call(e, "is_user_annotation", False):
                pending.append((e, name, start, end))
            continue
        if bench:
            ranges.append(Range(name, start, end))
        table = runtime_start if RUNTIME.match(name) else ops_start
        table.setdefault(e.correlation_id(), start)
    ops = []
    for e, name, start, end in pending:
        launch = ops_start.get(_call(e, "linked_correlation_id", 0) or -1)
        if launch is None:
            launch = runtime_start.get(e.correlation_id())
        ops.append(Op(name, start, end, launch))
    return Trace(ops, ranges)


@dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    attn_device_s: Dict[int, float]


def summarize(tr: Trace) -> Optional[TraceSummary]:
    """None when the trace holds no device operation or no image range."""
    image = [r for r in tr.ranges if r.name == IMAGE_RANGE]
    if not tr.ops or not image:
        return None
    lo, hi = image[0].start, image[0].end
    inside = [o for o in tr.ops if o.end > lo and o.start < hi]
    if not inside:
        return None
    fam: Dict[str, int] = {}
    for o in inside:
        f = family(o.name)
        fam[f] = fam.get(f, 0) + (o.end - o.start)
    stages = [Range(r.name[len(STAGE_PREFIX):], r.start, r.end) for r in tr.ranges
              if r.name.startswith(STAGE_PREFIX)]
    gaps = sorted(idle_gaps(inside, lo, hi), key=lambda g: g[0] - g[1])[:10]
    attn = attribute(inside, [r for r in tr.ranges if r.name.startswith(ATTN_PREFIX)])
    return TraceSummary(
        busy_s=busy_ns(inside, lo, hi) / 1e9, window_s=(hi - lo) / 1e9,
        device_ops=sorted(((k, v / 1e9) for k, v in fam.items()), key=lambda kv: -kv[1])[:10],
        idle_gaps=[(label_at(stages, (s + e) // 2), (e - s) / 1e9) for s, e in gaps],
        attn_device_s={int(k[len(ATTN_PREFIX):]): v / 1e9 for k, v in attn.items()})


def device_busy(tr: Trace) -> Optional[Tuple[float, float]]:
    """(busy seconds, window seconds) of a trace of one image between two
    marker operations: the window runs from the first operation's start to
    the last one's end, busy is the union of the operations in it."""
    if len(tr.ops) < 3:
        return None
    lo = min(o.start for o in tr.ops)
    hi = max(o.end for o in tr.ops)
    return busy_ns(tr.ops, lo, hi) / 1e9, (hi - lo) / 1e9
