"""One run of one cell: set-up, the measured window of whole images back to
back, the traced work after it, the judgement of one image by the plain
reference, and the result line.

Order of a run:

1. set-up: weights and conds drawn on the device from the seed, the
   program built, one warm image of the cell's own shapes, the image's
   model operations counted;
2. the window: images back to back, each with its own seed (and, for
   img2img, its own input), no span and no profiler; none starts once
   ``seconds`` have passed, and one still running then is neither counted
   nor timed; one image, drawn from the seed, keeps its states for the
   judge;
3. with ``trace``: the traced images (``traced_images``);
4. the program freed, the reference judges the kept image.
"""
from __future__ import annotations

import gc
import json
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from . import inputs, trace
from .flops import attention_least_s, image_flops
from .manifest import ROOT, Cell, load_cell
from .program import Program

FORBIDDEN = ("jax", "jaxlib", "flax", "mdu_tpu")


@dataclass
class RunRecord:
    """What the metric readers read."""

    cell: str
    seconds: float
    setup_s: float
    window_s: float = 0.0
    images_ok: int = 0
    images_failed: int = 0
    step_ms: List[float] = field(default_factory=list)
    peak_bytes: Optional[int] = None
    image_flops: float = 0.0
    stages: Optional[trace.StageRecord] = None
    summary: Optional[trace.TraceSummary] = None
    attn_calls: List[trace.AttnCall] = field(default_factory=list)

    def attn_totals(self):
        """(sum of least seconds, sum of device seconds) over the attention
        calls whose kernels the trace attributed."""
        if self.summary is None:
            return None
        least = dev = 0.0
        for i, c in enumerate(self.attn_calls):
            d = self.summary.attn_device_s.get(i)
            if d:
                least += attention_least_s(c.B, c.H, c.Lq, c.Lk, c.D, c.itemsize)
                dev += d
        return (least, dev) if dev > 0 else None


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def traced_images(prog: Program, wl: dict, seed: int, dev, rec: RunRecord) -> None:
    """After the window: one image under the synchronised stage spans; on the
    card, one image profiled on the host and the device with a range around
    every stage and attention call, and one traced on the device alone for
    the busy share (the host-side recording of the other slows the host)."""
    img2img = wl["entry"] == "img2img"

    def image_input(tag):
        s = inputs.derive(seed, tag)
        return s, (inputs.make_image(wl, s) if img2img else None)

    s, inp = image_input(8_001)
    with trace.stage_timer(prog.pipe) as st:
        prog.image(s, inp)
    rec.stages = st
    if dev.type != "cuda":
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    s, inp = image_input(8_002)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with trace.stage_ranges(prog.pipe) as calls:
            with record_function(trace.IMAGE_RANGE):
                prog.image(s, inp)
                torch.cuda.synchronize(dev)
    rec.attn_calls = calls
    rec.summary = trace.summarize(trace.from_profiler(prof))
    s, inp = image_input(8_003)
    marker = torch.zeros(1, device=dev)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        marker.fill_(1.0)
        prog.image(s, inp)
        marker.fill_(2.0)
        torch.cuda.synchronize(dev)
    busy = trace.device_busy(trace.from_profiler(prof))
    if rec.summary is None or busy is None:
        raise RuntimeError("the profiler shows no device time in the traced image")
    rec.summary.busy_s, rec.summary.window_s = busy


def run(name: str, seed: int, seconds: float, traced: bool, device="cuda", root=ROOT,
        t_start: Optional[float] = None, log=None) -> dict:
    """The result object of one run (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, optionally ``breakdown``, and ``checks`` last)."""
    from ..reference.judge import Reference, judge, verdict
    from ..reference.nets import shapes_of

    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda **kw: print(json.dumps({"bench": "info", **kw}), flush=True))
    cell: Cell = load_cell(name, root)
    wl, cfg = cell.workload, cell.config
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    dtype = getattr(torch, cfg["dtype"])

    # ---------------------------------------------------------------- set-up
    shapes = ([("unet." + n, s) for n, s in shapes_of("unet", cfg["unet"])]
              + [("vae." + n, s) for n, s in shapes_of("vae", cfg["vae"])])
    weights = inputs.make_weights(shapes, seed, dtype, dev)
    conds = inputs.make_conds(wl, cfg, seed, dtype, dev)
    prog = Program(cfg, wl, weights, conds, dev)
    img2img = wl["entry"] == "img2img"
    want_steps = cell.wants("step_ms_p95") and cuda
    warm_seed = inputs.derive(seed, 9_999)
    warm = prog.image(warm_seed, inputs.make_image(wl, warm_seed) if img2img else None,
                      step_events=want_steps)
    if not warm.ok:
        log(warm_image_failed=warm.why)
    flops = image_flops(wl, cfg)
    pick = int(wl.get("check", {}).get("pick_from", 1))
    k_check = inputs.derive(seed, inputs.TAG_CHECK) % max(1, pick)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    rec = RunRecord(name, seconds, time.perf_counter() - t_start, image_flops=flops["total"])

    # ---------------------------------------------------------------- window
    done: List[tuple] = []          # (k, result)
    attempted = failed = 0
    w0 = time.perf_counter()
    t_last = w0
    k = 0
    while time.perf_counter() - w0 < seconds:
        s_k = inputs.image_seed(seed, k)
        res = prog.image(s_k, inputs.make_image(wl, s_k) if img2img else None,
                         capture=k in (0, k_check), step_events=want_steps)
        t_end = time.perf_counter()
        if t_end - w0 > seconds:
            break                   # in flight at the deadline: not counted
        attempted += 1
        failed += 0 if res.ok else 1
        if not res.ok:
            log(image=k, failed=res.why)
        if k not in (0, k_check):
            res.latents = res.image = None      # only images 0 and k_check are judged
        done.append((k, res))
        if k == k_check and k > 0:
            done[0][1].traj.clear()             # image 0: the fallback only
        t_last = t_end
        k += 1
    rec.window_s = t_last - w0
    rec.images_ok, rec.images_failed = attempted - failed, failed
    if cuda:
        rec.peak_bytes = torch.cuda.max_memory_allocated(dev)
        for _, res in done:
            ev = res.events
            rec.step_ms += [ev[i - 1].elapsed_time(ev[i]) for i in range(1, len(ev))]
    log(cell=name, images=attempted, failed=failed, window_s=rec.window_s,
        last_vae_mode=prog.pipe.last_vae_mode, last_decode=prog.pipe.last_decode,
        checked_image=k_check, image_tflop=flops["total"] / 1e12)

    if traced:
        traced_images(prog, wl, seed, dev, rec)

    # ----------------------------------------------------------------- judge
    # the image drawn from the seed; image 0 where the window ended before it
    k_kept = k_check if k_check < len(done) else 0
    kept = done[k_kept][1] if done else None
    prog.close()
    del prog, warm
    _free(dev)
    numbers: Dict[str, float] = {}
    if kept is not None and kept.ok:
        ref = Reference(cfg, wl, weights, conds, dev)
        del weights
        _free(dev)
        s_k = inputs.image_seed(seed, k_kept)
        t_j = time.perf_counter()
        numbers = judge(ref, s_k, kept.traj, kept.latents, kept.image,
                        inputs.make_image(wl, s_k) if img2img else None)
        log(judge_s=time.perf_counter() - t_j, judged_image=k_kept)
        del ref
    limits = dict(wl.get("limits", {}))
    correct = (kept is not None and kept.ok and failed == 0 and attempted > 0
               and bool(numbers) and verdict(numbers, limits))

    # ---------------------------------------------------------------- result
    metrics = {}
    for m in cell.reported(traced):
        v = m.read(rec)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                   "count": 1, "memory_peak_bytes": rec.peak_bytes}
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_info}
    if traced and rec.summary is not None:
        device_info["busy_s"] = rec.summary.busy_s
        device_info["window_s"] = rec.summary.window_s
        out["breakdown"] = {"device_ops": [list(x) for x in rec.summary.device_ops],
                            "idle_gaps": [list(x) for x in rec.summary.idle_gaps]}
    checks = {}
    for key in sorted(set(numbers) | set(limits)):
        v = numbers.get(key)
        checks[key] = {"value": v if v is None or math.isfinite(v) else str(v),
                       "limit": limits.get(key)}
    out["checks"] = checks
    return out
