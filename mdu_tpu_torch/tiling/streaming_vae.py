"""Streaming exact tiled VAE (counterpart of ``mdu_tpu/tiling/streaming_vae.py``):
an exact tiled encode or decode whose live device memory is bounded by one
group of tiles, not by the canvas.

The lockstep mode (``tiling/tiled_vae.py``) holds every tile's activations
on the card at once. Here the network runs as a sequence of *segments* cut
at every GroupNorm; each segment runs over fixed-size groups of tiles, and
between segments each group's masked per-(row, group) sums are pooled in
float64 on the host into the exact statistics of the next GroupNorm (the
E[x^2] form over the tiles' owned regions, as the lockstep mode pools them).

* ``host_resident=True`` (stream-host): the tiles live in pageable CPU
  memory between segments. Each group is staged through a bounded ring of
  pinned chunks and moved with ``non_blocking`` copies on two side streams
  (one up, one down), so group g + 1 goes up while group g computes.
  ``spill_dtype`` (or ``MDU_SPILL_DTYPE``), e.g. ``float8_e4m3fn``, casts the
  activations on the card before they come down and widens them after they
  go up; the last segment's output and the pooled statistics stay at full
  precision.
* ``host_resident=False`` (stream-device): the tiles stay on the card between
  segments; only one group's working set is live inside a segment.

The op walk is derived from the port's own ``models/vae.py`` modules, in the
order ``Encoder.forward`` and ``Decoder.forward`` run them.
"""
from __future__ import annotations

import os
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.layers import silu
from ..models.vae import AttnBlock, AutoencoderKL, ResnetBlock
from ..ops.groupnorm import apply_group_norm
from .tiled_vae import (DECODER_PAD, ENCODER_PAD, lockstep_footprint_bytes, plan_vae_tiles,
                        streaming_device_footprint_bytes)

# op kinds: ('conv', m) ('silu', None) ('store_res', m) ('add_res', None)
#           ('norm', m): a segment boundary; ('attn', m) ('down', m) ('up', m)
DEFAULT_BUDGET = 10 * 2 ** 30       # the JAX package's MDU_HBM_BYTES default
SLACK = 2 ** 30                     # left free for the allocator's fragmentation
PINNED_CHUNK = 64 * 2 ** 20         # stream-host's staging: 4 pinned chunks each way
PINNED_SLOTS = 4


def _resnet_ops(rb: ResnetBlock):
    return [("store_res", rb), ("norm", rb.norm1), ("silu", None), ("conv", rb.conv1),
            ("norm", rb.norm2), ("silu", None), ("conv", rb.conv2), ("add_res", None)]


def _attn_ops(at: AttnBlock):
    return [("store_res", None), ("norm", at.group_norm), ("attn", at), ("add_res", None)]


def decoder_ops(vae: AutoencoderKL):
    """Flat op list of ``AutoencoderKL.decode`` (post_quant_conv included)."""
    dec, cfg = vae.decoder, vae.cfg
    n = len(cfg.block_out_channels)
    ops = [("conv", vae.post_quant_conv), ("conv", dec.conv_in)]
    ops += _resnet_ops(dec.mid.block_1) + _attn_ops(dec.mid.attn_1)
    ops += _resnet_ops(dec.mid.block_2)
    for i in range(n):
        for j in range(cfg.layers_per_block + 1):
            ops += _resnet_ops(getattr(dec, f"up_{i}_block_{j}"))
        if i != n - 1:
            ops.append(("up", getattr(dec, f"up_{i}_upsample")))
    return ops + [("norm", dec.norm_out), ("silu", None), ("conv", dec.conv_out)]


def encoder_ops(vae: AutoencoderKL):
    """Flat op list of ``AutoencoderKL.encode_moments`` (quant_conv included)."""
    enc, cfg = vae.encoder, vae.cfg
    n = len(cfg.block_out_channels)
    ops = [("conv", enc.conv_in)]
    for i in range(n):
        for j in range(cfg.layers_per_block):
            ops += _resnet_ops(getattr(enc, f"down_{i}_block_{j}"))
        if i != n - 1:
            ops.append(("down", getattr(enc, f"down_{i}_downsample")))
    ops += _resnet_ops(enc.mid.block_1) + _attn_ops(enc.mid.attn_1)
    ops += _resnet_ops(enc.mid.block_2)
    return ops + [("norm", enc.norm_out), ("silu", None), ("conv", enc.conv_out),
                  ("conv", vae.quant_conv)]


def _segment_spans(kinds: List[str]) -> List[Tuple[int, int]]:
    """Half-open op spans, each ending just before a 'norm'; a span's leading
    op may be a 'norm' (applied with the pooled statistics)."""
    spans, start = [], 0
    for i, k in enumerate(kinds):
        if k == "norm" and i > start:
            spans.append((start, i))
            start = i
    spans.append((start, len(kinds)))
    return spans


def _carry_spans(kinds: List[str]) -> List[Tuple[int, int]]:
    """``_segment_spans`` with each 'store_res' that comes just before a norm
    moved into the norm's segment: the residual of a ResnetBlock's first
    norm and of the attention is a function of the carried activation, so
    it is made after the boundary, and only one tensor a tile is carried
    across it (the JAX package carries both)."""
    spans = _segment_spans(kinds)
    out = []
    for i, (start, end) in enumerate(spans):
        if i + 1 < len(spans) and kinds[end - 1] == "store_res" and end - 1 > start:
            end -= 1
        if i > 0 and kinds[start - 1] == "store_res" and out[-1][1] == start - 1:
            start -= 1
        out.append((start, end))
    return out


def _mask_at(base_mask, h: int, w: int):
    bh, bw = base_mask.shape[-2], base_mask.shape[-1]
    if (h, w) == (bh, bw):
        return base_mask
    if bh % h == 0 and bw % w == 0:
        return base_mask[..., ::bh // h, ::bw // w]
    return base_mask.repeat_interleave(h // bh, dim=-2).repeat_interleave(w // bw, dim=-1)


def _masked_stats(x, mask, groups: int):
    """Partial sums (s1, s2, n), each [rows, G] in fp32, of the masked pixels."""
    TB, C, H, W = x.shape
    xf = x.float().reshape(TB, groups, C // groups, H, W)
    m = _mask_at(mask, H, W).reshape(TB, 1, 1, H, W).float()
    s1 = (xf * m).sum(dim=(2, 3, 4))
    s2 = (xf * xf * m).sum(dim=(2, 3, 4))
    n = (m.sum(dim=(2, 3, 4)) * (C // groups)).expand_as(s1)
    return s1, s2, n


def _pool(parts, B: int):
    """Per-row partial sums -> per-batch-element (mean, var) [B, G] in fp32,
    pooled in float64 on the host. Rows are tile-major, batch-minor."""
    tot = [None, None, None]
    for part in parts:
        for i, p in enumerate(part):
            r = p.detach().to("cpu", torch.float64).numpy()
            r = r.reshape(-1, B, r.shape[-1]).sum(0)
            tot[i] = r if tot[i] is None else tot[i] + r
    mean = tot[0] / tot[2]
    var = np.maximum(tot[1] / tot[2] - mean * mean, 0.0)
    return mean.astype(np.float32), var.astype(np.float32)


def _run_segment(ops, groups: int, x, res, mask, stats, want_stats: bool):
    """One segment over one group of tiles: (x', res', partial sums or None)."""
    for kind, m in ops:
        if kind == "norm":
            mean, var = stats                  # pooled, [rows, G]
            x = apply_group_norm(x, groups, mean, var, m.weight, m.bias, m.eps).to(m.dtype)
        elif kind == "conv" or kind in ("down", "up"):
            x = m(x)
        elif kind == "silu":
            x = silu(x)
        elif kind == "store_res":
            res = m.conv_shortcut(x) if m is not None and m.conv_shortcut is not None else x
        elif kind == "add_res":
            x, res = x + res, None
        elif kind == "attn":
            x = m.attend(x)
    return x, res, (_masked_stats(x, mask, groups) if want_stats else None)


def _budget(device) -> int:
    """``MDU_HBM_BYTES`` (or, unset, the card's free memory; on the CPU the
    JAX package's 10 GiB default), on the card clamped to its free memory
    less 1 GiB of slack, and at least 1 GiB."""
    env = os.environ.get("MDU_HBM_BYTES")
    if device is None or torch.device(device).type != "cuda":
        return int(env) if env else DEFAULT_BUDGET
    free = torch.cuda.mem_get_info(torch.device(device))[0] - SLACK
    budget = int(env) if env else free
    return max(min(budget, free), SLACK)


def auto_group_size(which: str, in_h: int, in_w: int, B: int, requested: int,
                    prefetch: bool, dtype_bytes: int = 2,
                    device=None) -> Tuple[int, bool]:
    """Clamp the group to the memory budget (``_budget``). The live set is one
    group's widest-segment working set, about 5 tensors of the 128-channel
    full-tile activation, doubled when the prefetch keeps group g + 1 in
    flight while g computes. The group shrinks first; if one tile with
    prefetch still busts the budget, the prefetch goes. Returns (group,
    prefetch)."""
    per_tile = 128 * in_h * in_w * dtype_bytes * 5 * B
    budget = _budget(device)
    want_prefetch = prefetch
    g = max(1, min(requested, budget // (per_tile * (2 if prefetch else 1))))
    if g == 1 and prefetch and 2 * per_tile > budget:
        prefetch = False
    if g != requested or prefetch != want_prefetch:
        print(f"[Tiled VAE] streaming {which}: group {requested} -> {g}"
              f"{', prefetch off' if want_prefetch and not prefetch else ''}"
              f" to fit a {budget / 2 ** 30:.1f} GiB budget", file=sys.stderr)
    return g, prefetch


def exact_vae_mode(which: str, tile_size: int, h: int, w: int, B: int, group: int,
                   budget: int, dtype_bytes: int = 2) -> str:
    """The exact tiled VAE's mode by the JAX package's rule
    (``mdu_tpu/pipeline.py:1139-1169``): 'lockstep' when every tile fits
    through the network at once, else 'stream-device' when one layer of every
    tile and one group fit, else 'stream-host'."""
    pad = ENCODER_PAD if which == "encoder" else DECODER_PAD
    plan = plan_vae_tiles(h, w, tile_size, pad)
    if plan is None:
        return "lockstep"
    if lockstep_footprint_bytes(which, tile_size, plan.num_tiles, B, dtype_bytes) <= budget:
        return "lockstep"
    if streaming_device_footprint_bytes(which, tile_size, plan.num_tiles, B, group,
                                        dtype_bytes) <= budget:
        return "stream-device"
    return "stream-host"


class _HostMover:
    """Moves tensors between pageable CPU storage and the card through a ring
    of pinned chunks (``PINNED_SLOTS`` of ``PINNED_CHUNK`` bytes each way, so
    the pinned memory stays bounded whatever the canvas): up, each chunk is copied into
    a free slot on the host and sent with a ``non_blocking`` copy on the up
    stream; down, the chunks come back on the down stream, each copied out
    of its slot once its copy is done. On the CPU both are plain copies."""

    def __init__(self, device):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.chunk = PINNED_CHUNK
            self.main = torch.cuda.current_stream(device)
            self.streams = {d: torch.cuda.Stream(device) for d in ("up", "down")}
            self.rings = {d: [[torch.empty(PINNED_CHUNK, dtype=torch.uint8, pin_memory=True),
                               None] for _ in range(PINNED_SLOTS)] for d in ("up", "down")}

    def up(self, host: Optional[torch.Tensor]):
        """The device copy of ``host``, ready for the main stream."""
        if host is None:
            return None
        if not self.cuda:
            return host.clone()
        src = host.reshape(-1).view(torch.uint8)
        ring, stream = self.rings["up"], self.streams["up"]
        with torch.cuda.stream(stream):
            dev = torch.empty(host.shape, dtype=host.dtype, device=self.device)
            dst = dev.view(-1).view(torch.uint8)
            for i, off in enumerate(range(0, src.numel(), self.chunk)):
                slot = ring[i % len(ring)]
                if slot[1] is not None:
                    slot[1].synchronize()          # the slot's last copy is done
                n = min(self.chunk, src.numel() - off)
                slot[0][:n].copy_(src[off:off + n])
                dst[off:off + n].copy_(slot[0][:n], non_blocking=True)
                slot[1] = torch.cuda.Event()
                slot[1].record(stream)
        self.main.wait_stream(stream)
        dev.record_stream(self.main)
        return dev

    def down(self, dev: Optional[torch.Tensor]):
        """A pageable CPU copy of ``dev`` once the main stream has made it."""
        if dev is None:
            return None
        if not self.cuda:
            return dev.clone()
        dev = dev.contiguous()
        stream = self.streams["down"]
        stream.wait_stream(self.main)
        host = torch.empty(dev.shape, dtype=dev.dtype)
        src, dst = dev.view(-1).view(torch.uint8), host.view(-1).view(torch.uint8)
        ring, pending = self.rings["down"], []

        def land(k):
            slot, off, n = pending[k]
            slot[1].synchronize()
            dst[off:off + n].copy_(slot[0][:n])

        with torch.cuda.stream(stream):
            for i, off in enumerate(range(0, src.numel(), self.chunk)):
                if len(pending) >= len(ring):
                    land(len(pending) - len(ring))
                slot = ring[i % len(ring)]
                n = min(self.chunk, src.numel() - off)
                slot[0][:n].copy_(src[off:off + n], non_blocking=True)
                slot[1] = torch.cuda.Event()
                slot[1].record(stream)
                pending.append((slot, off, n))
        for k in range(max(0, len(pending) - len(ring)), len(pending)):
            land(k)
        dev.record_stream(stream)
        return host


def _spill_dtype(spill_dtype: Optional[str]):
    name = os.environ.get("MDU_SPILL_DTYPE") or spill_dtype
    if not name:
        return None
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown spill dtype {name!r}")
    return dt


@torch.inference_mode()
def streaming_tiled_vae(vae: AutoencoderKL, x, which: str = "decoder", tile_size: int = 96,
                        group_size: int = 4, host_resident: bool = True,
                        spill_dtype: Optional[str] = None):
    """Exact tiled decode (``which="decoder"``, z already divided by the
    scaling factor) or encode to moments (``"encoder"``) with bounded live
    device memory. ``x`` may lie on the CPU or on the VAE's device; the
    result lies on the VAE's device. Returns None when the input is small
    enough to skip tiling (the caller runs the untiled path)."""
    pad = DECODER_PAD if which == "decoder" else ENCODER_PAD
    plan = plan_vae_tiles(x.shape[2], x.shape[3], tile_size, pad)
    if plan is None:
        return None
    device = vae.post_quant_conv.weight.device
    dtype = vae.dtype
    B, T = x.shape[0], plan.num_tiles
    scale = 8 if which == "decoder" else 1
    group_size, prefetch = auto_group_size(
        which, plan.in_h * scale, plan.in_w * scale, B, min(group_size, T), host_resident,
        torch.empty((), dtype=dtype).element_size(), device)
    Tp = -(-T // group_size) * group_size            # pad tiles have zero masks
    home = "cpu" if host_resident else device

    xs = torch.zeros((Tp * B, x.shape[1], plan.in_h, plan.in_w), dtype=dtype, device=home)
    for t, (oy, ox) in enumerate(plan.in_origins):
        xs[t * B:(t + 1) * B] = x[:, :, oy:oy + plan.in_h, ox:ox + plan.in_w].to(home, dtype)
    masks = np.concatenate([plan.local_masks(),
                            np.zeros((Tp - T, 1, plan.in_h, plan.in_w), np.float32)])
    masks = torch.as_tensor(np.repeat(masks, B, axis=0), device=device)

    ops = decoder_ops(vae) if which == "decoder" else encoder_ops(vae)
    spans = _carry_spans([k for k, _ in ops])
    groups = vae.cfg.norm_num_groups
    n_groups, rows = Tp // group_size, group_size * B
    cur: List[Optional[torch.Tensor]] = [xs[g * rows:(g + 1) * rows] for g in range(n_groups)]
    res: List[Optional[torch.Tensor]] = [None] * n_groups
    gmasks = [masks[g * rows:(g + 1) * rows] for g in range(n_groups)]
    spill = _spill_dtype(spill_dtype) if host_resident else None
    mover = _HostMover(torch.device(device)) if host_resident else None

    stats = None
    for si, (start, end) in enumerate(spans):
        last = si == len(spans) - 1
        seg_ops = ops[start:end]
        st_in = None if stats is None else tuple(
            torch.as_tensor(np.tile(s, (group_size, 1)), device=device) for s in stats)

        def compute(g, xg, rg):
            return _run_segment(seg_ops, groups, xg.to(dtype),
                                None if rg is None else rg.to(dtype), gmasks[g], st_in, not last)

        parts = []
        if not host_resident:
            for g in range(n_groups):
                cur[g], res[g], pg = compute(g, cur[g], res[g])
                if pg is not None:
                    parts.append(pg)
        else:
            def narrow(a):
                return a.to(spill) if (a is not None and spill is not None and not last) else a

            # with the prefetch, group g + 1 goes up while group g computes;
            # without it, one group at a time
            ahead = (mover.up(cur[0]), mover.up(res[0]))
            for g in range(n_groups):
                xg, rg = ahead
                xo, ro, pg = compute(g, xg, rg)
                del xg, rg
                if pg is not None:
                    parts.append(pg)
                if prefetch and g + 1 < n_groups:
                    ahead = (mover.up(cur[g + 1]), mover.up(res[g + 1]))
                cur[g], res[g] = mover.down(narrow(xo)), mover.down(narrow(ro))
                del xo, ro
                if not prefetch and g + 1 < n_groups:
                    ahead = (mover.up(cur[g + 1]), mover.up(res[g + 1]))
        stats = _pool(parts, B) if parts else None

    # the owned regions into the canvas
    scale_num, scale_den = (8, 1) if which == "decoder" else (1, 8)

    def s(v):
        return v * scale_num // scale_den

    C_out = cur[0].shape[1]
    out = torch.zeros((B, C_out, s(plan.h), s(plan.w)), dtype=cur[0].dtype, device=home)
    for t, ((oy, ox), (y0, y1, x0, x1)) in enumerate(zip(plan.in_origins, plan.owned)):
        g, k = divmod(t, group_size)
        tile = cur[g][k * B:(k + 1) * B]
        out[:, :, s(y0):s(y1), s(x0):s(x1)] = \
            tile[:, :, s(y0 - oy):s(y1 - oy), s(x0 - ox):s(x1 - ox)]
    return out.to(device)
