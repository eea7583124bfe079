"""DemoFusion: progressive xN upscaling with jittered local windows and
dilated global views (arXiv 2311.16973; counterpart of the unrolled path of
``mdu_tpu/tiling/demofusion.py``, ref tile_methods/demofusion.py and
scripts/tileglobal.py).

Each phase after the first is an img2img sampling run of the upscaled latent
whose denoiser is a DemoFusion combinator, per step (ref demofusion.py:185-324):

    cosf   = 0.5 (1 + cos(pi (step + 1) / (t_enc + 1)))
    x     <- x (1 - c1) + (lat0 + noise sigma) c1          c1 = cosf^s1
    local  = uniform-average fusion over jittered windows
    global = fusion over the s^2 dilated views x[..., oy::s, ox::s] of a
             gaussian-blurred copy (sigma = cfg.sigma c3), re-anchored to the
             padded canvas's mean and std; 'mixture' runs half the views on
             the unblurred input and halves the sum
    out    = local (1 - c2) + global c2

and per phase (ref tileglobal.py:274-362) the latent is upscaled bicubically,
re-noised through the truncated schedule, sampled, and its mean and std are
re-anchored to the first phase's. Window jitter is drawn once a phase with
``np.random.default_rng(seed)`` in the JAX package's order, so a seed gives
its windows exactly; edge windows jitter only inward, as in the JAX package
(the reference jitters them outward into the pad). Canvas-shaped cond leaves
(ControlNet hints, a StableSR guidance latent) are cut per window and resized
per phase and per view. The conds may be scheduled, AND conds or callables of
the step: each step resolves its cond first and then cuts it, an AND cond
branch by branch.

Under DeepCache the global dilated views run the cached denoiser, one cache
a view batch: their geometry is the same every step. The local windows
re-jitter every step, so a cached deep feature would belong to another crop,
and they run the full model (``mdu_tpu/tiling/demofusion.py:507-600``).

The window and view batches run one after another: the JAX package can roll
them into a ``lax.scan`` (``scan_windows``), which bounds its compile memory
and gives the same result.
"""
from __future__ import annotations

import math
import sys
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DemoFusionConfig, SamplerConfig
from ..ops.blur import gaussian_blur_nchw
from ..ops.resize import resize_nchw
from ..utils.bbox import BBox
from ..utils.grid import batch_bboxes
from ..samplers.denoiser import mark_deepcache
from .conds import Cond, dequantize_hint, is_and, map_leaves

LATENT_TO_PIXEL = 8


@dataclass(frozen=True)
class DemoFusionPhasePlan:
    scale: int
    h: int                       # latent canvas of this phase
    w: int
    tile: int
    jitter: int                  # max |offset|; the canvas is padded by this much
    windows: Tuple[BBox, ...]    # un-jittered bases in unpadded coordinates
    window_batches: Tuple[Tuple[int, ...], ...]       # window index batches
    jitter_lo: Tuple[Tuple[int, int], ...]            # per-window (dy, dx) min
    jitter_hi: Tuple[Tuple[int, int], ...]            # per-window (dy, dx) max
    global_offsets: Tuple[Tuple[int, int], ...]       # (oy, ox), doubled if mixture
    global_batches: Tuple[Tuple[Tuple[int, int], ...], ...]


def plan_demofusion_phase(h: int, w: int, scale: int,
                          cfg: DemoFusionConfig) -> DemoFusionPhasePlan:
    """The window grid (ref demofusion.py:101-138) and the dilated global
    offsets (ref :87-99) of one phase; the jitter ranges are fixed here and
    drawn per phase by ``draw_jitter``."""
    tile = min(cfg.window_size, min(h, w))
    overlap = max(0, min(cfg.overlap, tile - 4))
    stride = max(4, tile - overlap)

    cols = max(1, math.ceil((w - overlap) / (tile - overlap)))
    rows = max(1, math.ceil((h - overlap) / (tile - overlap)))
    dx = (w - tile) / (cols - 1) if cols > 1 else 0.0
    dy = (h - tile) / (rows - 1) if rows > 1 else 0.0

    jitter = 0
    if cfg.random_jitter:
        jitter = min(max((min(w, h) - stride) // 4, 0), min(tile // 2, overlap // 2))

    windows: List[BBox] = []
    lo: List[Tuple[int, int]] = []
    hi: List[Tuple[int, int]] = []
    for r in range(rows):
        for c in range(cols):
            y = min(int(r * dy), h - tile)
            x = min(int(c * dx), w - tile)
            windows.append(BBox(x, y, tile, tile))
            # interior windows jitter both ways, edge windows only inward
            lo.append((-jitter if y != 0 else 0, -jitter if x != 0 else 0))
            hi.append((jitter if y + tile != h else 0, jitter if x + tile != w else 0))

    offsets = [(oy, ox) for oy in range(scale) for ox in range(scale)]
    if cfg.mixture:
        offsets = offsets + offsets
    return DemoFusionPhasePlan(
        scale=scale, h=h, w=w, tile=tile, jitter=jitter, windows=tuple(windows),
        window_batches=tuple(tuple(b) for b in
                             batch_bboxes(list(range(len(windows))), cfg.tile_bs)),
        jitter_lo=tuple(lo), jitter_hi=tuple(hi), global_offsets=tuple(offsets),
        global_batches=tuple(tuple(b) for b in batch_bboxes(offsets, cfg.tile_bs_g)))


def draw_jitter(plan: DemoFusionPhasePlan, rng: np.random.Generator) -> np.ndarray:
    """The phase's window offsets [n_windows, 2] (dy, dx), drawn in window
    order, dy before dx."""
    out = np.zeros((len(plan.windows), 2), np.int32)
    for i, (lo, hi) in enumerate(zip(plan.jitter_lo, plan.jitter_hi)):
        out[i, 0] = rng.integers(lo[0], hi[0] + 1)
        out[i, 1] = rng.integers(lo[1], hi[1] + 1)
    return out


# ------------------------------------------------------------ cond slicing


def _map_cond(c: Optional[Cond], fn) -> Optional[Cond]:
    """``fn`` over the leaves of a plain or AND cond (an AND's weights kept)."""
    if c is None:
        return None
    if is_and(c):
        return {"__and__": [_map_cond(p, fn) for p in c["__and__"]],
                "__weights__": c["__weights__"]}
    return map_leaves(fn, c)


def _is_canvas(leaf, hw: Tuple[int, int]) -> bool:
    return leaf.dim() == 4 and tuple(leaf.shape[2:]) == tuple(hw)


def _pad_spatial(c: Optional[Cond], jr: int, hw: Tuple[int, int]) -> Optional[Cond]:
    """Pad canvas-shaped cond leaves as the latent canvas is padded."""
    if c is None or jr == 0:
        return c
    H, W = hw
    f = LATENT_TO_PIXEL

    def pad(leaf):
        if _is_canvas(leaf, (H, W)):
            return F.pad(leaf, (jr, jr, jr, jr))
        if _is_canvas(leaf, (H * f, W * f)):
            return F.pad(leaf, (jr * f,) * 4)
        return leaf

    return _map_cond(c, pad)


def _window_cond(c_pad: Optional[Cond], offs: Sequence[Tuple[int, int]], tile: int,
                 hw: Tuple[int, int], jr: int) -> Optional[Cond]:
    """The cond of a window batch at padded offsets ``offs`` (tile-major)."""
    if c_pad is None:
        return None
    H, W = hw
    f = LATENT_TO_PIXEL
    P = (H + 2 * jr, W + 2 * jr)

    def cut(leaf):
        if _is_canvas(leaf, P):
            return torch.cat([leaf[:, :, oy:oy + tile, ox:ox + tile] for oy, ox in offs])
        if _is_canvas(leaf, (P[0] * f, P[1] * f)):
            return torch.cat([leaf[:, :, oy * f:(oy + tile) * f, ox * f:(ox + tile) * f]
                              for oy, ox in offs])
        return torch.cat([leaf] * len(offs))

    return _map_cond(c_pad, cut)


def _dilated_cond(c: Optional[Cond], views: Sequence[Tuple[int, int]], scale: int,
                  hw: Tuple[int, int]) -> Optional[Cond]:
    """The cond of a batch of dilated views: latent-canvas leaves strided
    ``[oy::s, ox::s]``; a pixel-space hint, whose view offsets lie below its
    resolution, resized bilinearly to the view's pixel size."""
    if c is None:
        return None
    H, W = hw
    f = LATENT_TO_PIXEL

    def cut(leaf):
        if _is_canvas(leaf, (H, W)):
            return torch.cat([leaf[:, :, oy::scale, ox::scale] for oy, ox in views])
        if _is_canvas(leaf, (H * f, W * f)):
            small = resize_nchw(dequantize_hint(leaf), (H // scale * f, W // scale * f),
                                "linear")
            return torch.cat([small] * len(views))
        return torch.cat([leaf] * len(views))

    return _map_cond(c, cut)


def resize_spatial_conds(c: Optional[Cond], src_hw: Tuple[int, int],
                         dst_hw: Tuple[int, int]) -> Optional[Cond]:
    """Canvas-shaped cond leaves follow the latent canvas from phase to phase
    (bilinear; a hint is dequantised first)."""
    if c is None or tuple(src_hw) == tuple(dst_hw):
        return c
    (sh, sw), (dh, dw) = src_hw, dst_hw
    f = LATENT_TO_PIXEL

    def rs(leaf):
        if _is_canvas(leaf, (sh, sw)) and leaf.shape[1] > 0:
            return resize_nchw(leaf, (dh, dw), "linear")
        if _is_canvas(leaf, (sh * f, sw * f)) and leaf.shape[1] > 0:
            return resize_nchw(dequantize_hint(leaf), (dh * f, dw * f), "linear")
        return leaf

    return _map_cond(c, rs)


# --------------------------------------------------------------- denoiser


def demofusion_deepcache_aux(pipe, plan: DemoFusionPhasePlan, uncond_is_none: bool,
                             cfg_scale: float, n_and: int, branch: int,
                             B: int) -> List[torch.Tensor]:
    """The global views' DeepCache caches, zeros in the UNet's dtype, one a
    view batch: [mult * views * B, C_b, h / s / 2^(b-1), w / s / 2^(b-1)],
    ``mult`` P + 1 under an AND of P, 2 under CFG, else 1
    (``mdu_tpu/tiling/demofusion.py:469-505``, the unrolled form)."""
    bc = pipe.unet.cfg.block_out_channels
    if not 1 <= branch <= len(bc) - 1:
        raise ValueError(f"cache_branch must be in [1, {len(bc) - 1}]")
    mult = (n_and + 1) if n_and else (1 if (uncond_is_none or cfg_scale == 1.0) else 2)
    down = 2 ** (branch - 1)
    hs, ws = plan.h // plan.scale, plan.w // plan.scale
    if hs % down or ws % down:
        raise ValueError(f"deepcache_branch={branch} needs dilated-view dims divisible by "
                         f"{down}, got {hs}x{ws}")
    return [torch.zeros((mult * len(b) * B, bc[branch], hs // down, ws // down),
                        dtype=pipe.unet.dtype, device=pipe.device) for b in plan.global_batches]


def make_demofusion_denoiser(plan: DemoFusionPhasePlan, cfg: DemoFusionConfig,
                             guided: Callable, cond, uncond, lat0: torch.Tensor,
                             noise: torch.Tensor, t_enc: int, jitter: np.ndarray,
                             deepcache: int = 1, guided_cached: Optional[Callable] = None,
                             caches: Optional[List[torch.Tensor]] = None):
    """``denoised_fn(x, sigma, step)`` of one DemoFusion phase over
    ``guided(x, sigma, c, u)``, the pipeline's CFG'd denoiser. ``cond`` and
    ``uncond`` are prepared conds (``DiffusionPipeline._prepare``), resolved
    every step. ``jitter`` [n_windows, 2] holds the phase's window offsets.
    With ``deepcache`` N > 1 the global views run ``guided_cached`` on
    ``caches`` (``demofusion_deepcache_aux``), the cached pass on the steps
    that N does not divide."""
    from ..pipeline import DiffusionPipeline

    use_cache = deepcache > 1
    s, jr, tile = plan.scale, plan.jitter, plan.tile
    hw = (plan.h, plan.w)
    offs = [(b.y + jr + int(j[0]), b.x + jr + int(j[1]))
            for b, j in zip(plan.windows, np.asarray(jitter))]
    cond_f = DiffusionPipeline._as_cond_fn(cond)
    uncond_f = DiffusionPipeline._as_cond_fn(uncond)
    n_total = len(plan.global_offsets)

    def denoised_fn(x, sigma, step):
        B, C, H, W = x.shape
        f32 = dict(dtype=torch.float32, device=x.device)
        cosf = 0.5 * (1.0 + torch.cos(math.pi * (torch.tensor(step, **f32) + 1.0)
                                      / (t_enc + 1.0)))
        c1 = cosf ** cfg.cosine_scale_1
        x = x * (1.0 - c1) + (lat0 + noise * sigma) * c1
        xp = F.pad(x, (jr, jr, jr, jr))
        c_step = cond_f(step)
        u_step = uncond_f(step) if uncond_f is not None else None
        c_pad, u_pad = _pad_spatial(c_step, jr, hw), _pad_spatial(u_step, jr, hw)

        # local windows: uniform average (ref :251-264)
        buf = torch.zeros_like(xp)
        cnt = torch.zeros((1, 1, H + 2 * jr, W + 2 * jr), **f32)
        for batch in plan.window_batches:
            woffs = [offs[i] for i in batch]
            tiles = torch.cat([xp[:, :, oy:oy + tile, ox:ox + tile] for oy, ox in woffs])
            out = guided(tiles, sigma, _window_cond(c_pad, woffs, tile, hw, jr),
                         _window_cond(u_pad, woffs, tile, hw, jr))
            out = out.reshape(len(batch), B, C, tile, tile)
            for k, (oy, ox) in enumerate(woffs):
                buf[:, :, oy:oy + tile, ox:ox + tile] += out[k]
                cnt[:, :, oy:oy + tile, ox:ox + tile] += 1.0
        cnt = torch.where(cnt == 0, torch.ones_like(cnt), cnt)   # jitter can leave gaps
        x_local = (buf / cnt)[:, :, jr:jr + H, jr:jr + W]

        # global dilated views (ref :266-316); population std, as jnp.std
        std_, mean_ = xp.std(correction=0), xp.mean()
        c3 = 0.99 * cosf ** cfg.cosine_scale_3 + 1e-2
        if cfg.gaussian_filter:
            xg = gaussian_blur_nchw(x, 2 * s - 1, cfg.sigma * c3)
            xg = (xg - xg.mean()) / xg.std(correction=0) * std_ + mean_
        else:
            xg = x
        x_global = torch.zeros_like(x)
        seen = 0
        for bi, batch in enumerate(plan.global_batches):
            # mixture: the first half of the doubled offsets sees the
            # unblurred input (ref :283-304)
            views = [(x if cfg.mixture and seen + k < n_total // 2 else xg)[:, :, oy::s, ox::s]
                     for k, (oy, ox) in enumerate(batch)]
            cg, ug = _dilated_cond(c_step, batch, s, hw), _dilated_cond(u_step, batch, s, hw)
            if use_cache:
                out, caches[bi] = guided_cached(torch.cat(views), sigma, cg, ug, caches[bi],
                                                step % deepcache != 0)
            else:
                out = guided(torch.cat(views), sigma, cg, ug)
            out = out.reshape(len(batch), B, C, out.shape[-2], out.shape[-1])
            for k, (oy, ox) in enumerate(batch):
                x_global[:, :, oy::s, ox::s] += out[k]
            seen += len(batch)
        if cfg.mixture:
            x_global = x_global / 2.0

        c2 = cosf ** cfg.cosine_scale_2
        return x_local * (1.0 - c2) + x_global * c2

    return mark_deepcache(denoised_fn) if use_cache else denoised_fn


# ------------------------------------------------------------- generation


def demofusion_info(sp: SamplerConfig, cfg: DemoFusionConfig, seed: int,
                    phases: Sequence[torch.Tensor]) -> dict:
    """The run's settings, which ``config.demofusion_from_png_info`` reads
    back (ref tileglobal.py:28-40 records every phase's size)."""
    return {
        "Sampler": sp.name, "Steps": sp.steps, "CFG scale": sp.cfg_scale, "Seed": seed,
        "DemoFusion": {
            "Scale factor": cfg.scale_factor, "Window size": cfg.window_size,
            "Overlap": cfg.overlap, "Tile batch size": cfg.tile_bs,
            "Global batch size": cfg.tile_bs_g, "Cosine scale 1": cfg.cosine_scale_1,
            "Cosine scale 2": cfg.cosine_scale_2, "Cosine scale 3": cfg.cosine_scale_3,
            "Sigma": cfg.sigma, "Random jitter": cfg.random_jitter, "Mixture": cfg.mixture,
            "Gaussian filter": cfg.gaussian_filter,
            "Keep intermediate": cfg.keep_intermediate,
            "Denoise strengths": list(cfg.denoise_strengths),
            "Phase sizes": [[int(p.shape[-2]) * 8, int(p.shape[-1]) * 8] for p in phases],
        },
    }


def demofusion_generate(pipe, cond, uncond, width: int, height: int,
                        base_noise, phase_noises: Sequence, cfg: DemoFusionConfig,
                        sp: SamplerConfig, seed: int, sampler_noise: Callable,
                        init_latent: Optional[torch.Tensor] = None, tiled_vae=None,
                        decode: bool = True):
    """The multi-phase generation (ref tileglobal.py:274-362). Phase 1 is an
    untiled ``width`` x ``height`` txt2img from ``base_noise`` (or takes
    ``init_latent``); each later phase, at ``scale`` times the size, upscales
    the latent bicubically, re-noises it through the truncated schedule with
    its unit noise ``phase_noises[scale - 2]``, samples it with the
    DemoFusion denoiser and re-anchors its mean and std to phase 1's.
    ``cond`` and ``uncond`` are prepared conds (plain, banks, AND conds or
    callables). ``sampler_noise``: the stochastic samplers' noise, for every
    phase. Once ``pipe.interrupted`` is set the phase's denoiser runs
    nothing and no later phase starts (``mdu_tpu/tiling/demofusion.py:
    835-836, 872-873``). The result's ``latents`` is the last kept phase's and
    ``phase_latents`` holds every phase's."""
    from ..pipeline import GenerationResult

    if sp.deepcache > 1:
        print("[DemoFusion] DeepCache active on the global dilated views only (windows "
              "re-jitter every step and stay uncached)", file=sys.stderr)

    if init_latent is None:
        latents = pipe._txt2img_from_noise(base_noise, cond, uncond, sp, seed, decode=False,
                                           sampler_noise=sampler_noise).latents
    else:
        latents = torch.as_tensor(init_latent, device=pipe.device)
    h0, w0 = height // 8, width // 8
    anchor_mean, anchor_std = latents.mean(), latents.std(correction=0)
    phases = [latents]
    rng = np.random.default_rng(seed)
    strengths = list(cfg.denoise_strengths) or [0.45]
    guided, guided_cached = pipe._make_guided(sp.cfg_scale, sp.deepcache_branch)
    n_and = len(cond["__and__"]) if is_and(cond) else 0
    for phase_i, scale in enumerate(range(2, cfg.scale_factor + 1)):
        if pipe.interrupted:
            break                      # cooperative interruption between phases
        H, W = h0 * scale, w0 * scale
        lat0 = resize_nchw(latents, (H, W), "cubic")
        plan = plan_demofusion_phase(H, W, scale, cfg)
        jitter = draw_jitter(plan, rng)
        c_phase = pipe._prepare(cond, lambda p: resize_spatial_conds(p, (h0, w0), (H, W)))
        u_phase = pipe._prepare(uncond, lambda p: resize_spatial_conds(p, (h0, w0), (H, W)))
        strength = strengths[min(phase_i, len(strengths) - 1)]
        steps, t_enc = pipe.schedule.img2img_steps(sp.steps, strength)
        all_sig = torch.as_tensor(pipe.schedule.sampling_sigmas(steps, sp.schedule),
                                  device=lat0.device)
        sigmas = all_sig[steps - t_enc - 1:]
        noise = torch.as_tensor(phase_noises[phase_i], dtype=lat0.dtype, device=lat0.device)
        caches = (demofusion_deepcache_aux(pipe, plan, uncond is None, sp.cfg_scale, n_and,
                                           sp.deepcache_branch, lat0.shape[0])
                  if sp.deepcache > 1 else None)
        # per-step cooperative interruption, as in the tiled pipeline
        den_fn = pipe._interruptible(make_demofusion_denoiser(
            plan, cfg, guided, c_phase, u_phase, lat0, noise, t_enc, jitter, sp.deepcache,
            guided_cached, caches))
        latents = pipe._sample(sp, den_fn, lat0 + noise * sigmas[0], sigmas, sampler_noise)
        latents = ((latents - latents.mean()) / latents.std(correction=0) * anchor_std
                   + anchor_mean)
        phases.append(latents)

    keep = phases if cfg.keep_intermediate else [phases[-1]]
    images = [pipe._decode(p, tiled_vae) for p in keep] if decode else None
    return GenerationResult(images, keep[-1], seed, demofusion_info(sp, cfg, seed, phases),
                            phase_latents=phases)
