"""Plain forms of what surrounds the networks in a tiled diffusion image:
the noise schedule, the Euler and DPM++ 2M steps, classifier-free guidance,
the MultiDiffusion and Mixture of Diffusers tile fusion with BACKGROUND
regions, the region-seeded noise, the exact tiled VAE, the Lanczos upscale,
noise inversion and the guided-filter renoise mask.

Written from the published methods (k-diffusion's samplers and discrete
schedule, MultiDiffusion arXiv:2302.08113, Mixture of Diffusers
arXiv:2302.02412, the Tiled Diffusion and Tiled VAE extension for
AUTOMATIC1111) in float32 and float64 numpy; it imports nothing of the
program. The geometry (tile grids, VAE tile plans, derived seeds) is the
extension's, so that both sides cut the canvas alike.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .nets import VAE, Precision, TileMasks, UNet

# ------------------------------------------------------------- seeds


def derived_seed(seed: int, tag: int) -> int:
    """numpy's SeedSequence of (seed, tag), one 64-bit word."""
    return int(np.random.SeedSequence([seed % 2**64, tag]).generate_state(1, np.uint64)[0])


# ---------------------------------------------------------- schedule


@dataclass(frozen=True)
class Schedule:
    """k-diffusion's discrete wrapping of the DDPM scaled-linear schedule."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012

    @property
    def sigmas(self) -> np.ndarray:
        betas = np.linspace(self.beta_start ** 0.5, self.beta_end ** 0.5,
                            self.num_train_timesteps, dtype=np.float64) ** 2
        ac = np.cumprod(1.0 - betas).astype(np.float32)
        return np.sqrt((1.0 - ac) / ac)

    def sampling_sigmas(self, steps: int, karras: bool) -> np.ndarray:
        table = self.sigmas
        if karras:
            rho = 7.0
            ramp = np.linspace(0, 1, steps)
            lo, hi = float(table[0]) ** (1 / rho), float(table[-1]) ** (1 / rho)
            sig = (hi + ramp * (lo - hi)) ** rho
            return np.append(sig, 0.0).astype(np.float32)
        t = np.linspace(len(table) - 1, 0, steps)
        log_t = np.interp(t, np.arange(len(table)), np.log(table))
        return np.append(np.exp(log_t), 0.0).astype(np.float32)

    def t_for_sigma(self, sigma: float) -> float:
        """Fractional timestep: log sigma interpolated into the table."""
        log_table = np.log(self.sigmas.astype(np.float64))
        return float(np.interp(math.log(max(sigma, 1e-10)), log_table,
                               np.arange(len(log_table), dtype=np.float64)))


# ----------------------------------------------------------- geometry


@dataclass(frozen=True)
class Box:
    x: int
    y: int
    w: int
    h: int


def split_grid(w: int, h: int, tile_w: int, tile_h: int, overlap: int) -> List[Box]:
    """The extension's overlapped grid: evenly spaced origins, the last row
    and column pinned to the canvas edge."""
    tile_w, tile_h = min(tile_w, w), min(tile_h, h)
    cols = max(1, math.ceil((w - overlap) / (tile_w - overlap)))
    rows = max(1, math.ceil((h - overlap) / (tile_h - overlap)))
    dx = (w - tile_w) / (cols - 1) if cols > 1 else 0.0
    dy = (h - tile_h) / (rows - 1) if rows > 1 else 0.0
    out = []
    for r in range(rows):
        y = h - tile_h if r == rows - 1 else min(int(r * dy), h - tile_h)
        for c in range(cols):
            x = w - tile_w if c == cols - 1 else min(int(c * dx), w - tile_w)
            out.append(Box(x, y, tile_w, tile_h))
    return out


def batches(boxes: Sequence[Box], tile_bs: int) -> List[List[Box]]:
    """Near-equal batches: ceil(n / bs) batches of ceil(n / batches)."""
    if not boxes:
        return []
    nb = math.ceil(len(boxes) / tile_bs)
    bs = math.ceil(len(boxes) / nb)
    return [list(boxes[i * bs:(i + 1) * bs]) for i in range(nb)]


def gaussian(tile_w: int, tile_h: int) -> np.ndarray:
    """Mixture of Diffusers' tile weights: separable gaussians of variance
    0.01, both normalised by tile_w^2, x centred at (tile_w - 1) / 2 and y at
    tile_h / 2, as the extension draws them."""
    var = 0.01
    denom = float(tile_w * tile_w) * 2.0 * var
    norm = 1.0 / math.sqrt(2.0 * math.pi * var)
    x = np.arange(tile_w, dtype=np.float64)
    y = np.arange(tile_h, dtype=np.float64)
    xp = np.exp(-((x - (tile_w - 1) / 2.0) ** 2) / denom) * norm
    yp = np.exp(-((y - tile_h / 2.0) ** 2) / denom) * norm
    return np.outer(yp, xp).astype(np.float32)


def region_box(r: dict, w: int, h: int) -> Box:
    """A region in [0, 1] coordinates -> latent box: floor the origin, ceil
    the size, clamp into the canvas."""
    x, y = max(0, int(r["x"] * w)), max(0, int(r["y"] * h))
    return Box(x, y, min(w - x, math.ceil(r["w"] * w)), min(h - y, math.ceil(r["h"] * h)))


@dataclass
class TilePlan:
    mod: bool
    h: int
    w: int
    tile_h: int
    tile_w: int
    boxes: List[Box]
    batched: List[List[Box]]
    regions: List[Box]
    weights: np.ndarray                   # [h, w] summed paint weights
    tile_weight: Optional[np.ndarray]     # [th, tw] MoD gaussian
    region_weights: List[Optional[np.ndarray]]


def plan(method: str, h: int, w: int, tile: int, overlap: int, tile_bs: int,
         regions: Sequence[dict] = ()) -> TilePlan:
    mod = method == "Mixture of Diffusers"
    th, tw = min(tile, h), min(tile, w)
    overlap = max(0, min(overlap, min(tw, th) - 4))
    boxes = split_grid(w, h, tw, th, overlap)
    weights = np.zeros((h, w), np.float32)
    tw8 = gaussian(tw, th) if mod else None
    for b in boxes:
        weights[b.y:b.y + b.h, b.x:b.x + b.w] += tw8 if mod else 1.0
    rboxes, rweights = [], []
    for r in regions:
        if r.get("blend_mode", "Background") != "Background":
            raise NotImplementedError("the reference has BACKGROUND regions only")
        rb = region_box(r, w, h)
        g = gaussian(rb.w, rb.h) if mod else None
        weights[rb.y:rb.y + rb.h, rb.x:rb.x + rb.w] += g if mod else 1.0
        rboxes.append(rb)
        rweights.append(g)
    return TilePlan(mod, h, w, th, tw, boxes, batches(boxes, tile_bs), rboxes, weights, tw8,
                    rweights)


def region_noise(noise: torch.Tensor, regions: Sequence[Box], seed: int) -> torch.Tensor:
    """Each region's patch, from a generator on the noise's device seeded
    with a seed drawn (0 <= s < 2^31 - 1) from a CPU generator seeded with
    derived_seed(seed, 1000 + i); BACKGROUND patches averaged where they
    overlap, replacing the base noise."""
    if not regions:
        return noise
    _, C, H, W = noise.shape
    buf = torch.zeros_like(noise)
    cnt = torch.zeros((1, 1, H, W), dtype=torch.float32, device=noise.device)
    for i, r in enumerate(regions):
        cpu = torch.Generator().manual_seed(derived_seed(seed, 1000 + i))
        rs = int(torch.randint(0, 2**31 - 1, (), generator=cpu))
        gen = torch.Generator(device=noise.device).manual_seed(rs)
        patch = torch.randn((1, C, r.h, r.w), generator=gen, dtype=noise.dtype,
                            device=noise.device)
        buf[:, :, r.y:r.y + r.h, r.x:r.x + r.w] += patch
        cnt[:, :, r.y:r.y + r.h, r.x:r.x + r.w] += 1.0
    buf = torch.where(cnt > 1, buf / cnt, buf)
    return torch.where(cnt > 0, buf, noise)


# ------------------------------------------------------------- denoise


@dataclass
class Conds:
    """Leaves of one prompt: context [1, 77, D]; SDXL's pooled [1, P] and
    time_ids [1, 6]."""

    context: torch.Tensor
    pooled: Optional[torch.Tensor] = None
    time_ids: Optional[torch.Tensor] = None

    def repeat(self, n: int) -> "Conds":
        def rep(t):
            return None if t is None else t.expand(n, *t.shape[1:])
        return Conds(rep(self.context), rep(self.pooled), rep(self.time_ids))


def cat_conds(a: Conds, b: Conds) -> Conds:
    def cat(x, y):
        return None if x is None else torch.cat([x, y])
    return Conds(cat(a.context, b.context), cat(a.pooled, b.pooled), cat(a.time_ids, b.time_ids))


class Denoiser:
    """The eps-prediction UNet in sigma space: denoised = x - sigma * eps(x /
    sqrt(sigma^2 + 1), t(sigma)), with classifier-free guidance over one
    batch of [uncond, cond]."""

    def __init__(self, unet: UNet, p: Precision, schedule: Schedule):
        self.unet, self.p, self.schedule = unet, p, schedule

    def eps(self, x, sigma: float, conds: Conds, retouch: float = 1.0):
        t = torch.full((x.shape[0],), self.schedule.t_for_sigma(sigma) / retouch,
                       dtype=torch.float32, device=x.device)
        return self.unet(self.p, x, t, conds.context, conds.pooled, conds.time_ids)

    def guided(self, x, sigma: float, cond: Conds, uncond: Conds, cfg: float):
        B = x.shape[0]
        c_in = 1.0 / math.sqrt(sigma * sigma + 1.0)
        both = cat_conds(uncond.repeat(B), cond.repeat(B))
        xx = torch.cat([x, x])
        den = xx - sigma * self.eps(xx * c_in, sigma, both).float()
        du, dc = den.chunk(2)
        return du + cfg * (dc - du)


def tiled_denoised(x, tp: TilePlan, tile_fn: Callable, region_fns: Sequence[Callable] = ()):
    """The fused canvas of the plan's tiles and BACKGROUND regions:
    MultiDiffusion sums the outputs and divides by the paint count where it
    exceeds 1; Mixture of Diffusers weights every output by its gaussian
    times 1 / (summed weights) and divides no more."""
    dev = x.device
    buf = torch.zeros_like(x)
    w = torch.as_tensor(tp.weights, device=dev)
    rescale = torch.where(w > 0, 1.0 / torch.where(w > 0, w, torch.ones_like(w)),
                          torch.zeros_like(w))
    gw = None if tp.tile_weight is None else torch.as_tensor(tp.tile_weight, device=dev)
    for bb in tp.batched:
        tiles = torch.cat([x[:, :, b.y:b.y + b.h, b.x:b.x + b.w] for b in bb])
        out = tile_fn(tiles)
        for k, b in enumerate(bb):
            o = out[k * x.shape[0]:(k + 1) * x.shape[0]]
            if tp.mod:
                o = o * gw * rescale[b.y:b.y + b.h, b.x:b.x + b.w]
            buf[:, :, b.y:b.y + b.h, b.x:b.x + b.w] += o
    for r, g, fn in zip(tp.regions, tp.region_weights, region_fns):
        o = fn(x[:, :, r.y:r.y + r.h, r.x:r.x + r.w])
        if tp.mod:
            o = o * torch.as_tensor(g, device=dev) * rescale[r.y:r.y + r.h, r.x:r.x + r.w]
        buf[:, :, r.y:r.y + r.h, r.x:r.x + r.w] += o
    return buf if tp.mod else torch.where(w > 1, buf / w, buf)


# ------------------------------------------------------------- samplers


def euler_step(x, den, s: float, sn: float):
    return x + (x - den) / s * (sn - s)


def dpmpp_2m_step(x, den, old_den, sigmas: Sequence[float], i: int):
    """DPM-Solver++(2M), k-diffusion's form; ``old_den`` the previous step's
    denoised (None at the first step)."""
    s, sn = float(sigmas[i]), float(sigmas[i + 1])
    if sn == 0:
        return den
    t, tn = -math.log(s), -math.log(sn)
    h = tn - t
    if old_den is None:
        return (sn / s) * x - math.expm1(-h) * den
    r = (t + math.log(float(sigmas[i - 1]))) / h
    den_d = (1 + 1 / (2 * r)) * den - (1 / (2 * r)) * old_den
    return (sn / s) * x - math.expm1(-h) * den_d


# ---------------------------------------------------------- tiled VAE

ENCODER_PAD, DECODER_PAD = 32, 11


@dataclass
class VAEPlan:
    in_h: int
    in_w: int
    origins: List[Tuple[int, int]]
    owned: List[Tuple[int, int, int, int]]

    def masks(self, device) -> TileMasks:
        m = torch.zeros((len(self.origins), 1, self.in_h, self.in_w), device=device)
        for t, ((oy, ox), (y0, y1, x0, x1)) in enumerate(zip(self.origins, self.owned)):
            m[t, 0, y0 - oy:y1 - oy, x0 - ox:x1 - ox] = 1.0
        return TileMasks(m)


def vae_plan(h: int, w: int, tile: int, pad: int) -> Optional[VAEPlan]:
    """The Tiled VAE split: tile sides rounded up to 32, a halo of ``pad``,
    every padded tile the same size (edge tiles slide inward); None when the
    canvas needs no split."""
    if max(h, w) <= 2 * pad + tile:
        return None

    def up32(v):
        return (v + 31) // 32 * 32

    nth = max(1, math.ceil((h - 2 * pad) / tile))
    ntw = max(1, math.ceil((w - 2 * pad) / tile))
    rth = min(up32(math.ceil((h - 2 * pad) / nth)), up32(h))
    rtw = min(up32(math.ceil((w - 2 * pad) / ntw)), up32(w))
    in_h, in_w = min(rth + 2 * pad, h), min(rtw + 2 * pad, w)
    origins, owned = [], []
    for i in range(nth):
        y0, y1 = pad + i * rth, min(pad + (i + 1) * rth, h)
        oy0, oy1 = (y0 if i > 0 else 0), (y1 if i < nth - 1 else h)
        ty = min(max(0, y0 - pad), h - in_h)
        for j in range(ntw):
            x0, x1 = pad + j * rtw, min(pad + (j + 1) * rtw, w)
            ox0, ox1 = (x0 if j > 0 else 0), (x1 if j < ntw - 1 else w)
            tx = min(max(0, x0 - pad), w - in_w)
            origins.append((ty, tx))
            owned.append((oy0, oy1, ox0, ox1))
    return VAEPlan(in_h, in_w, origins, owned)


def _tiled(fn, x, vp: Optional[VAEPlan], num: int, den: int, out_ch: int):
    """``fn(tiles, masks)`` over the plan's lockstep tiles, each tile's owned
    part placed into the canvas (scale num / den from input to output)."""
    if vp is None:
        return fn(x, None)
    B = x.shape[0]
    tiles = torch.cat([x[:, :, oy:oy + vp.in_h, ox:ox + vp.in_w] for oy, ox in vp.origins])
    out_t = fn(tiles, vp.masks(x.device))

    def s(v):
        return v * num // den

    out = torch.zeros((B, out_ch, s(x.shape[2]), s(x.shape[3])), device=x.device)
    for t, ((oy, ox), (y0, y1, x0, x1)) in enumerate(zip(vp.origins, vp.owned)):
        out[:, :, s(y0):s(y1), s(x0):s(x1)] = out_t[t * B:(t + 1) * B, :, s(y0 - oy):s(y1 - oy),
                                                    s(x0 - ox):s(x1 - ox)]
    return out


def exact_decode(vae: VAE, p: Precision, z, tile: int):
    """[B, 4, h, w] scaled latents -> [B, 3, 8h, 8w] in [-1, 1] (unclamped)."""
    z = z / vae.spec.scaling_factor
    return _tiled(lambda t, m: vae.decode(p, t, m), z, vae_plan(z.shape[2], z.shape[3], tile,
                                                                DECODER_PAD),
                  8, 1, vae.spec.out_channels)


def exact_encode_moments(vae: VAE, p: Precision, x, tile: int):
    """[B, 3, H, W] in [-1, 1] -> [B, 8, H / 8, W / 8] moments."""
    return _tiled(lambda t, m: vae.encode_moments(p, t, m), x,
                  vae_plan(x.shape[2], x.shape[3], tile, ENCODER_PAD), 1, 8,
                  2 * vae.spec.latent_channels)


# --------------------------------------------------------------- images


def to_uint8(x) -> np.ndarray:
    """[B, 3, H, W] in [-1, 1] -> uint8 [B, H, W, 3]."""
    a = x.detach().float().cpu().numpy()
    a = np.clip((a + 1.0) / 2.0, 0.0, 1.0)
    return (a.transpose(0, 2, 3, 1) * 255.0 + 0.5).astype(np.uint8)


def from_uint8(img: np.ndarray, device) -> torch.Tensor:
    x = img.astype(np.float32) / 255.0 * 2.0 - 1.0
    return torch.from_numpy(np.ascontiguousarray(x.transpose(2, 0, 1)[None])).to(device)


def lanczos_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] Lanczos-3 resampling with half-pixel centres, taps
    normalised to sum 1, edges replicated."""
    W = np.zeros((n_out, n_in), np.float64)
    if n_in == n_out:
        np.fill_diagonal(W, 1.0)
        return W.astype(np.float32)
    a = 3
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    lo = np.floor(src).astype(np.int64)
    offs = np.arange(-a + 1, a + 1)
    for i in range(n_out):
        t = offs - (src[i] - lo[i])
        taps = np.sinc(t) * np.sinc(t / a)
        taps /= taps.sum()
        for k, o in enumerate(offs):
            W[i, min(max(lo[i] + o, 0), n_in - 1)] += taps[k]
    return W.astype(np.float32)


def resize(x, size: Tuple[int, int], matrix=lanczos_matrix):
    H, W = x.shape[-2:]
    if (H, W) == tuple(size):
        return x
    wh = torch.as_tensor(matrix(H, size[0]), device=x.device)
    ww = torch.as_tensor(matrix(W, size[1]), device=x.device)
    return torch.matmul(torch.matmul(wh, x.float()), ww.t())


def linear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] linear resampling, half-pixel centres, edges clamped."""
    W = np.zeros((n_out, n_in), np.float64)
    if n_in == n_out:
        np.fill_diagonal(W, 1.0)
        return W.astype(np.float32)
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    lo = np.floor(src).astype(np.int64)
    frac = src - lo
    for i in range(n_out):
        W[i, min(max(lo[i], 0), n_in - 1)] += 1 - frac[i]
        W[i, min(max(lo[i] + 1, 0), n_in - 1)] += frac[i]
    return W.astype(np.float32)


def gray_u8(img: np.ndarray) -> np.ndarray:
    return (img[..., :3].astype(np.float32) @ np.array([0.299, 0.587, 0.114],
                                                       np.float32)).astype(np.uint8)


def box_blur(img: np.ndarray, k: int) -> np.ndarray:
    """k x k mean with reflect-101 borders (cv2.blur)."""
    lo = k // 2
    p = np.pad(img.astype(np.float64), ((lo, k - lo - 1), (lo, k - lo - 1)), mode="reflect")
    c = np.cumsum(np.cumsum(p, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)))
    h, w = img.shape
    return (c[k:k + h, k:k + w] - c[:h, k:k + w] - c[k:k + h, :w] + c[:h, :w]) / float(k * k)


def retouch_mask(gray: np.ndarray, k: int) -> np.ndarray:
    """Guided filter of the image against itself (ridge 0.01); the detail
    |filtered - image| quantised to uint8, as the extension makes it."""
    img = gray.astype(np.float64) / 255.0
    mean = box_blur(img, k)
    var = box_blur(img * img, k) - mean * mean
    a = var / (var + 0.01)
    gf = np.clip((a * img + (mean - a * mean) - img) * 255.0, 0, 255).astype(np.uint8)
    return gf.astype(np.float32) / 255.0
