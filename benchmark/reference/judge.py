"""The comparison that decides ``correct``: a plain float32 reference judges
one image that the program produced in the measured window.

The program's state after every sampler step comes to the judge through
the pipeline's ``step_callback``; the judge takes each state, computes the
next one itself (the guided, tiled denoiser and the sampler's step, float32)
and compares (teacher forcing, as a served model's tokens are judged one
position at a time). The start of sampling is the judge's own: txt2img's
seeded noise with the regions' patches; img2img's Lanczos upscale, exact
tiled encode, sample of the moments, noise inversion and renoise mask. The
image is judged against the judge's exact tiled decode of the program's
final latent.

Numbers (each beside its limit in the workload file):

* ``step_err``: the largest, over the judged steps, of |x_prog - x_ref| /
  |x_ref - x_in| (L2 norms): the program's step against the reference's
  step from the same state, relative to the step's size;
* ``start_err`` (img2img): |x1_prog - x1_ref| / |x1_ref|, the first state,
  whose start the judge made from the input image and the seed;
* ``decode_rms``: root mean square difference of the uint8 images, in
  levels;
* ``decode_max``: the largest difference of the uint8 images, in levels
  (reported, not held to a limit: a widest gap over millions of pixels).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import diffusion as D
from .nets import VAE, Precision, UNet


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


class Reference:
    """The plain pipeline of one cell. ``weights``: {"unet.<name>": tensor,
    "vae.<name>": tensor} as the benchmark drew them; ``conds``: the
    benchmark's cond tensors (``cond``, ``uncond``, ``regions``, each a dict
    of ``crossattn`` / ``vector`` / ``time_ids``)."""

    def __init__(self, config: dict, workload: dict, weights: Dict[str, torch.Tensor],
                 conds: dict, device, precision: str = "fp32"):
        from .nets import build, load

        self.cfg, self.wl, self.device = config, workload, device
        self.p = Precision(precision)

        def part(prefix):
            return {k[len(prefix):]: v for k, v in weights.items() if k.startswith(prefix)}

        self.unet: UNet = load(build("unet", config["unet"]), part("unet."), device=device)
        self.vae: VAE = load(build("vae", config["vae"]), part("vae."), device=device)
        self.schedule = D.Schedule(**config.get("schedule", {}))
        self.den = D.Denoiser(self.unet, self.p, self.schedule)
        self.cond = self._conds(conds["cond"])
        self.uncond = self._conds(conds["uncond"])
        self.region_conds = [(self._conds(c), self._conds(u)) for c, u in conds.get("regions", [])]
        sp = workload["sampler"]
        self.cfg_scale = float(sp["cfg_scale"])
        self.sampler = sp["name"]
        if self.sampler.replace(" Karras", "") not in ("Euler", "DPM++ 2M"):
            raise NotImplementedError(f"the reference has Euler and DPM++ 2M, not {self.sampler}")
        self.karras = self.sampler.endswith(" Karras")

    def _conds(self, c: dict) -> D.Conds:
        def f(key):
            v = c.get(key)
            return None if v is None else v.to(self.device, torch.float32)
        return D.Conds(f("crossattn"), f("vector"), f("time_ids"))

    # ------------------------------------------------------------ geometry
    def _plan(self, h: int, w: int) -> D.TilePlan:
        td = self.wl["tiled_diffusion"]
        return D.plan(td["method"], h, w, td["tile_w"], td["overlap"], td["tile_bs"],
                      td.get("regions", ()))

    # ----------------------------------------------------------- denoising
    def denoised(self, x, sigma: float, tp: D.TilePlan):
        def tile_fn(tiles):
            return self.den.guided(tiles, sigma, self.cond, self.uncond, self.cfg_scale)

        region_fns = [lambda xr, c=c, u=u: self.den.guided(xr, sigma, c, u, self.cfg_scale)
                      for c, u in self.region_conds]
        return D.tiled_denoised(x, tp, tile_fn, region_fns)

    def step(self, x, i: int, sigmas, tp, old_den):
        den = self.denoised(x, float(sigmas[i]), tp)
        if self.sampler.startswith("DPM++ 2M"):
            return D.dpmpp_2m_step(x, den, old_den, [float(s) for s in sigmas], i), den
        return D.euler_step(x, den, float(sigmas[i]), float(sigmas[i + 1])), den

    # --------------------------------------------------------------- start
    def start(self, image_seed: int, image: Optional[np.ndarray] = None):
        """(x0, sigmas, plan): the first sampler state."""
        if self.wl["entry"] == "img2img":
            return self._start_img2img(image_seed, image)
        h, w = self.wl["height"] // 8, self.wl["width"] // 8
        C = self.cfg["unet"].get("out_channels", 4)
        gen = torch.Generator(device=self.device).manual_seed(image_seed)
        noise = torch.randn((1, C, h, w), generator=gen, device=self.device)
        tp = self._plan(h, w)
        noise = D.region_noise(noise, tp.regions, image_seed)
        sigmas = self.schedule.sampling_sigmas(self.wl["sampler"]["steps"], self.karras)
        return noise * float(sigmas[0]), sigmas, tp

    def upscaled(self, image: np.ndarray):
        td = self.wl["tiled_diffusion"]
        x = D.from_uint8(image, self.device)
        s = float(td["scale_factor"])
        x = D.resize(x, (int(x.shape[2] * s), int(x.shape[3] * s)))
        return x[:, :, :x.shape[2] // 8 * 8, :x.shape[3] // 8 * 8]

    def _start_img2img(self, image_seed: int, image: np.ndarray):
        td, tv, sp = self.wl["tiled_diffusion"], self.wl["tiled_vae"], self.wl["sampler"]
        x_img = self.upscaled(image)
        moments = D.exact_encode_moments(self.vae, self.p, x_img, tv["encoder_tile_size"])
        C = moments.shape[1] // 2
        gen = torch.Generator(device=self.device).manual_seed(image_seed)
        dtype = getattr(torch, self.cfg["dtype"])
        enc_noise = torch.randn((1, C) + tuple(moments.shape[2:]), generator=gen, dtype=dtype,
                                device=self.device).float()
        mean, logvar = moments[:, :C], moments[:, C:]
        init = (mean + torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0)) * enc_noise) \
            * self.vae.spec.scaling_factor
        noise = torch.randn(init.shape, generator=gen, dtype=torch.float32, device=self.device)
        steps = sp["steps"]
        t_enc = int(min(sp["denoising_strength"], 0.999) * steps)
        all_sigmas = self.schedule.sampling_sigmas(steps, self.karras)
        sigmas = all_sigmas[steps - t_enc - 1:]
        h, w = init.shape[2:]
        tp = self._plan(h, w)
        if td.get("noise_inverse"):
            xt = self.invert(init, tp, td["noise_inverse_steps"],
                             td.get("noise_inverse_retouch", 1.0))
            inverse = xt - init / float(all_sigmas[0])
            strength = td.get("noise_inverse_renoise_strength", 1.0)
            if strength > 0:
                detail = D.retouch_mask(D.gray_u8(D.to_uint8(x_img)[0]),
                                        td.get("noise_inverse_renoise_kernel", 64))
                m = 1.0 - D.resize(torch.as_tensor(detail, device=self.device)[None, None],
                                   (h, w), D.linear_matrix)
                m = torch.clamp(m * strength, 0.0, 1.0)
                noise = ((1 - m) * inverse + m * noise) / torch.sqrt(m ** 2 + (1 - m) ** 2)
            else:
                noise = inverse
        return init + noise * float(sigmas[0]), sigmas, tp

    def invert(self, init, tp: D.TilePlan, steps: int, retouch: float):
        """Reverse Euler over the ascending sigmas with the cond alone, no
        guidance; divided by the largest sigma."""
        sig = self.schedule.sampling_sigmas(steps, False)[:-1][::-1]
        prev = np.concatenate([[0.0], sig[:-1]])
        x = init.float()
        for i in range(steps):
            s, sp_ = float(sig[i]), float(prev[i])
            c_in = 1.0 / math.sqrt(s * s + 1.0)

            def tile_fn(tiles):
                return self.den.eps(tiles * c_in, s, self.cond.repeat(tiles.shape[0]),
                                    retouch).float()

            eps = D.tiled_denoised(x, tp, tile_fn, [
                lambda xr: self.den.eps(xr * c_in, s, self.cond, retouch).float()
                for _ in tp.regions])
            den = x - s * eps
            x = x + (x - den) / s * (s - sp_)
        return x / float(sig[-1])

    # -------------------------------------------------------------- decode
    def decode(self, latents) -> np.ndarray:
        out = D.exact_decode(self.vae, self.p, latents.to(self.device, torch.float32),
                             self.wl["tiled_vae"]["decoder_tile_size"])
        return D.to_uint8(out)

    # ------------------------------------------------------- as a program
    def generate(self, image_seed: int, image: Optional[np.ndarray] = None):
        """This reference run in the program's place: (states after every
        step, final latent, uint8 image)."""
        x, sigmas, tp = self.start(image_seed, image)
        traj, old = [], None
        for i in range(len(sigmas) - 1):
            x, old = self.step(x, i, sigmas, tp, old)
            traj.append(x)
        return traj, x, self.decode(x)


@torch.no_grad()
def judge(ref: Reference, image_seed: int, traj: Sequence[torch.Tensor], latents,
          image: np.ndarray, input_image: Optional[np.ndarray] = None) -> Dict[str, float]:
    """The numbers compared for one image of the program (or of a control in
    its place)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        x0, sigmas, tp = ref.start(image_seed, input_image)
        n = len(sigmas) - 1
        if len(traj) != n:
            return {"step_err": float("inf"), "decode_rms": float("inf")}
        errs: List[float] = []
        out: Dict[str, float] = {}
        old = None
        for i in range(n):
            x_in = x0 if i == 0 else traj[i - 1].to(ref.device, torch.float32)
            x_ref, old = ref.step(x_in, i, sigmas, tp, old)
            got = traj[i].to(ref.device, torch.float32)
            if i == 0 and ref.wl["entry"] == "img2img":
                out["start_err"] = _norm(got - x_ref) / max(_norm(x_ref), 1e-30)
                continue
            errs.append(_norm(got - x_ref) / max(_norm(x_ref - x_in), 1e-30))
        out["step_err"] = max(errs) if errs else 0.0
        img_ref = ref.decode(latents)[0]
        img = np.asarray(image)
        if img.shape != img_ref.shape:
            out["decode_rms"] = float("inf")
            return out
        diff = img.astype(np.float64) - img_ref.astype(np.float64)
        out["decode_rms"] = float(np.sqrt(np.mean(diff * diff)))
        out["decode_max"] = float(np.abs(diff).max())
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def verdict(numbers: Dict[str, float], limits: Dict[str, Optional[float]]) -> bool:
    """Every limited number within its limit (a missing or non-finite number
    fails)."""
    ok = True
    for name, limit in limits.items():
        if limit is None:
            continue
        v = numbers.get(name)
        if v is None or not math.isfinite(v) or v > limit:
            ok = False
    return ok
