"""txt2img and img2img upscaling with MultiDiffusion or Mixture of Diffusers,
regional prompt control and tiled noise inversion, DemoFusion's progressive
upscaling, any of the 15 samplers, DeepCache, SD1.5, SD2.1-unCLIP or SDXL
with an optional ControlNet and StableSR guidance, edit-model image CFG,
over the exact or fast tiled VAE (counterpart of the txt2img, img2img and
DemoFusion paths of ``mdu_tpu/pipeline.py``).

  plan    = plan_tiled_diffusion(...)                    static geometry, regions
  den_fn  = make_tiled_denoiser(plan, tile_denoise,      CFG'd per-tile and
                                region_denoise)          per-region denoiser
  latent  = sampler(den_fn, noise * sigma_0, sigmas)     Python loop
  image   = tiled_vae_decode(...) or                     lockstep or fast, or
            streaming_tiled_vae(...)                     streamed where the exact
                                                         lockstep does not fit

Conds come as ``TextConditioner.cond`` makes them (``text/``): plain dicts,
banks of scheduled or alternating prompts resolved every step, AND conds
(composable diffusion: every branch and the uncond in one batch), or
callables of the step. Regions may have UNet weights of their own
(``region_unet_params``: a ``state_dict`` each, e.g. with a LoRA merged,
run through ``torch.func.functional_call``).

img2img encodes the (pre-upscaled) image with the tiled VAE encoder, samples
the truncated schedule from it and, with noise inversion, starts from noise
found by running the sampler backwards over the image's latent. Under
``image_cfg_scale`` (an instruct-pix2pix UNet) the image's latent mode rides
as the ``concat`` leaf of cond and uncond, and guidance is three-way.

DeepCache (``SamplerConfig.deepcache`` N > 1): every N-th step runs the full
UNet and keeps its deep feature, one cache a tile batch (and one for an
untiled call); the steps between run only the shallow levels from it.
Regions, noise inversion and DemoFusion's local windows run the full model.

Seeds: the starting noise of txt2img image i comes from a ``torch.Generator``
seeded with ``seed + i`` on the pipeline's device; a region's seed of -1
resolves from a CPU generator seeded with ``derived_seed(seed, 1000 + i)``,
and the noise of the stochastic samplers comes from a generator seeded with
``derived_seed(seed, 7)`` (the JAX package folds 1000 + i and 7 into the
seed's key for the same draws). DemoFusion's phase ``s`` draws its noise
from a generator seeded with ``derived_seed(seed, 100 + s)``.

Step callbacks: ``txt2img`` and ``img2img`` take ``step_callback(i, x)``,
which every sampler calls after each step (``samplers/samplers.py``).
Interruption: setting ``pipe.interrupted`` (from a callback, a signal
handler or another thread) makes every denoiser return ``x`` unchanged and
run no UNet from the next call on (a DeepCache denoiser keeps its caches as
they are), so the run ends with the partial latent, which is decoded as
usual; DemoFusion also stops between phases. Callers clear the flag before
they reuse the pipeline (``mdu_tpu/pipeline.py:595-628``).

The pipeline runs on the card unless the caller passes ``device="cpu"``.

A tile mesh (``parallel.make_tile_mesh``, ``mesh=``) shards the background
grid's tiles over its devices (``tiling/schedulers.py::make_sharded_grid``,
through the flat-denoiser contract of ``mdu_tpu/pipeline.py:489-533``: the
conds stacked per tile, CFG, AND and scheduled conds included), DeepCache's
caches riding their shard, noise inversion's grid too, and runs the exact
tiled decode and encode sharded (``parallel/sharded.py``), each GroupNorm's
statistics pooled over the shards. Regions run unsharded after the grid.
DemoFusion shards its windows and dilated views the same way
(``tiling/demofusion.py``); its base phase runs untiled on the pipeline's
device.
The UNet, ControlNet, guidance model and VAE are copied to each mesh device
other than the pipeline's own (``_on``); two shards on one device share its
modules.
"""
from __future__ import annotations

import copy
import dataclasses
import hashlib
import os
import sys
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import DemoFusionConfig, SamplerConfig, TiledDiffusionConfig, TiledVAEConfig
from .device import resolve_device
from .models.stablesr import combine_residuals
from .models.unet import UNet2DCondition
from .models.vae import AutoencoderKL, sample_from_moments
from .ops.resize import resize_nchw
from .parallel.mesh import canonical_device
from .parallel.sharded import sharded_tiled_vae_decode, sharded_tiled_vae_encode_moments
from .samplers.denoiser import (cfg_combine, denoised_from_model, denoised_from_model_cached,
                                mark_deepcache, scalings)
from .samplers.samplers import (CHURN_SAMPLERS, STOCHASTIC_SAMPLERS, NoiseFn, base_name,
                                 generator_noise, get_sampler)
from .samplers.schedule import NoiseSchedule
from .tiling.conds import (Cond, concat_conds, dequantize_hint, fit_cond_canvases, is_and,
                           map_leaves, quantize_control_hints, tile_cond, tile_cond_stacked)
from .tiling.demofusion import demofusion_generate
from .tiling.regions import compose_region_noise, resolve_seed
from .tiling.schedulers import (DiffusionTilePlan, make_sharded_grid, make_tiled_denoiser,
                                plan_tiled_diffusion, shard_walk)
from .tiling.streaming_vae import DEFAULT_BUDGET, exact_vae_mode, streaming_tiled_vae
from .tiling.tiled_vae import tiled_vae_decode, tiled_vae_encode_moments
from .upscale import get_upscaler
from .utils.grid import splitable
from .utils.guided_filter import get_retouch_mask
from .utils.image import cheap_latent_preview, grayscale_u8, image_to_tensor, tensor_to_image

# the cond leaves the pipeline consumes
_COND_KEYS = {"crossattn", "concat", "vector", "control", "time_ids", "guidance", "adm"}
# tags of the derived seeds (see the module's docstring)
SAMPLER_SEED_TAG = 7
REGION_SEED_TAG = 1000
DEMOFUSION_SEED_TAG = 100


def derived_seed(seed: int, tag: int) -> int:
    """The seed of the draws tagged ``tag``: numpy's ``SeedSequence`` of
    (seed, tag), which mixes every bit into the result (a CPU generator
    keeps only the low 32 bits of its seed, so an offset in the high bits
    would repeat the seed's own draws)."""
    return int(np.random.SeedSequence([seed % 2**64, tag]).generate_state(1, np.uint64)[0])


@dataclass
class NoiseInverseCache:
    """One cached (x0, xt) latent pair of noise inversion (ref
    abstractdiffusion.py:627-646), keyed as the JAX package keys it: prompt
    content (``cond_fingerprint``), the UNet's weights (``weights_key``: the
    storage and version of every parameter, which loading new weights
    changes, in place of the JAX package's ``params is``), steps, retouch,
    and the closeness of x0."""

    x0: torch.Tensor
    xt: torch.Tensor
    steps: int
    retouch: float
    prompt_key: str
    weights: Tuple

    def matches(self, x0, steps: int, retouch: float, prompt_key: str,
                weights: Tuple) -> bool:
        return (self.steps == steps
                and abs(self.retouch - retouch) < 0.01
                and self.prompt_key == prompt_key
                and self.weights == weights
                and tuple(self.x0.shape) == tuple(x0.shape)
                and float((self.x0.float() - x0.float()).abs().sum()) < 100)   # ref :635


def _leaves(tree) -> list:
    """A cond's leaves in ``jax.tree.leaves`` order: dict keys sorted, into
    the lists of hints."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for part in tree for leaf in _leaves(part)]
    return [] if tree is None else [tree]


def cond_fingerprint(cond: Optional[Cond]) -> str:
    """sha1 over every leaf's shape and bytes, leaves in
    ``mdu_tpu/pipeline.py:98-108``'s order (a bf16 leaf's bytes are read as
    int16)."""
    h = hashlib.sha1()
    for leaf in _leaves(cond):
        leaf = torch.as_tensor(leaf).detach().to("cpu").contiguous()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.view(torch.int16)
        h.update(str(tuple(leaf.shape)).encode())
        h.update(leaf.numpy().tobytes())
    return h.hexdigest()


def weights_key(module: torch.nn.Module) -> Tuple:
    """Identity of a module's weights: each parameter's storage and version
    (``load_state_dict`` copies in place, which moves the version)."""
    return tuple((p.data_ptr(), p._version) for p in module.parameters())


@dataclass
class GenerationResult:
    # uint8 [B, H, W, 3]; DemoFusion with keep_intermediate gives a list of
    # them, one a phase
    images: Any
    latents: torch.Tensor
    seed: int
    info: Dict[str, Any]
    # DemoFusion: every phase's latent, the first included
    phase_latents: Optional[List[torch.Tensor]] = None


def _is_plain(c) -> bool:
    """A cond dict of leaves: no callable, bank or AND cond."""
    return not callable(c) and not is_and(c) and "__bank__" not in (c or {})


class DiffusionPipeline:
    """Stable Diffusion over explicit cond dicts (``tiling/conds.py``:
    ``{"crossattn": [B, 77, D]}``, SDXL's ``vector`` and ``time_ids``, a
    ``control`` list of hints for the ``controlnet``, a latent-canvas
    ``guidance`` leaf for the StableSR ``guidance_model``
    (``models/stablesr.py``), an edit model's ``concat`` image latent and an
    unCLIP UNet's ``adm`` image embedding). ``unet``, ``vae``,
    ``controlnet`` and ``guidance_model`` hold their weights and are moved
    to the pipeline's device. ``mesh``: a ``TileMesh`` (``parallel/mesh.py``)
    whose devices are of the pipeline's device type; it may be set later
    (``pipe.mesh = ...``), as the CLI's ``--devices`` does."""

    def __init__(self, unet: UNet2DCondition, vae: AutoencoderKL,
                 schedule: Optional[NoiseSchedule] = None, device=None,
                 controlnet=None, mesh=None, guidance_model=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        # the modules' copies on the mesh's other devices, by (name, device)
        self._replicas: Dict[Tuple[str, torch.device], Tuple[Tuple, torch.nn.Module]] = {}
        self.unet = unet.to(self.device).eval()
        if getattr(unet, "layout", "NCHW") == "NHWC":
            # the channels-last UNet's conv weights in the same memory format,
            # so that cuDNN converts none of them at every call
            self.unet.to(memory_format=torch.channels_last)
        self.vae = vae.to(self.device).eval()
        self.controlnet = controlnet.to(self.device).eval() if controlnet is not None else None
        self.guidance_model = (guidance_model.to(self.device).eval()
                               if guidance_model is not None else None)
        self.schedule = schedule or NoiseSchedule()
        self.noise_inverse_cache: Optional[NoiseInverseCache] = None
        # which step of the decode's NaN chain gave the last image: "decode",
        # "estimated stats" or "latent preview"
        self.last_decode: Optional[str] = None
        # the tiled VAE's mode in the last encode or decode: "untiled", "fast",
        # "lockstep", "sharded" (the lockstep over the mesh), "stream-device"
        # or "stream-host"
        self.last_vae_mode: Optional[str] = None
        # cooperative interruption (ref state.interrupted checks): read by every
        # denoiser call and by DemoFusion between phases
        self.interrupted = False

    @property
    def mesh(self):
        return self._mesh

    @mesh.setter
    def mesh(self, mesh):
        """The mesh guard (``mdu_tpu/pipeline.py:158-161``): a mesh needs a
        ``tiles`` axis, and its devices must be of the pipeline's type."""
        if mesh is not None:
            if "tiles" not in getattr(mesh, "shape", {}):
                raise ValueError("pipeline mesh needs a 'tiles' axis (parallel.make_tile_mesh)")
            if any(d.type != self.device.type for d in mesh.devices):
                raise ValueError(f"a mesh over {list(mesh.devices)} for a pipeline on "
                                 f"{self.device}")
        self._mesh = mesh

    def _on(self, name: str, device: Optional[torch.device]):
        """The module ``name`` (``unet``, ``vae``, ``controlnet`` or
        ``guidance_model``) on ``device``: itself on the pipeline's device, else a
        copy made on first use and made again when the module or its weights
        change (``weights_key``); made outside inference mode, so that its
        weights stay ordinary tensors (``Conv2D._packed_weight`` reads their
        version)."""
        module = getattr(self, name)
        if module is None or device is None:
            return module
        device = canonical_device(device)
        if device == canonical_device(self.device):
            return module
        key = (id(module), weights_key(module))
        held = self._replicas.get((name, device))
        if held is None or held[0] != key:
            with torch.inference_mode(False):
                held = (key, copy.deepcopy(module).to(device))
            self._replicas[name, device] = held
        return held[1]

    # ------------------------------------------------------------ denoisers

    def _cond(self, c: Optional[Cond]) -> Optional[Cond]:
        """A plain cond on the device, each leaf checked."""
        if c is None:
            return None
        for key in c:
            if key not in _COND_KEYS:
                raise ValueError(f"unknown cond leaf {key!r}; a cond has {sorted(_COND_KEYS)}")
        return map_leaves(lambda v: torch.as_tensor(v, device=self.device), c)

    def _prepare(self, c, fn):
        """``fn`` over every plain cond inside ``c``: a callable's results (each
        step), an AND cond's branches, a bank's entries and its other leaves
        (``TextConditioner.cond``'s forms, ``mdu_tpu/pipeline.py:248-270``)."""
        if c is None:
            return None
        if callable(c):
            return lambda step: self._prepare(c(step), fn)
        if is_and(c):
            return {"__and__": [self._prepare(p, fn) for p in c["__and__"]],
                    "__weights__": tuple(float(w) for w in c["__weights__"])}
        if "__bank__" in c:
            extra = {k: v for k, v in c.items() if k not in ("__bank__", "__index__")}
            return {"__bank__": fn(c["__bank__"]), **(fn(extra) if extra else {}),
                    "__index__": [int(i) for i in np.asarray(c["__index__"]).reshape(-1)]}
        return fn(c)

    @staticmethod
    def _as_cond_fn(c):
        """``cond(step)`` of a prepared cond: a callable as it is, an AND cond
        branch by branch, a bank's entry ``bank[index[step]]`` (the step
        clipped to the index), anything else the same every step."""
        if c is None:
            return None
        if callable(c):
            return c
        if is_and(c):
            fns = [DiffusionPipeline._as_cond_fn(p) for p in c["__and__"]]
            weights = c["__weights__"]
            return lambda step: {"__and__": [f(step) for f in fns], "__weights__": weights}
        if "__bank__" in c:
            bank, idx = c["__bank__"], c["__index__"]
            extra = {k: v for k, v in c.items() if k not in ("__bank__", "__index__")}

            def cond_fn(step):
                v = idx[min(max(int(step), 0), len(idx) - 1)]
                return {**map_leaves(lambda b: b[v:v + 1], bank), **extra}

            return cond_fn
        return lambda step: c

    def _model_fn(self, params: Optional[Dict[str, torch.Tensor]] = None,
                  device: Optional[torch.device] = None):
        """``fn(x, t, cond, cache=None, cache_mode=None, cache_branch=1)``: the
        UNet with SDXL's added cond (``vector``, and ``time_ids``, ones of [B,
        6] by default), an unCLIP UNet's ``adm``, the ControlNet's residuals
        from the first hint, dequantised, plus the StableSR guidance model's
        from the ``guidance`` leaf (``mdu_tpu/pipeline.py:175-237``), and the
        DeepCache arguments passed on to the UNet. ``params``: weights that
        replace the UNet's own for this function
        (``torch.func.functional_call``). ``device``: the modules' copies on
        that mesh device (``_on``)."""
        controlnet, guidance = self._on("controlnet", device), self._on("guidance_model", device)
        own_unet = self._on("unet", device)
        cfg = own_unet.cfg
        is_xl = cfg.addition_embed_type == "text_time"

        def unet(*args, **kwargs):
            if params is None:
                return own_unet(*args, **kwargs)
            return torch.func.functional_call(own_unet, params, args, kwargs)

        def fn(x, t, cond: Cond, cache=None, cache_mode=None, cache_branch=1):
            xin = x
            cc = cond.get("concat")
            if cc is not None and cc.shape[-2:] == x.shape[-2:] and cc.shape[1] > 0:
                xin = torch.cat([x, cc.to(x.dtype)], dim=1)
            added = None
            if is_xl:
                tids = cond.get("time_ids")
                if tids is None:
                    tids = torch.ones((x.shape[0], cfg.num_time_ids), device=x.device)
                added = {"text_embeds": cond.get("vector"), "time_ids": tids}
            if cfg.adm_in_channels is not None:
                # unCLIP's image embedding, repeated per tile as a vector leaf
                if cond.get("adm") is None:
                    raise ValueError("an unCLIP UNet needs cond['adm'] (the CLIP image "
                                     "embedding)")
                added = {**(added or {}), "adm": cond["adm"]}
            residuals = None
            hints = cond.get("control")
            if controlnet is not None and hints:
                residuals = controlnet(xin, t, cond["crossattn"],
                                       dequantize_hint(hints[0], x.dtype), added)
            g = cond.get("guidance")
            if guidance is not None and g is not None:
                if g.shape[0] != x.shape[0] and x.shape[0] % g.shape[0] == 0:
                    g = g.repeat_interleave(x.shape[0] // g.shape[0], dim=0)
                residuals = combine_residuals(residuals, guidance(g.to(x.dtype), t))
            return unet(xin, t, cond["crossattn"], added, residuals=residuals, cache=cache,
                        cache_mode=cache_mode, cache_branch=cache_branch)

        return fn

    def _fit_cond(self, c, h: int, w: int):
        """The cond on the device with its hints fitted to the (h, w) latent
        canvas and large ones stored as uint8 (``mdu_tpu/pipeline.py:683-685``)."""
        return self._prepare(c, lambda p: quantize_control_hints(
            fit_cond_canvases(self._cond(p), (h, w))))

    def _region_conds(self, region_conds: Sequence) -> list:
        def prep(p):
            return quantize_control_hints(self._cond(p))

        return [(self._prepare(c, prep), self._prepare(u, prep)) for c, u in region_conds]

    def _region_params(self, region_unet_params) -> list:
        """Per-region UNet weights (a ``state_dict`` each, e.g. the UNet's with
        a region's LoRA merged, ``models/lora.py``; None: the UNet's own) on
        the device in the UNet's dtypes."""
        own = self.unet.state_dict()
        out = []
        for params in region_unet_params or ():
            if params is None:
                out.append(None)
                continue
            unknown = set(params) - set(own)
            if unknown:
                raise KeyError(f"region UNet weights name {len(unknown)} entries the UNet "
                               f"does not have, first: {sorted(unknown)[:3]}")
            out.append({k: torch.as_tensor(v).to(self.device, own[k].dtype)
                        for k, v in params.items()})
        return out

    def _make_guided(self, cfg_scale: float, deepcache_branch: int = 1,
                     image_cfg_scale: Optional[float] = None,
                     device: Optional[torch.device] = None):
        """``(guided, guided_cached)``: ``guided(x, sigma, c, u, den=None)`` is
        the CFG'd denoiser, [uncond, cond] batched into one model call; an AND
        cond batches every branch and the uncond, den_u + cfg * sum_i w_i
        (den_i - den_u); under ``image_cfg_scale`` (an edit model) the batch
        is [uncond with its ``concat`` zeroed, uncond, cond] and den = du +
        image_cfg (di - du) + cfg (dc - di) (``mdu_tpu/pipeline.py:
        299-416``). ``den`` replaces the pipeline's denoiser (a region's own
        weights). ``guided_cached(x, sigma, c, u, cache, is_cached) ->
        (denoised, cache)`` is the same over the DeepCache denoiser. ``device``:
        over the modules' copies on that mesh device."""
        model_fn = self._model_fn(device=device)
        den_default = denoised_from_model(model_fn, self.schedule)
        den_cached = denoised_from_model_cached(model_fn, self.schedule, deepcache_branch)

        def _align(c, B):
            if c is None:
                return None
            if is_and(c):
                return {"__and__": [_align(p, B) for p in c["__and__"]],
                        "__weights__": c["__weights__"]}

            def rep(leaf):
                n = leaf.shape[0] if leaf.dim() >= 1 else 0
                return (leaf.repeat_interleave(B // n, dim=0)
                        if n not in (0, B) and B % n == 0 else leaf)

            return map_leaves(rep, c)

        def _edit_uncond(x, u):
            """The du leg's cond: the uncond with its image latent zeroed."""
            cc = u.get("concat") if isinstance(u, dict) else None
            if not (cc is not None and cc.dim() == 4 and cc.shape[1] > 0
                    and cc.shape[-2:] == x.shape[-2:]):
                raise ValueError("image_cfg_scale requires an edit-model image conditioning: "
                                 "a latent-shaped 'concat' leaf on the uncond (ref "
                                 "abstractdiffusion.py:278-310)")
            return {**u, "concat": torch.zeros_like(cc)}

        def guide(x, sigma, c, u, call):
            """The guidance over ``call(xs, sigmas, cond)``, the denoiser of a
            stacked batch."""
            B = x.shape[0]
            c, u = _align(c, B), _align(u, B)
            s = torch.atleast_1d(sigma).expand(B)
            if image_cfg_scale is not None:
                if is_and(c):
                    raise ValueError("image_cfg_scale cannot be combined with AND prompt "
                                     "composition")
                if u is None:
                    raise ValueError("image_cfg_scale needs an uncond")
                d = call(torch.cat([x] * 3), torch.cat([s] * 3),
                         concat_conds(concat_conds(_edit_uncond(x, u), u), c))
                du, di, dc = d.chunk(3)
                return du + image_cfg_scale * (di - du) + cfg_scale * (dc - di)
            if is_and(c):
                parts, weights = c["__and__"], c["__weights__"]
                P = len(parts)
                cc = parts[0]
                for extra in parts[1:]:
                    cc = concat_conds(cc, extra)
                cc = concat_conds(cc, u if u is not None else parts[0])
                dens = call(torch.cat([x] * (P + 1)), torch.cat([s] * (P + 1)), cc).chunk(P + 1)
                du = dens[-1] if u is not None else torch.zeros_like(dens[0])
                out = du
                for dc, wt in zip(dens[:P], weights):
                    out = out + cfg_scale * wt * (dc - du)
                return out
            if u is None or cfg_scale == 1.0:
                return call(x, s, c)
            du, dc = call(torch.cat([x, x]), torch.cat([s, s]), concat_conds(u, c)).chunk(2)
            return cfg_combine(du, dc, cfg_scale)

        def guided(x, sigma, c, u, den=None):
            return guide(x, sigma, c, u, den or den_default)

        def guided_cached(x, sigma, c, u, cache, is_cached: bool):
            held = [cache]

            def call(xs, ss, cc):
                d, held[0] = den_cached(xs, ss, cc, held[0], is_cached)
                return d

            return guide(x, sigma, c, u, call), held[0]

        return guided, guided_cached

    def _make_denoised_fn(self, plan: Optional[DiffusionTilePlan], cond, uncond,
                          sp: SamplerConfig, latent_shape: Sequence[int],
                          region_conds: Sequence = (), region_params: Sequence = ()):
        """The CFG'd denoiser of ``sp`` over the plan's tiles and regions, for
        latents of ``latent_shape``; region i is guided with its own ``(cond,
        uncond)``, cut to its bbox (ref multidiffusion.py:170-187), and with
        its own UNet weights where ``region_params[i]`` gives them (ref
        multidiffusion.py:180-182). The conds are prepared ones
        (``_prepare``), resolved every step. Under DeepCache the denoiser
        keeps one cache a tile batch (``_deepcache_aux``) and takes the
        cached pass on the steps that ``deepcache`` does not divide; the
        regions run the full model. On a mesh the grid goes through the
        flat-denoiser contract (``mdu_tpu/pipeline.py:489-533``): the conds
        of every tile stacked (``tile_cond_stacked``), an AND cond's weights
        put back on each chunk's cond, one cache a chunk on its shard's
        device."""
        guided, guided_cached = self._make_guided(sp.cfg_scale, sp.deepcache_branch,
                                                  sp.image_cfg_scale)
        guides = {canonical_device(self.device): (guided, guided_cached)}
        cond_f, uncond_f = self._as_cond_fn(cond), self._as_cond_fn(uncond)
        every = sp.deepcache
        caches = None
        if every > 1:
            B, _, h, w = latent_shape
            caches = self._deepcache_aux(plan, cond, uncond, sp.cfg_scale, sp.deepcache_branch,
                                         B, (h, w), sp.image_cfg_scale)

        def u_at(step):
            return uncond_f(step) if uncond_f is not None else None

        def run(x, sigma, c, u, slot, step):
            """``guided``, or ``guided_cached`` on cache ``slot``, over the
            modules on ``x``'s device."""
            dev = canonical_device(x.device)
            if dev not in guides:
                guides[dev] = self._make_guided(sp.cfg_scale, sp.deepcache_branch,
                                                sp.image_cfg_scale, dev)
            g, g_cached = guides[dev]
            if caches is None:
                return g(x, sigma, c, u)
            out, caches[slot] = g_cached(x, sigma, c, u, caches[slot], step % every != 0)
            return out

        if plan is None:
            fn = lambda x, sigma, step: run(x, sigma, cond_f(step), u_at(step), 0, step)  # noqa: E731
            return self._interruptible(fn if caches is None else mark_deepcache(fn))
        hw = (plan.h, plan.w)
        if len(region_conds) < len(plan.regions):
            raise ValueError(f"{len(plan.regions)} regions need as many (cond, uncond) "
                             f"pairs in region_conds, got {len(region_conds)}")
        region_fs = [(self._as_cond_fn(rc), self._as_cond_fn(ru)) for rc, ru in region_conds]
        region_dens = [denoised_from_model(self._model_fn(p), self.schedule)
                       if p is not None else None for p in region_params]
        region_dens += [None] * (len(region_fs) - len(region_dens))

        def tile_denoise(flat, sigma, step, bboxes, batch_i):
            return run(flat, sigma, tile_cond(cond_f(step), bboxes, hw),
                       tile_cond(u_at(step), bboxes, hw), batch_i, step)

        def region_denoise(xr, sigma, step, i):
            rcf, ruf = region_fs[i]
            box = [plan.regions[i]]
            u = tile_cond(ruf(step), box, hw) if ruf is not None else None
            return guided(xr, sigma, tile_cond(rcf(step), box, hw), u, region_dens[i])

        and_weights = {}

        def conds_fn(step):
            """Every tile's conds, stacked; an AND cond's weights aside."""
            stacked = {}
            for key, c in (("c", cond_f(step)), ("u", u_at(step))):
                and_weights[key] = c["__weights__"] if is_and(c) else None
                if c is not None:
                    stacked[key] = tile_cond_stacked(c, plan.bboxes, hw)
            return stacked

        def sharded_td(flat, sigma, step, conds, chunk):
            c, u = conds["c"], conds.get("u")
            if and_weights["c"] is not None:
                c = {**c, "__weights__": and_weights["c"]}
            if u is not None and and_weights["u"] is not None:
                u = {**u, "__weights__": and_weights["u"]}
            return run(flat, sigma, c, u, chunk, step)

        grid = (make_sharded_grid(plan, self.mesh, sharded_td, conds_fn, caches is not None)
                if self.mesh is not None else None)
        fn = make_tiled_denoiser(plan, tile_denoise, region_denoise,
                                 stateful=caches is not None, sharded_grid=grid)
        return self._interruptible(fn if caches is None else mark_deepcache(fn))

    def _interruptible(self, fn):
        """``fn`` that returns ``x`` unchanged, running nothing, once
        ``self.interrupted`` is set (``mdu_tpu/pipeline.py:595-628``); a
        DeepCache denoiser stays marked and keeps its caches as they are."""

        def wrapped(x, sigma, step):
            if self.interrupted:
                return x
            return fn(x, sigma, step)

        return mark_deepcache(wrapped) if getattr(fn, "deepcache", False) else wrapped

    def _deepcache_aux(self, plan: Optional[DiffusionTilePlan], cond, uncond,
                       cfg_scale: float, branch: int, B: int, hw: Tuple[int, int],
                       image_cfg_scale: Optional[float] = None) -> List[torch.Tensor]:
        """The DeepCache caches, zeros in the UNet's dtype: one for an
        untiled call, else one a tile batch (none without the background
        grid), each [mult * Kp * B, C_b, h / 2^(b-1), w / 2^(b-1)]; ``mult``
        is the guidance batch (3 under image CFG, P + 1 under an AND of P,
        2 under CFG, else 1), ``Kp`` the batch's tiles (``tile_bs`` when
        batches are uniform), ``C_b`` the UNet's width entering the branch
        (``mdu_tpu/pipeline.py:535-593``, the unrolled grid). On a mesh, one
        a chunk of the sharded grid, shard by shard, each with ``tile_bs``
        tiles on its shard's device (``:567-578``). Step 0 always runs the
        full model, so the zeros are never read."""
        bc = self.unet.cfg.block_out_channels
        if not 1 <= branch <= len(bc) - 1:
            raise ValueError(f"cache_branch must be in [1, {len(bc) - 1}]")
        if image_cfg_scale is not None:
            mult = 3
        elif is_and(cond):
            mult = len(cond["__and__"]) + 1
        else:
            mult = 1 if (uncond is None or cfg_scale == 1.0) else 2
        down = 2 ** (branch - 1)

        def zeros(n, hh, ww, device=self.device):
            if hh % down or ww % down:
                raise ValueError(f"deepcache_branch={branch} needs tile dims divisible by "
                                 f"{down}, got {hh}x{ww}")
            return torch.zeros((n, bc[branch], hh // down, ww // down),
                               dtype=self.unet.dtype, device=device)

        if plan is None:
            return [zeros(mult * B, *hw)]
        if not plan.draw_background:
            return []
        if self.mesh is not None and plan.bboxes:
            return [zeros(mult * plan.tile_bs * B, plan.tile_h, plan.tile_w, dev)
                    for dev, *_ in shard_walk(len(plan.bboxes), self.mesh.devices,
                                              plan.tile_bs)]
        return [zeros(mult * (plan.tile_bs if plan.uniform_batches else len(bb)) * B,
                      plan.tile_h, plan.tile_w) for bb in plan.batched]

    def _plan(self, td: Optional[TiledDiffusionConfig], h: int, w: int):
        if td is None or not td.enabled:
            return None
        if not (splitable(w, h, td.tile_w, td.tile_h, td.overlap) or td.regions
                or td.noise_inverse):
            return None
        return plan_tiled_diffusion(td.method, h, w, tile_h=td.tile_h,
                                    tile_w=td.tile_w, overlap=td.overlap,
                                    tile_bs=td.tile_bs,
                                    uniform_batches=td.deterministic,
                                    regions=td.regions, draw_background=td.draw_background,
                                    tile_scan=td.tile_scan)

    @staticmethod
    def _region_seeds(plan: Optional[DiffusionTilePlan], seed: int) -> Optional[list]:
        """The regions' seeds, -1 resolved from a CPU generator of its own for
        each region (so that the card and the CPU resolve the same seeds)."""
        if plan is None or not plan.regions:
            return None
        return [resolve_seed(r.seed, torch.Generator().manual_seed(
            derived_seed(seed, REGION_SEED_TAG + i))) for i, r in enumerate(plan.regions)]

    @staticmethod
    def _resolve_sampler(sp: Optional[SamplerConfig]) -> SamplerConfig:
        """A1111's '<name> Karras' selects the Karras schedule."""
        sp = sp or SamplerConfig()
        if sp.name.endswith(" Karras") and sp.schedule == "automatic":
            sp = dataclasses.replace(sp, schedule="karras")
        return sp

    @staticmethod
    def _check_sampler(sp: SamplerConfig) -> None:
        get_sampler(sp.name)

    def _sampler_noise(self, noise, seed: int) -> NoiseFn:
        """The stochastic samplers' noise: ``noise(like)`` as given, drawn
        from a given generator, or by default from a generator of its own."""
        if noise is None:
            noise = torch.Generator(device=self.device).manual_seed(
                derived_seed(seed, SAMPLER_SEED_TAG))
        return generator_noise(noise) if isinstance(noise, torch.Generator) else noise

    @staticmethod
    def _sample(sp: SamplerConfig, den_fn, x, sigmas, noise: NoiseFn, step_callback=None):
        """Run the sampler as the JAX package dispatches it: churn for Euler,
        Heun and DPM2 when ``s_churn > 0``; the noise for the stochastic
        samplers; the others without noise; ``step_callback`` to every one.
        The sets are keyed on the name without " Karras" (the JAX package
        keys them on the full name, so that "Euler a Karras" misses its key
        there)."""
        base, fn = base_name(sp.name), get_sampler(sp.name)
        kw = {"step_callback": step_callback}
        if sp.s_churn > 0 and base in CHURN_SAMPLERS:
            return fn(den_fn, x, sigmas, noise, s_churn=sp.s_churn, s_tmin=sp.s_tmin,
                      s_tmax=sp.s_tmax, s_noise=sp.s_noise, **kw)
        if base in STOCHASTIC_SAMPLERS:
            return fn(den_fn, x, sigmas, noise, **kw)
        return fn(den_fn, x, sigmas, **kw)

    # --------------------------------------------------------------- txt2img

    def txt2img(self, cond: Cond, uncond: Optional[Cond], width: int = 512,
                height: int = 512, sampler: Optional[SamplerConfig] = None,
                seed: int = 0,
                tiled_diffusion: Optional[TiledDiffusionConfig] = None,
                tiled_vae: Optional[TiledVAEConfig] = None,
                region_conds: Sequence = (), region_unet_params=None,
                batch_size: int = 1, decode: bool = True,
                step_callback=None) -> GenerationResult:
        """Generate ``batch_size`` images; image i starts from the noise of a
        ``torch.Generator`` seeded with ``seed + i``, with each region's
        seeded patch pasted in. Region i of ``tiled_diffusion.regions`` is
        guided with ``region_conds[i]`` = ``(cond, uncond)`` and, where
        ``region_unet_params[i]`` is a ``state_dict``, with those UNet
        weights. ``step_callback(i, x)`` is called after every sampler step."""
        h, w = height // 8, width // 8
        C = self.unet.cfg.out_channels
        noise = []
        for i in range(batch_size):
            gen = torch.Generator(device=self.device).manual_seed(seed + i)
            noise.append(torch.randn((1, C, h, w), generator=gen, device=self.device))
        noise = torch.cat(noise)
        plan = self._plan(tiled_diffusion, h, w)
        region_seeds = self._region_seeds(plan, seed)
        if region_seeds is not None:
            noise = compose_region_noise(noise, plan.regions, region_seeds)
        return self._txt2img_from_noise(noise, cond, uncond, sampler, seed, tiled_diffusion,
                                        tiled_vae, decode, region_conds=region_conds,
                                        region_seeds=region_seeds, plan=plan,
                                        region_unet_params=region_unet_params,
                                        step_callback=step_callback)

    @torch.inference_mode()
    def _txt2img_from_noise(self, noise, cond: Cond, uncond: Optional[Cond],
                            sampler: Optional[SamplerConfig] = None, seed: int = 0,
                            tiled_diffusion: Optional[TiledDiffusionConfig] = None,
                            tiled_vae: Optional[TiledVAEConfig] = None,
                            decode: bool = True, region_conds: Sequence = (),
                            sampler_noise=None, region_seeds: Optional[Sequence[int]] = None,
                            plan: Optional[DiffusionTilePlan] = None,
                            region_unet_params=None, step_callback=None) -> GenerationResult:
        """txt2img from given unit-variance noise [B, 4, h, w], the regions'
        patches already in it (``region_seeds`` only names them in the
        info). ``sampler_noise``: a noise function or generator for the
        stochastic samplers (by default a generator seeded from ``seed``).
        ``plan``: the tile plan when the caller already made it. The conds
        may be plain, callables of the step, banks or AND conds
        (``text/conditioning.py``)."""
        sp = self._resolve_sampler(sampler)
        self._check_sampler(sp)
        noise = torch.as_tensor(noise, dtype=torch.float32, device=self.device)
        h, w = noise.shape[2], noise.shape[3]
        if plan is None:
            plan = self._plan(tiled_diffusion, h, w)
        den_fn = self._make_denoised_fn(plan, self._fit_cond(cond, h, w),
                                        self._fit_cond(uncond, h, w), sp, tuple(noise.shape),
                                        self._region_conds(region_conds),
                                        self._region_params(region_unet_params))
        sigmas = torch.as_tensor(self.schedule.sampling_sigmas(sp.steps, sp.schedule),
                                 device=self.device)
        latents = self._sample(sp, den_fn, noise * sigmas[0], sigmas,
                               self._sampler_noise(sampler_noise, seed), step_callback)
        images = self._decode(latents, tiled_vae) if decode else None
        return GenerationResult(images, latents, seed,
                                self._info(sp, tiled_diffusion, seed, region_seeds))

    # --------------------------------------------------------------- img2img

    def _prepare_image(self, image, td: Optional[TiledDiffusionConfig],
                       target_size: Optional[Tuple[int, int]]):
        """uint8 image (or [1, 3, H, W] tensor in [-1, 1]) -> the pre-upscaled,
        resized and cropped fp32 tensor on the device (``mdu_tpu/pipeline.py:
        807-823``)."""
        x = image_to_tensor(image) if isinstance(image, np.ndarray) else torch.as_tensor(image)
        x = x.to(self.device, torch.float32)
        if td is not None and td.upscaler and td.upscaler != "None":
            x = get_upscaler(td.upscaler)(x, td.scale_factor)
        if target_size is not None:
            th, tw = int(target_size[0]), int(target_size[1])
            if (x.shape[-2], x.shape[-1]) != (th, tw):
                x = resize_nchw(x, (th, tw), "lanczos")
        h, w = x.shape[-2] // 8, x.shape[-1] // 8
        return x[:, :, :h * 8, :w * 8]

    def img2img(self, image: Optional[np.ndarray], cond: Cond, uncond: Optional[Cond],
                sampler: Optional[SamplerConfig] = None, seed: int = 0,
                tiled_diffusion: Optional[TiledDiffusionConfig] = None,
                tiled_vae: Optional[TiledVAEConfig] = None,
                region_conds: Sequence = (), region_unet_params=None,
                inversion_cond: Optional[Cond] = None,
                mask: Optional[np.ndarray] = None, init_latents=None, decode: bool = True,
                step_callback=None,
                target_size: Optional[Tuple[int, int]] = None) -> GenerationResult:
        """img2img from a uint8 image (or from ``init_latents``). The encoder's
        sample and then the sampling noise are drawn from one
        ``torch.Generator`` seeded with ``seed``; the regions' patches are
        pasted into the sampling noise as in ``txt2img``; ``region_unet_params``
        as in ``txt2img``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return self._img2img_from_noise(
            image, gen, gen, cond, uncond, sampler, seed, tiled_diffusion, tiled_vae,
            region_conds, inversion_cond, mask, init_latents, decode, step_callback,
            target_size, region_unet_params=region_unet_params)

    def _attach_image_cond(self, icond, init_latent, cond, uncond):
        """An edit model's image conditioning: the image latent's mode
        ``icond`` (no scaling factor, no noise) as the ``concat`` leaf of cond
        and uncond, unless the caller set one (``mdu_tpu/pipeline.py:
        829-853``)."""
        if self.unet.cfg.in_channels < init_latent.shape[1] + icond.shape[1]:
            raise ValueError(
                "image_cfg_scale needs an edit-model (instruct-pix2pix) UNet that accepts "
                f"the image 'concat' channels: in_channels={self.unet.cfg.in_channels} < "
                f"{init_latent.shape[1]} latent + {icond.shape[1]} image channels")

        def attach(c):
            if isinstance(c, dict) and c.get("concat") is None and not is_and(c):
                return {**c, "concat": icond}
            return c

        return attach(cond), attach(uncond)

    @staticmethod
    def _noise(noise, shape, dtype, device):
        """``noise`` as given, or drawn from it when it is a generator."""
        if isinstance(noise, torch.Generator):
            return torch.randn(shape, generator=noise, dtype=dtype, device=device)
        noise = torch.as_tensor(noise, dtype=dtype, device=device)
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"noise of shape {tuple(noise.shape)}, expected {tuple(shape)}")
        return noise

    @torch.inference_mode()
    def _img2img_from_noise(self, image, enc_noise, noise, cond: Cond,
                            uncond: Optional[Cond], sampler: Optional[SamplerConfig] = None,
                            seed: int = 0,
                            tiled_diffusion: Optional[TiledDiffusionConfig] = None,
                            tiled_vae: Optional[TiledVAEConfig] = None,
                            region_conds: Sequence = (),
                            inversion_cond: Optional[Cond] = None,
                            mask: Optional[np.ndarray] = None, init_latents=None,
                            decode: bool = True, step_callback=None,
                            target_size: Optional[Tuple[int, int]] = None,
                            sampler_noise=None, region_unet_params=None) -> GenerationResult:
        """img2img with the encoder's unit-variance sample noise ``enc_noise``
        (the moments' dtype, [B, 4, h, w]) and the sampling noise ``noise``
        (fp32, [B, 4, h, w]), each a tensor or a ``torch.Generator`` to draw it
        from (``mdu_tpu/pipeline.py:767-970``). Drawn from a generator, the
        sampling noise gets the regions' patches; a given tensor is taken as
        it is. ``sampler_noise`` as in ``_txt2img_from_noise``."""
        sp = self._resolve_sampler(sampler)
        td = tiled_diffusion
        if td is not None and td.noise_inverse and sp.name != "Euler":
            # the reference forces Euler under noise inversion (ref
            # tilediffusion.py:431-435)
            print(f"[Tiled Diffusion] noise inversion: overriding sampler {sp.name!r} "
                  "-> 'Euler' (ref convention)", file=sys.stderr)
            sp = dataclasses.replace(sp, name="Euler")
        self._check_sampler(sp)

        if init_latents is not None:
            # latent-space entry; the renoise mask needs pixels
            if td is not None and td.noise_inverse:
                raise ValueError("noise_inverse requires an image input "
                                 "(the renoise mask is pixel-space)")
            init_latent = torch.as_tensor(init_latents, device=self.device)
            x_img = None
        else:
            x_img = self._prepare_image(image, td, target_size)
            moments = self._encode(x_img, tiled_vae)
            C = moments.shape[1] // 2
            init_latent = sample_from_moments(moments, self._noise(
                enc_noise, (moments.shape[0], C) + tuple(moments.shape[2:]),
                moments.dtype, self.device))
            init_latent = init_latent * self.vae.cfg.scaling_factor
            if sp.image_cfg_scale is not None:
                cond, uncond = self._attach_image_cond(moments[:, :C], init_latent, cond,
                                                       uncond)
        h, w = init_latent.shape[-2], init_latent.shape[-1]
        cond, uncond = self._fit_cond(cond, h, w), self._fit_cond(uncond, h, w)
        inversion_cond = self._cond(inversion_cond) if inversion_cond is not None else cond
        if td is not None and td.noise_inverse and not _is_plain(inversion_cond):
            raise ValueError("noise inversion runs a plain cond; pass inversion_cond when "
                             "the cond is scheduled, an AND cond or a callable")

        plan = self._plan(td, h, w)
        drawn = isinstance(noise, torch.Generator)
        noise = self._noise(noise, tuple(init_latent.shape), torch.float32, self.device)
        region_seeds = self._region_seeds(plan, seed) if drawn else None
        if region_seeds is not None:
            noise = compose_region_noise(noise, plan.regions, region_seeds)
        # the truncated schedule (A1111 setup_img2img_steps)
        steps, t_enc = self.schedule.img2img_steps(sp.steps, sp.denoising_strength)
        all_sigmas = torch.as_tensor(self.schedule.sampling_sigmas(steps, sp.schedule),
                                     device=self.device)
        sigmas = all_sigmas[steps - t_enc - 1:]
        if td is not None and td.noise_inverse:
            # sigma0 is the full schedule's sigma_max (ref abstractdiffusion.py:651)
            noise = self._noise_inverse_combined_noise(
                x_img, init_latent, noise, td, plan, inversion_cond=inversion_cond,
                sigma0=all_sigmas[0])

        x = init_latent + noise * sigmas[0]
        den_fn = self._make_denoised_fn(plan, cond, uncond, sp, tuple(x.shape),
                                        self._region_conds(region_conds),
                                        self._region_params(region_unet_params))
        if mask is not None:
            # masked redraw: the denoised estimate blends with the initial
            # latent each step (A1111 semantics)
            m = torch.as_tensor(np.asarray(mask), dtype=torch.float32, device=self.device)
            if m.dim() == 2:
                m = m[None, None]
            lm = resize_nchw(m, (h, w), "linear")
            inner = den_fn

            def den_fn(xx, ss, ii):  # noqa: F811
                return init_latent * (1 - lm) + inner(xx, ss, ii) * lm

            if getattr(inner, "deepcache", False):
                mark_deepcache(den_fn)

        latents = self._sample(sp, den_fn, x, sigmas, self._sampler_noise(sampler_noise, seed),
                               step_callback)
        images = self._decode(latents, tiled_vae) if decode else None
        info = self._info(sp, td, seed, region_seeds)
        if target_size is not None:
            info["Target size"] = [int(target_size[0]), int(target_size[1])]
        return GenerationResult(images, latents, seed, info)

    # ------------------------------------------------------------ DemoFusion

    def demofusion(self, cond: Cond, uncond: Optional[Cond], width: int, height: int,
                   cfg: Optional[DemoFusionConfig] = None,
                   sampler: Optional[SamplerConfig] = None, seed: int = 0,
                   init_latent=None, tiled_vae: Optional[TiledVAEConfig] = None,
                   decode: bool = True) -> GenerationResult:
        """Progressive xN upscaling (ref scripts/tileglobal.py; see
        ``tiling/demofusion.py``) from a ``width`` x ``height`` first phase.
        Phase 1's noise comes from a ``torch.Generator`` seeded with ``seed``,
        as txt2img's; phase ``s``'s from one seeded with
        ``derived_seed(seed, 100 + s)``."""
        cfg = cfg or DemoFusionConfig()
        C, h, w = self.unet.cfg.out_channels, height // 8, width // 8

        def draw(seed_s, scale):
            gen = torch.Generator(device=self.device).manual_seed(seed_s)
            return torch.randn((1, C, h * scale, w * scale), generator=gen, device=self.device)

        return self._demofusion_from_noise(
            draw(seed, 1), [draw(derived_seed(seed, DEMOFUSION_SEED_TAG + s), s)
                            for s in range(2, cfg.scale_factor + 1)],
            cond, uncond, width, height, cfg, sampler, seed, init_latent, tiled_vae, decode)

    @torch.inference_mode()
    def _demofusion_from_noise(self, base_noise, phase_noises: Sequence, cond: Cond,
                               uncond: Optional[Cond], width: int, height: int,
                               cfg: Optional[DemoFusionConfig] = None,
                               sampler: Optional[SamplerConfig] = None, seed: int = 0,
                               init_latent=None, tiled_vae: Optional[TiledVAEConfig] = None,
                               decode: bool = True, sampler_noise=None) -> GenerationResult:
        """DemoFusion from given unit noise: ``base_noise`` [1, 4, h, w] for
        phase 1 and ``phase_noises``, the later phases' noises in order.
        ``sampler_noise`` as in ``_txt2img_from_noise``, for every phase."""
        cfg = cfg or DemoFusionConfig()
        sp = sampler or SamplerConfig()
        self._check_sampler(self._resolve_sampler(sp))
        # hints to the base canvas; the phases resize them themselves
        h, w = height // 8, width // 8

        def fit(p):
            return fit_cond_canvases(self._cond(p), (h, w))

        cond, uncond = self._prepare(cond, fit), self._prepare(uncond, fit)
        return demofusion_generate(self, cond, uncond, width, height, base_noise, phase_noises,
                                   cfg, sp, seed, self._sampler_noise(sampler_noise, seed),
                                   init_latent, tiled_vae, decode)

    # ------------------------------------------------------- noise inversion

    def _noise_inverse_combined_noise(self, x_img, init_latent, noise,
                                      td: TiledDiffusionConfig,
                                      plan: Optional[DiffusionTilePlan],
                                      inversion_cond: Cond, sigma0):
        """Invert the initial latent to noise, then blend it with fresh noise
        through the guided-filter renoise mask (ref abstractdiffusion.py:604-679)."""
        prompt_key = cond_fingerprint(inversion_cond)
        wkey = weights_key(self.unet)
        cache = self.noise_inverse_cache
        if cache is not None and cache.matches(init_latent, td.noise_inverse_steps,
                                               td.noise_inverse_retouch, prompt_key, wkey):
            xt = cache.xt
        else:
            xt = self.noise_inversion(init_latent, inversion_cond, td.noise_inverse_steps,
                                      td.noise_inverse_retouch, plan)
            self.noise_inverse_cache = NoiseInverseCache(
                init_latent.clone(), xt.clone(), td.noise_inverse_steps,
                td.noise_inverse_retouch, prompt_key, wkey)
        inverse_noise = xt - init_latent / sigma0
        if td.noise_inverse_renoise_strength <= 0:
            return inverse_noise
        # the mask is built on the host from the image quantised to uint8
        gray = grayscale_u8(tensor_to_image(x_img)[0])
        detail = get_retouch_mask(gray, td.noise_inverse_renoise_kernel)
        m = 1.0 - resize_nchw(torch.as_tensor(detail, device=noise.device)[None, None],
                              tuple(noise.shape[-2:]), "linear")
        m = torch.clamp(m * td.noise_inverse_renoise_strength, 0.0, 1.0)
        return ((1 - m) * inverse_noise + m * noise) / torch.sqrt(m ** 2 + (1 - m) ** 2)

    @torch.inference_mode()
    def noise_inversion(self, init_latent, cond: Cond, steps: int, retouch: float = 1.0,
                        plan: Optional[DiffusionTilePlan] = None):
        """Tiled reverse Euler over the ``steps`` ascending sigmas with the
        positive cond only and no CFG, the regions included (ref
        abstractdiffusion.py:683-742, multidiffusion.py:220-243); the carry is
        fp32 and the result is divided by the largest sigma. On a mesh the
        grid is sharded, as the sampling's is."""
        cond = self._cond(cond)
        sch = self.schedule
        sig_asc = torch.as_tensor(sch.sampling_sigmas(steps)[:-1][::-1].copy(),
                                  device=self.device)
        prev = torch.cat([torch.zeros(1, device=self.device), sig_asc[:-1]])
        model_fn = self._model_fn()
        model_fns = {canonical_device(self.device): model_fn}

        def eps_org(x, sigma, step):
            return self._raw_eps(model_fn, x, sigma, cond, retouch)

        if plan is not None:
            def eps_tile(flat, sigma, step, bboxes, batch_i):
                c = tile_cond(cond, bboxes, (plan.h, plan.w))
                return self._raw_eps(model_fn, flat, sigma, c, retouch)

            def eps_region(xr, sigma, step, i):
                c = tile_cond(cond, [plan.regions[i]], (plan.h, plan.w))
                return self._raw_eps(model_fn, xr, sigma, c, retouch)

            def eps_sharded(flat, sigma, step, conds, chunk):
                dev = canonical_device(flat.device)
                if dev not in model_fns:
                    model_fns[dev] = self._model_fn(device=dev)
                return self._raw_eps(model_fns[dev], flat, sigma, conds, retouch)

            grid = None
            if self.mesh is not None:
                grid = make_sharded_grid(plan, self.mesh, eps_sharded, lambda step: (
                    tile_cond_stacked(cond, plan.bboxes, (plan.h, plan.w))))
            tiled_eps = make_tiled_denoiser(plan, eps_tile, eps_region, sharded_grid=grid)
        else:
            tiled_eps = eps_org
        x = torch.as_tensor(init_latent, device=self.device).float()
        for i in range(steps):
            s, s_prev = sig_asc[i], prev[i]
            _, c_out, c_in = scalings(s, sch.prediction_type)
            eps = tiled_eps(x * c_in, s, steps - 1 - i)
            denoised = x + eps * c_out        # ref :726, the eps form even for v
            x = x + (x - denoised) / s * (s - s_prev)
        return x / sig_asc[-1]

    def _raw_eps(self, model_fn, x, sigma, cond, retouch: float):
        t = self.schedule.t_for_sigma(torch.atleast_1d(sigma)) / retouch
        return model_fn(x, t.expand(x.shape[0]), cond)

    def free_cache(self):
        """Clear the noise-inversion cache (ref 'Free GPU' button,
        tilediffusion.py:591-593)."""
        self.noise_inverse_cache = None

    def reset(self, clear_compiled: bool = True) -> Dict[str, Optional[float]]:
        """Drop the caches, collect garbage and report the device memory (ref
        reset_and_gc, tilediffusion.py:579-609; ``mdu_tpu/pipeline.py:
        1327-1345``). The port compiles nothing per call, so
        ``clear_compiled`` has nothing to drop; it is accepted for the JAX
        package's signature. Returns {"device_in_use_mb", "device_peak_mb"}
        (None on the CPU)."""
        import gc

        from .utils.telemetry import device_memory_mb, device_peak_memory_mb

        self.free_cache()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        report = {"device_in_use_mb": device_memory_mb(self.device),
                  "device_peak_mb": device_peak_memory_mb(self.device)}
        print(f"[Tiled Diffusion] reset: device memory in use {report['device_in_use_mb']} "
              f"MB, peak {report['device_peak_mb']} MB", file=sys.stderr)
        return report

    # ------------------------------------------------------------------- VAE

    def _decode(self, latents, tv: Optional[TiledVAEConfig]) -> np.ndarray:
        """Decode with the reference's recovery chain (ref tilevae.py:500-503,
        570-573, 625): NaN in the decoded tensor -> the fast decoder with
        estimated GroupNorm statistics -> the cheap latent -> RGB
        approximation. ``last_decode`` names the step that gave the image."""
        out = self._decode_tensor(latents, tv)
        if bool(torch.isfinite(out).all()):
            self.last_decode = "decode"
            return tensor_to_image(out)
        print("[Tiled VAE] NaN in decoded image; retrying with estimated "
              "GroupNorm stats (ref tilevae.py:502)", file=sys.stderr)
        tv_fast = dataclasses.replace(tv or TiledVAEConfig(), enabled=True,
                                      fast_decoder=True, streaming=False)
        try:
            out = self._decode_tensor(latents, tv_fast)
        except Exception:                            # noqa: BLE001
            out = torch.full_like(out, float("nan"))
        if bool(torch.isfinite(out).all()):
            self.last_decode = "estimated stats"
            return tensor_to_image(out)
        print("[Tiled VAE] still NaN; returning cheap latent approximation "
              "(ref tilevae.py:570-573)", file=sys.stderr)
        latents = torch.as_tensor(latents, device=self.device)
        approx = cheap_latent_preview(latents.float() / self.vae.cfg.scaling_factor)
        approx = resize_nchw(approx, (latents.shape[-2] * 8, latents.shape[-1] * 8), "linear")
        self.last_decode = "latent preview"
        return tensor_to_image(torch.clamp(approx, -1.0, 1.0))

    def _exact_vae_mode(self, which: str, tile_size: int, h: int, w: int, B: int,
                        group: int) -> str:
        """'lockstep', 'stream-device' or 'stream-host' by the JAX package's
        rule (``tiling/streaming_vae.py::exact_vae_mode``). The budget is
        ``MDU_HBM_BYTES`` where that is set, else the card's free memory
        (``torch.cuda.mem_get_info``); on the CPU the JAX package's 10 GiB.
        On a mesh the lockstep is the sharded one: the tiles of the device
        that holds the most shards, against the least free memory of the
        mesh's devices."""
        devices = self.mesh.devices if self.mesh is not None else (self.device,)
        env = os.environ.get("MDU_HBM_BYTES")
        if env:
            budget = int(env)
        elif self.device.type == "cuda":
            budget = min(torch.cuda.mem_get_info(d)[0] for d in set(devices))
        else:
            budget = DEFAULT_BUDGET
        shards = (len(devices), max(devices.count(d) for d in devices))
        return exact_vae_mode(which, tile_size, h, w, B, group, budget, shards=shards)

    def _stream_vae(self, which: str, x, tv: TiledVAEConfig, host_resident: bool):
        """The streaming exact tiled VAE with ``tv``'s tile size, ``tile_batch``
        tiles a group and ``spill_dtype``; None when the input needs no
        tiling."""
        ts = tv.encoder_tile_size if which == "encoder" else tv.decoder_tile_size
        return streaming_tiled_vae(self.vae, x, which, ts, tv.tile_batch,
                                   host_resident=host_resident, spill_dtype=tv.spill_dtype)

    def _exact_stream(self, which: str, x, tv: TiledVAEConfig):
        """The streaming result where ``tv`` asks for streaming or the exact
        lockstep mode does not fit (``_exact_vae_mode``), else None.
        ``last_vae_mode`` names the mode that ran."""
        fast = tv.fast_encoder if which == "encoder" else tv.fast_decoder
        ts = tv.encoder_tile_size if which == "encoder" else tv.decoder_tile_size
        if tv.streaming:
            mode = "stream-host"
        elif fast:
            self.last_vae_mode = "fast"
            return None
        else:
            mode = self._exact_vae_mode(which, ts, x.shape[2], x.shape[3], x.shape[0],
                                        tv.tile_batch)
        self.last_vae_mode = mode
        if mode == "lockstep":
            return None
        if not tv.streaming:
            where = " on one device" if self.mesh is not None else ""
            print(f"[Tiled VAE] the exact lockstep {which} exceeds the memory budget; "
                  f"switching to {mode} exact mode{where}", file=sys.stderr)
        out = self._stream_vae(which, x, tv, host_resident=(mode == "stream-host"))
        if out is None:
            self.last_vae_mode = "untiled"
        return out

    def _vae_replicas(self) -> Dict[torch.device, AutoencoderKL]:
        return {d: self._on("vae", d) for d in self.mesh.devices}

    @torch.inference_mode()
    def _decode_tensor(self, latents, tv: Optional[TiledVAEConfig]):
        latents = torch.as_tensor(latents, device=self.device)
        z = latents / self.vae.cfg.scaling_factor
        if tv is None or not tv.enabled:
            self.last_vae_mode = "untiled"
            return self.vae.decode(z)
        out = self._exact_stream("decoder", z, tv)
        if out is not None:
            return out
        if self.mesh is not None and not tv.fast_decoder:
            self.last_vae_mode = "sharded"
            return sharded_tiled_vae_decode(self.mesh, self._vae_replicas(), z,
                                            tv.decoder_tile_size)
        return tiled_vae_decode(self.vae, z, tile_size=tv.decoder_tile_size,
                                fast=tv.fast_decoder, tile_batch=tv.tile_batch)

    @torch.inference_mode()
    def _encode(self, x_img, tv: Optional[TiledVAEConfig]):
        """[B, 3, H, W] in [-1, 1] -> [B, 8, H/8, W/8] moments."""
        x_img = torch.as_tensor(x_img, device=self.device)
        if tv is None or not tv.enabled:
            self.last_vae_mode = "untiled"
            return self.vae.encode_moments(x_img)
        out = self._exact_stream("encoder", x_img, tv)
        if out is not None:
            return out
        if self.mesh is not None and not tv.fast_encoder:
            self.last_vae_mode = "sharded"
            return sharded_tiled_vae_encode_moments(self.mesh, self._vae_replicas(), x_img,
                                                    tv.encoder_tile_size)
        return tiled_vae_encode_moments(self.vae, x_img, tile_size=tv.encoder_tile_size,
                                        fast=tv.fast_encoder, tile_batch=tv.tile_batch,
                                        color_fix=tv.color_fix)

    # ------------------------------------------------------------------ misc

    @staticmethod
    def _info(sp: SamplerConfig, td: Optional[TiledDiffusionConfig], seed: int,
              region_seeds: Optional[Sequence[int]] = None):
        """The image's settings (ref tilediffusion.py:321-342); each region's
        entry carries its resolved seed (ref :521)."""
        info: Dict[str, Any] = {"Sampler": sp.name, "Steps": sp.steps,
                                "CFG scale": sp.cfg_scale, "Seed": seed}
        if sp.image_cfg_scale is not None:
            info["Image CFG scale"] = sp.image_cfg_scale
        if td is not None and td.enabled:
            block = {"Method": td.method, "Tile tile width": td.tile_w,
                     "Tile tile height": td.tile_h, "Tile Overlap": td.overlap,
                     "Tile batch size": td.tile_bs}
            if td.upscaler and td.upscaler != "None":
                block["Upscaler"] = td.upscaler
                block["Upscale factor"] = td.scale_factor
            if td.noise_inverse:
                block.update({
                    "NoiseInv": True, "NoiseInv Steps": td.noise_inverse_steps,
                    "NoiseInv Retouch": td.noise_inverse_retouch,
                    "NoiseInv Renoise strength": td.noise_inverse_renoise_strength,
                    "NoiseInv Kernel size": td.noise_inverse_renoise_kernel})
            if td.regions:
                region_info = {}
                for i, r in enumerate(td.regions):
                    d = dataclasses.asdict(r)
                    if region_seeds is not None and i < len(region_seeds):
                        d["seed"] = int(region_seeds[i])
                    region_info[f"Region {i + 1}"] = d
                block["Region control"] = region_info
            info["Tiled Diffusion"] = block
        return info
