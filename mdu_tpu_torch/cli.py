"""Command-line interface of the port (counterpart of ``mdu_tpu/cli.py``,
with its subcommands, flags, defaults and infotext).

    python -m mdu_tpu_torch.cli txt2img --model-dir /ckpt --prompt "..." -W 2048 -H 512
    python -m mdu_tpu_torch.cli img2img --model-dir /ckpt --init in.png --scale-factor 4
    python -m mdu_tpu_torch.cli demofusion --model-dir /ckpt --prompt "..." --scale 3
    python -m mdu_tpu_torch.cli info out.png
    python -m mdu_tpu_torch.cli vae-roundtrip --model-dir /ckpt --image in.png

Everything runs on the card (``--device`` names another device; the tests
pass ``--device cpu``). ``--bf16`` picks bf16 weights and compute, fp32
otherwise. Images are read and written as PNG by the port's own codec
(``utils/image.py``), with the generation settings as JSON in the PNG's
``parameters`` text; other input formats need PIL. Noise: the pipeline's
seeded generators; ``demofusion --init`` and ``vae-roundtrip`` sample the
encoder's moments from a ``torch.Generator`` seeded with the seed (0 for
``vae-roundtrip``). ``--devices N`` shards the grid's tiles over the first
N cards (``parallel.make_tile_mesh``); with fewer cards it warns and takes
those there are, and with one it runs unsharded, as the JAX CLI does.
``demofusion`` on more than one device raises: its sharded windows are not
ported yet.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--model-dir", required=True,
                   help="diffusers-layout checkpoint folder, or a single "
                        ".safetensors file (A1111/LDM layout)")
    p.add_argument("--tokenizer-dir",
                   help="vocab.json+merges.txt folder for single-file "
                        "checkpoints (default: <ckpt dir>/tokenizer)")
    p.add_argument("--prompt", default="")
    p.add_argument("--negative", default="")
    p.add_argument("--style", action="append", default=[],
                   help="apply a named style from --styles-file; repeatable")
    p.add_argument("--styles-file", default="styles.csv",
                   help="A1111-format styles.csv")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--sampler", default="Euler",
                   choices=["Euler", "Euler a", "Heun", "DPM2", "DPM2 a",
                            "DPM++ 2M", "DPM++ 2S a", "DPM++ SDE",
                            "DPM++ 2M SDE", "DPM fast", "DPM adaptive",
                            "DDIM", "LMS", "PLMS", "Restart"])
    p.add_argument("--schedule", default="automatic", choices=["automatic", "karras"])
    p.add_argument("--cfg-scale", type=float, default=7.0)
    p.add_argument("--deepcache", type=int, default=1, metavar="N",
                   help="DeepCache acceleration: run the full UNet every Nth "
                        "step, shallow cached steps between (1 = off/exact; "
                        "2-3 typical). Regions always run the full model")
    p.add_argument("--deepcache-branch", type=int, default=1,
                   help="cache depth: 1 caches at full latent resolution "
                        "(fastest), deeper = smaller cache, less speedup")
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--out", default="out.png")
    p.add_argument("--bf16", action="store_true", help="bfloat16 weights/compute")
    p.add_argument("--devices", type=int, default=1,
                   help="shard grid tiles over this many devices (1 = off; "
                        "txt2img and img2img only: DemoFusion refuses a mesh)")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the first CUDA device)")
    p.add_argument("--lora", action="append", default=[],
                   help="LoRA safetensors to merge, as path[:weight]; repeatable")
    p.add_argument("--lora-dir",
                   help="directory resolving <lora:name:w> prompt tags "
                        "(default: <model-dir>/loras)")
    p.add_argument("--esrgan", help="ESRGAN safetensors: registers upscaler 'ESRGAN'")
    # tiled diffusion knobs (ref tilediffusion.py:127-132 defaults)
    p.add_argument("--method", default="MultiDiffusion",
                   choices=["MultiDiffusion", "Mixture of Diffusers"])
    p.add_argument("--tile-width", type=int, default=96)
    p.add_argument("--tile-height", type=int, default=96)
    p.add_argument("--overlap", type=int, default=48)
    p.add_argument("--tile-batch-size", type=int, default=4)
    p.add_argument("--no-tiled-diffusion", action="store_true")
    p.add_argument("--deterministic", action="store_true",
                   help="pad tile batches to a uniform shape so results are "
                        "bitwise identical on any device-mesh size (costs up "
                        "to tile_bs-1 padded tile computations per step)")
    # tiled VAE knobs (ref tilevae.py:79-99)
    p.add_argument("--vae-encoder-tile", type=int, default=1536)
    p.add_argument("--vae-decoder-tile", type=int, default=96)
    p.add_argument("--fast-decoder", action="store_true", default=True)
    p.add_argument("--no-fast-decoder", dest="fast_decoder", action="store_false")
    p.add_argument("--fast-encoder", action="store_true", default=True)
    p.add_argument("--no-fast-encoder", dest="fast_encoder", action="store_false")
    p.add_argument("--color-fix", action="store_true",
                   help="fast-encoder color fix (ref tilevae.py:693: "
                        "re-estimate stats per tile, keep only the DC shift)")
    p.add_argument("--no-tiled-vae", action="store_true")
    p.add_argument("--vae-streaming", action="store_true",
                   help="fixed-memory exact tiled VAE: host-resident tiles, "
                        "segments streamed through the card (the 8K path)")
    p.add_argument("--vae-spill-dtype", default=None,
                   help="compress stream-host inter-segment spills, e.g. "
                        "float8_e4m3fn (halves host<->device traffic; "
                        "slightly lossy)")
    # ControlNet + StableSR-style guidance (ref abstractdiffusion.py:454-588)
    p.add_argument("--controlnet",
                   help="ControlNet checkpoint: diffusers-layout folder or a "
                        ".safetensors with diffusers keys")
    p.add_argument("--control-image",
                   help="hint image for --controlnet; resized to the "
                        "generation canvas (img2img default: the init image "
                        "— the ControlNet 'tile' upscaling workflow)")
    p.add_argument("--control-weight", type=float, default=1.0,
                   help="ControlNet conditioning scale")
    p.add_argument("--guidance-model",
                   help="StableSR-style structure-guidance encoder weights "
                        "(.safetensors in mdu_tpu flat layout; see "
                        "scripts/export_params.py)")
    p.add_argument("--guidance-image",
                   help="low-res guidance image for --guidance-model, "
                        "encoded to the latent 'guidance' leaf (img2img "
                        "default: the init image)")
    p.add_argument("--guidance-strength", type=float, default=1.0,
                   help="guidance residual scale")
    # region prompt control
    p.add_argument("--regions", help="region-config JSON file "
                   "(ref region_configs/ format), or a generated .png to "
                   "recover regions + resolved seeds from its metadata")
    p.add_argument("--draw-background", action="store_true", default=True)
    p.add_argument("--no-draw-background", dest="draw_background", action="store_false")


def _available_devices(dev) -> list:
    """The devices a mesh may take: the cards, or ``dev`` alone for any other
    device."""
    import torch

    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def _devices(args) -> list:
    """The first ``--devices`` of the available devices, with a warning when
    fewer are there (``mdu_tpu/cli.py:139-148``)."""
    have = _available_devices(args._device)
    devs = have[:args.devices]
    if len(devs) < args.devices:
        print(f"warning: only {len(devs)} of {args.devices} requested devices "
              "available", file=sys.stderr)
    return devs


def _load(args):
    import torch

    from .device import resolve_device
    from .models.loader import load_model

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    args._device = device = resolve_device(getattr(args, "device", None))
    print(f"loading checkpoint from {args.model_dir} ...", file=sys.stderr)
    pipe, conditioner = load_model(args.model_dir, dtype, device,
                                   getattr(args, "tokenizer_dir", None))
    if getattr(args, "devices", 1) > 1:
        from .parallel import make_tile_mesh

        devs = _devices(args)
        if len(devs) > 1:
            pipe.mesh = make_tile_mesh(devices=devs)
            what = "windows and views" if args.fn is cmd_demofusion else "grid tiles"
            print(f"sharding {what} over {len(devs)} devices", file=sys.stderr)
    if getattr(args, "controlnet", None):
        from .models.loader import load_controlnet

        pipe.controlnet = load_controlnet(
            args.controlnet, pipe.unet.cfg, dtype=dtype,
            conditioning_scale=args.control_weight, device=device).eval()
        print(f"loaded ControlNet from {args.controlnet} "
              f"(weight {args.control_weight})", file=sys.stderr)
    if getattr(args, "guidance_model", None):
        from .models.loader import load_guidance

        pipe.guidance_model = load_guidance(
            args.guidance_model, pipe.unet.cfg, dtype=dtype,
            guidance_scale=args.guidance_strength, device=device).eval()
        print(f"loaded guidance encoder from {args.guidance_model} "
              f"(strength {args.guidance_strength})", file=sys.stderr)
    if getattr(args, "esrgan", None):
        from .models.esrgan import register_esrgan_upscaler

        register_esrgan_upscaler("ESRGAN", args.esrgan, dtype=dtype, device=device)
        print(f"registered ESRGAN upscaler from {args.esrgan}", file=sys.stderr)
    for spec in getattr(args, "lora", []):
        path, _, w = spec.rpartition(":")
        if not path:                    # no :weight suffix
            path, w = spec, "1.0"
        try:
            weight = float(w)
        except ValueError:
            path, weight = spec, 1.0
        print(f"merging LoRA {path} @ {weight}", file=sys.stderr)
        _merge_lora(pipe, path, weight)
    return pipe, conditioner


def _merge_lora(pipe, path: str, weight: float) -> None:
    """Merge a LoRA file into the pipeline's UNet weights in place."""
    from .models.loader import load_safetensors
    from .models.lora import merge_lora

    merged = merge_lora(pipe.unet.state_dict(), load_safetensors(path), scale=weight)
    pipe.unet.load_state_dict(merged)


def _apply_styles(args):
    """Resolve --style names through --styles-file into the prompt pair
    (ref Prompt.apply_styles, tile_utils/utils.py:106-109)."""
    import os

    if not getattr(args, "style", None):
        return
    from .text.prompt import apply_styles, load_styles

    if not os.path.exists(args.styles_file):
        print(f"warning: styles file {args.styles_file!r} not found; "
              "styles ignored", file=sys.stderr)
        return
    table = load_styles(args.styles_file)
    for name in args.style:
        if name not in table:
            print(f"warning: unknown style {name!r}", file=sys.stderr)
    args.prompt, args.negative = apply_styles(args.prompt, args.negative,
                                              args.style, table)


def _configs(args):
    from .config import (SamplerConfig, TiledDiffusionConfig, TiledVAEConfig,
                         regions_from_json, regions_from_png_info)

    regions = []
    if args.regions:
        if args.regions.lower().endswith(".png"):
            # seed recovery from a generated image's metadata
            # (ref bboxHint.js getSeedInfo :171-221)
            from .utils.image import image_text

            params = image_text(args.regions).get("parameters")
            if not params:
                raise SystemExit(f"{args.regions}: no generation metadata")
            regions = regions_from_png_info(json.loads(params))
            print(f"recovered {len(regions)} region(s) from PNG metadata",
                  file=sys.stderr)
        else:
            with open(args.regions, encoding="utf-8") as f:
                regions = regions_from_json(f.read())
    td = None
    if not args.no_tiled_diffusion:
        td = TiledDiffusionConfig(
            method=args.method, tile_w=args.tile_width, tile_h=args.tile_height,
            overlap=args.overlap, tile_bs=args.tile_batch_size,
            regions=regions, draw_background=args.draw_background,
            upscaler=getattr(args, "upscaler", None),
            scale_factor=getattr(args, "scale_factor", 2.0),
            noise_inverse=getattr(args, "noise_inverse", False),
            noise_inverse_steps=getattr(args, "noise_inverse_steps", 10),
            noise_inverse_retouch=getattr(args, "noise_inverse_retouch", 1.0),
            noise_inverse_renoise_strength=getattr(args, "noise_inverse_renoise_strength", 1.0),
            noise_inverse_renoise_kernel=getattr(args, "noise_inverse_renoise_kernel", 64),
            deterministic=getattr(args, "deterministic", False),
        ).validate()
    tv = None
    if not args.no_tiled_vae:
        tv = TiledVAEConfig(encoder_tile_size=args.vae_encoder_tile,
                            decoder_tile_size=args.vae_decoder_tile,
                            fast_decoder=args.fast_decoder,
                            fast_encoder=args.fast_encoder,
                            color_fix=getattr(args, "color_fix", False),
                            streaming=getattr(args, "vae_streaming", False),
                            spill_dtype=getattr(args, "vae_spill_dtype", None))
    sp = SamplerConfig(name=args.sampler, steps=args.steps, cfg_scale=args.cfg_scale,
                       schedule=args.schedule,
                       denoising_strength=getattr(args, "denoising_strength", 0.75),
                       image_cfg_scale=getattr(args, "image_cfg_scale", None),
                       deepcache=args.deepcache,
                       deepcache_branch=args.deepcache_branch)
    return td, tv, sp, regions


def _seed(args) -> int:
    if args.seed is None or args.seed == -1:
        return int(np.random.default_rng().integers(0, 2**31 - 1))
    return args.seed


def _region_conds(conditioner, regions, args, steps):
    return [conditioner.region_pair(args.prompt, r.prompt, r.neg_prompt, args.negative, steps)
            for r in regions]


def _attach_adapter_conds(args, pipe, cond, uncond, region_conds, tv, init_path=None):
    """Attach the ControlNet hint / StableSR-style guidance canvases to every
    cond that denoises (main pair + regions). Canvas-shaped leaves are cut
    per tile and region by ``tiling/conds.py`` and fitted to the generation
    canvas by the pipeline, so any hint size works; img2img defaults both
    images to the init image (ref abstractdiffusion.py:454-588)."""
    from .utils.image import hint_to_tensor, image_to_tensor, load_image

    hint = None
    if pipe.controlnet is not None:
        src = getattr(args, "control_image", None) or init_path
        if src is None:
            raise SystemExit("--controlnet needs --control-image "
                             "(txt2img has no init image to default to)")
        hint = hint_to_tensor(load_image(src, "RGB"))
        print(f"ControlNet hint: {src}", file=sys.stderr)
    g = None
    if pipe.guidance_model is not None:
        src = getattr(args, "guidance_image", None) or init_path
        if src is None:
            raise SystemExit("--guidance-model needs --guidance-image "
                             "(txt2img has no init image to default to)")
        x = image_to_tensor(load_image(src, "RGB"))
        # the mode of the encoded guidance image, latent-canvas shaped (the
        # StableSR latent_image analogue, ref abstractdiffusion.py:559-571)
        moments = pipe._encode(x, tv)
        g = moments[:, : moments.shape[1] // 2] * pipe.vae.cfg.scaling_factor
        print(f"guidance latent from: {src}", file=sys.stderr)
    if hint is None and g is None:
        return cond, uncond, region_conds

    def att(c):
        if c is None:
            return None
        out = dict(c)
        if hint is not None:
            out["control"] = [hint]
        if g is not None:
            out["guidance"] = g
        return out

    return att(cond), att(uncond), [(att(rc), att(ru)) for rc, ru in region_conds]


def _apply_prompt_networks(pipe, args, regions=()):
    """Merge the ``<lora:name:weight>`` tags of the prompts (A1111 syntax;
    ref tile_utils/utils.py:123-131) into the UNet weights. Names resolve
    to ``<lora-dir>/<name>.safetensors``; unknown names warn and are
    skipped."""
    import os

    from .text.prompt import extract_networks

    seen = {}
    texts = [args.prompt, args.negative]
    for r in regions:
        texts += [r.prompt, r.neg_prompt]
    for text in texts:
        _, nets = extract_networks(text or "")
        for kind, name, weight in nets:
            seen[(kind, name)] = weight
    if not seen:
        return
    lora_dir = getattr(args, "lora_dir", None) or os.path.join(args.model_dir, "loras")
    for (kind, name), weight in seen.items():
        if kind != "lora":
            print(f"warning: <{kind}:{name}> networks are not supported; skipped",
                  file=sys.stderr)
            continue
        path = os.path.join(lora_dir, f"{name}.safetensors")
        if not os.path.exists(path):
            print(f"warning: LoRA {name!r} not found at {path}; skipped",
                  file=sys.stderr)
            continue
        print(f"merging <lora:{name}:{weight}> from {path}", file=sys.stderr)
        _merge_lora(pipe, path, weight)


_INTERRUPT = {"pipe": None}


def _install_sigint_watcher():
    """Graceful Ctrl-C for one-shot runs (the reference UI's Interrupt
    button): the first SIGINT sets the registered pipeline's
    ``interrupted``, so the remaining steps run no UNet and the partial
    result is decoded and saved; a second SIGINT raises KeyboardInterrupt.

    A plain handler works here: the port's sampling loop returns to Python
    after every step, so CPython runs the handler between two steps. (The
    JAX package blocks SIGINT process-wide and watches it from a thread,
    because its whole loop is one jitted call.)"""
    import signal

    def handler(sig, frame):
        pipe = _INTERRUPT["pipe"]
        if pipe is None or pipe.interrupted:
            raise KeyboardInterrupt
        pipe.interrupted = True
        print("interrupt: skipping remaining steps, saving partial "
              "result (Ctrl-C again to abort)", file=sys.stderr)

    signal.signal(signal.SIGINT, handler)


def _graceful_interrupt(pipe):
    """Register the pipeline the SIGINT handler should flag."""
    _INTERRUPT["pipe"] = pipe


def _with_prompt(args, info: dict) -> dict:
    """A1111 infotext leads with the prompt pair; the pipeline only sees
    conds, so the CLI (which owns the strings) prepends them."""
    out = {"Prompt": args.prompt, "Negative prompt": args.negative}
    out.update(info)
    if getattr(args, "controlnet", None):
        out["ControlNet"] = {"model": args.controlnet,
                             "weight": args.control_weight,
                             "image": getattr(args, "control_image", None)
                             or getattr(args, "init", None)}
    if getattr(args, "guidance_model", None):
        out["Guidance"] = {"model": args.guidance_model,
                           "strength": args.guidance_strength,
                           "image": getattr(args, "guidance_image", None)
                           or getattr(args, "init", None)}
    if getattr(args, "_pipe", None) is not None and args._pipe.interrupted:
        out["Interrupted"] = True
    return out


def _save(images: np.ndarray, path: str, info: dict):
    from .utils.image import save_png

    text = {"parameters": json.dumps(info)}
    for i, img in enumerate(images):
        p = path if images.shape[0] == 1 else path.replace(".png", f"_{i}.png")
        save_png(p, img, text)
        print(f"saved {p}", file=sys.stderr)


def _prepare(args):
    """Styles, the pipeline and its settings, the cond pair: what every
    generating command starts with."""
    _apply_styles(args)
    pipe, conditioner = _load(args)
    td, tv, sp, regions = _configs(args)
    cond, uncond = conditioner.pair(args.prompt, args.negative, sp.steps)
    return pipe, conditioner, td, tv, sp, regions, cond, uncond


def cmd_txt2img(args):
    from .utils.telemetry import perfcount

    pipe, conditioner, td, tv, sp, regions, cond, uncond = _prepare(args)
    rc = _region_conds(conditioner, regions, args, sp.steps)
    cond, uncond, rc = _attach_adapter_conds(args, pipe, cond, uncond, rc, tv)
    args._pipe = pipe
    _graceful_interrupt(pipe)
    _apply_prompt_networks(pipe, args, regions)
    seed = _seed(args)
    with perfcount("Tiled Diffusion"):
        res = pipe.txt2img(cond, uncond, args.width, args.height, sp, seed,
                           tiled_diffusion=td, tiled_vae=tv, region_conds=rc)
    _save(res.images, args.out, _with_prompt(args, res.info))


def cmd_img2img(args):
    from .utils.image import load_image
    from .utils.telemetry import perfcount

    pipe, conditioner, td, tv, sp, regions, cond, uncond = _prepare(args)
    rc = _region_conds(conditioner, regions, args, sp.steps)
    cond, uncond, rc = _attach_adapter_conds(args, pipe, cond, uncond, rc, tv,
                                             init_path=args.init)
    args._pipe = pipe
    _graceful_interrupt(pipe)
    _apply_prompt_networks(pipe, args, regions)
    img = load_image(args.init, "RGB")
    # --image-cfg-scale: pipeline.img2img attaches the post-upscale init
    # latent's mode as the 'concat' leaf itself
    mask = None
    if getattr(args, "mask", None):
        mask = load_image(args.mask, "L").astype(np.float32) / 255.0
    seed = _seed(args)
    tgt = None
    if args.width is not None or args.height is not None:
        if args.width is None or args.height is None:
            raise SystemExit("img2img: give both -W and -H (or neither)")
        tgt = (args.height, args.width)
    with perfcount("Tiled Diffusion"):
        res = pipe.img2img(img, cond, uncond, sp, seed, tiled_diffusion=td,
                           tiled_vae=tv, region_conds=rc, mask=mask,
                           target_size=tgt)
    _save(res.images, args.out, _with_prompt(args, res.info))


def cmd_demofusion(args):
    import torch

    from .config import DemoFusionConfig
    from .models.vae import sample_from_moments
    from .utils.image import image_to_tensor, load_image
    from .utils.telemetry import perfcount

    pipe, _, _, tv, sp, _, cond, uncond = _prepare(args)
    cond, uncond, _ = _attach_adapter_conds(args, pipe, cond, uncond, [], tv,
                                            init_path=args.init)
    args._pipe = pipe
    _graceful_interrupt(pipe)
    _apply_prompt_networks(pipe, args)
    seed = _seed(args)
    init_latent = None
    if args.init:
        x = image_to_tensor(load_image(args.init, "RGB"))
        moments = pipe._encode(x, tv)
        gen = torch.Generator(device=pipe.device).manual_seed(seed)
        init_latent = sample_from_moments(moments, generator=gen) * pipe.vae.cfg.scaling_factor
    cfg = DemoFusionConfig(
        window_size=args.window_size, overlap=args.overlap,
        scale_factor=args.scale, cosine_scale_1=args.cosine_scale_1,
        cosine_scale_2=args.cosine_scale_2, cosine_scale_3=args.cosine_scale_3,
        sigma=args.sigma, random_jitter=not args.no_jitter, mixture=args.mixture,
        denoise_strengths=tuple(args.denoise_strengths))
    with perfcount("DemoFusion"):
        res = pipe.demofusion(cond, uncond, args.width, args.height, cfg, sp,
                              seed, init_latent=init_latent, tiled_vae=tv)
    for i, imgs in enumerate(res.images):
        _save(imgs, args.out.replace(".png", f"_scale{i + 1}.png"),
              _with_prompt(args, res.info))


def cmd_info(args):
    """Print the generation metadata of a PNG (ref seed recovery,
    javascript/bboxHint.js:171-221)."""
    from .utils.image import image_text

    params = image_text(args.image).get("parameters")
    if not params:
        print("no generation metadata found", file=sys.stderr)
        sys.exit(1)
    print(json.dumps(json.loads(params), indent=2))


def cmd_vae_roundtrip(args):
    import torch

    from .models.vae import sample_from_moments
    from .utils.image import image_to_tensor, load_image
    from .utils.telemetry import perfcount

    pipe, _ = _load(args)
    _, tv, _, _ = _configs(args)
    x = image_to_tensor(load_image(args.image, "RGB"))
    with perfcount("Tiled VAE encode"):
        moments = pipe._encode(x, tv)
    z = sample_from_moments(moments, generator=torch.Generator(device=pipe.device).manual_seed(0))
    with perfcount("Tiled VAE decode"):
        img = pipe._decode(z * pipe.vae.cfg.scaling_factor, tv)
    _save(img, args.out, {"roundtrip": True})


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="mdu_tpu_torch",
                                 description="tiled diffusion upscaler on the card")
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("txt2img", help="tiled text-to-image (panoramas, 2K-8K)")
    _add_common(t)
    t.add_argument("-W", "--width", type=int, default=512)
    t.add_argument("-H", "--height", type=int, default=512)
    t.set_defaults(fn=cmd_txt2img)

    i = sub.add_parser("img2img", help="tiled image-to-image upscaling")
    _add_common(i)
    i.add_argument("--init", required=True, help="input image")
    i.add_argument("--mask", help="grayscale inpaint mask (white = redraw); "
                   "masked-redraw semantics like A1111 img2img")
    i.add_argument("--upscaler", default="Lanczos",
                   choices=["None", "Nearest", "Bilinear", "Bicubic", "Lanczos"])
    i.add_argument("--scale-factor", type=float, default=2.0)
    i.add_argument("--denoising-strength", type=float, default=0.75)
    i.add_argument("--image-cfg-scale", type=float, default=None,
                   help="edit-model (instruct-pix2pix) image guidance scale; "
                        "enables 3-way CFG with the init image as 'concat' "
                        "conditioning (needs an 8-channel ip2p UNet)")
    i.add_argument("--noise-inverse", action="store_true")
    i.add_argument("--noise-inverse-steps", type=int, default=10)
    i.add_argument("--noise-inverse-retouch", type=float, default=1.0)
    i.add_argument("--noise-inverse-renoise-strength", type=float, default=1.0)
    i.add_argument("--noise-inverse-renoise-kernel", type=int, default=64)
    i.add_argument("-W", "--width", type=int, default=None,
                   help="final canvas width: resize the (upscaled) init to "
                        "exactly this before generation — the reference's "
                        "keep-input-size=off path (tilediffusion.py:299-307); "
                        "default keeps the upscaled size (checkbox default)")
    i.add_argument("-H", "--height", type=int, default=None)
    i.set_defaults(fn=cmd_img2img)

    d = sub.add_parser("demofusion", help="DemoFusion progressive upscaling")
    _add_common(d)
    d.add_argument("-W", "--width", type=int, default=1024)
    d.add_argument("-H", "--height", type=int, default=1024)
    d.add_argument("--scale", type=int, default=3)
    d.add_argument("--window-size", type=int, default=128)
    d.add_argument("--cosine-scale-1", type=float, default=3.0)
    d.add_argument("--cosine-scale-2", type=float, default=1.0)
    d.add_argument("--cosine-scale-3", type=float, default=1.0)
    d.add_argument("--sigma", type=float, default=0.6)
    d.add_argument("--no-jitter", action="store_true")
    d.add_argument("--mixture", action="store_true")
    d.add_argument("--denoise-strengths", type=float, nargs="+", default=[0.45])
    d.add_argument("--init", help="optional init image (img2img DemoFusion)")
    # DemoFusion's own overlap default is 64, not Tiled Diffusion's 48
    # (ref tileglobal.py:89 vs tilediffusion.py:131)
    d.set_defaults(fn=cmd_demofusion, overlap=64)

    n = sub.add_parser("info", help="print generation metadata from a PNG")
    n.add_argument("image")
    n.set_defaults(fn=cmd_info)

    v = sub.add_parser("vae-roundtrip", help="tiled VAE encode+decode check")
    _add_common(v)
    v.add_argument("--image", required=True)
    v.set_defaults(fn=cmd_vae_roundtrip)
    return ap


def main(argv: Optional[List[str]] = None):
    args = build_parser().parse_args(argv)
    _install_sigint_watcher()
    try:
        args.fn(args)
    except BrokenPipeError:        # e.g. `mdu_tpu_torch info x.png | head`
        sys.exit(0)


if __name__ == "__main__":
    main()
