"""Benchmark config 3 on the PyTorch port: a Mixture-of-Diffusers x4
img2img upscale with gaussian blending and tiled noise inversion
(BASELINE.md), the exact VAE streamed through host memory.

    python examples/torch/upscale_4x_noise_inversion.py --model-dir /ckpts/sd15 \\
        --init input.png
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from mdu_tpu_torch.config import (Method, SamplerConfig, TiledDiffusionConfig,  # noqa: E402
                                  TiledVAEConfig)
from mdu_tpu_torch.models.loader import load_model  # noqa: E402
from mdu_tpu_torch.utils.image import load_image, save_png  # noqa: E402
from mdu_tpu_torch.utils.telemetry import perfcount  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model-dir", required=True, help="diffusers folder or single file")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--init", required=True)
    ap.add_argument("--prompt", default="highly detailed, 8k photo")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--tile", type=int, default=96, help="latent tile size")
    ap.add_argument("--out", default="upscaled.png")
    args = ap.parse_args(argv)

    pipe, conditioner = load_model(args.model_dir, device=args.device)
    cond, uncond = conditioner.pair(args.prompt, "blurry", steps=args.steps)
    img = load_image(args.init, "RGB")
    td = TiledDiffusionConfig(
        method=Method.MIX_DIFF, tile_w=args.tile, tile_h=args.tile, overlap=8,
        upscaler="Lanczos", scale_factor=4.0, noise_inverse=True, noise_inverse_steps=10,
        noise_inverse_renoise_strength=1.0)
    tv = TiledVAEConfig(streaming=True, fast_encoder=False, fast_decoder=False)
    with perfcount("MoD x4 upscale"):
        res = pipe.img2img(img, cond, uncond,
                           sampler=SamplerConfig(steps=args.steps, denoising_strength=0.4),
                           seed=7, tiled_diffusion=td, tiled_vae=tv)
    save_png(args.out, res.images[0])
    print("saved", args.out)
    return res


if __name__ == "__main__":
    main()
