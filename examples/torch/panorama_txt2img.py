"""Benchmark config 2 on the PyTorch port: a MultiDiffusion 2048x512
panorama (BASELINE.md), written as a PNG through the port's codec.

    python examples/torch/panorama_txt2img.py --model-dir /ckpts/sd15
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from mdu_tpu_torch.config import (Method, SamplerConfig, TiledDiffusionConfig,  # noqa: E402
                                  TiledVAEConfig)
from mdu_tpu_torch.models.loader import load_model  # noqa: E402
from mdu_tpu_torch.utils.image import save_png  # noqa: E402
from mdu_tpu_torch.utils.telemetry import perfcount  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model-dir", required=True, help="diffusers folder or single file")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--prompt", default="a vast mountain panorama at golden hour")
    ap.add_argument("--width", type=int, default=2048)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--tile", type=int, default=96, help="latent tile size")
    ap.add_argument("--overlap", type=int, default=48)
    ap.add_argument("--out", default="panorama.png")
    args = ap.parse_args(argv)

    pipe, conditioner = load_model(args.model_dir, device=args.device)
    cond, uncond = conditioner.pair(args.prompt, "blurry, lowres", steps=args.steps)
    with perfcount("MultiDiffusion panorama"):
        res = pipe.txt2img(
            cond, uncond, width=args.width, height=args.height,
            sampler=SamplerConfig(name="Euler", steps=args.steps), seed=42,
            tiled_diffusion=TiledDiffusionConfig(method=Method.MULTI_DIFF, tile_w=args.tile,
                                                 tile_h=args.tile, overlap=args.overlap),
            tiled_vae=TiledVAEConfig())
    save_png(args.out, res.images[0])
    print("saved", args.out, res.info)
    return res


if __name__ == "__main__":
    main()
