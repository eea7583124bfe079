"""Benchmark config 4 on the PyTorch port: regional prompt control with a
background prompt, a feathered FOREGROUND region and a BACKGROUND one.

    python examples/torch/regional_prompts.py --model-dir /ckpts/sd15
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from mdu_tpu_torch.config import SamplerConfig, TiledDiffusionConfig, TiledVAEConfig  # noqa: E402
from mdu_tpu_torch.models.loader import load_model  # noqa: E402
from mdu_tpu_torch.utils.bbox import BlendMode, RegionSpec  # noqa: E402
from mdu_tpu_torch.utils.image import save_png  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model-dir", required=True, help="diffusers folder or single file")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--size", type=int, default=1536, help="width and height in pixels")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--tile", type=int, default=96, help="latent tile size")
    ap.add_argument("--out", default="regions.png")
    args = ap.parse_args(argv)

    pipe, conditioner = load_model(args.model_dir, device=args.device)
    base = "a sunlit meadow, masterpiece"
    regions = [
        RegionSpec(0.05, 0.2, 0.4, 0.7, "a red fox sitting", seed=101,
                   blend_mode=BlendMode.FOREGROUND, feather_ratio=0.3),
        RegionSpec(0.55, 0.15, 0.4, 0.75, "an old oak tree", seed=202),
    ]
    cond, uncond = conditioner.pair(base, "lowres", steps=args.steps)
    rc = [conditioner.region_pair(base, r.prompt, r.neg_prompt, "lowres", args.steps)
          for r in regions]
    res = pipe.txt2img(cond, uncond, width=args.size, height=args.size,
                       sampler=SamplerConfig(steps=args.steps), seed=5,
                       tiled_diffusion=TiledDiffusionConfig(regions=regions, tile_w=args.tile,
                                                            tile_h=args.tile),
                       tiled_vae=TiledVAEConfig(), region_conds=rc)
    save_png(args.out, res.images[0])
    print("saved", args.out, res.info["Tiled Diffusion"]["Region control"])
    return res


if __name__ == "__main__":
    main()
