"""DemoFusion x3 progressive upscale on the PyTorch port (ref tileglobal.py
demo); ``--devices N`` shards its windows and views over N cards.

    python examples/torch/demofusion_x3.py --model-dir /ckpts/sdxl
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from mdu_tpu_torch.config import DemoFusionConfig, SamplerConfig  # noqa: E402
from mdu_tpu_torch.models.loader import load_model  # noqa: E402
from mdu_tpu_torch.parallel import make_tile_mesh  # noqa: E402
from mdu_tpu_torch.utils.image import save_png  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model-dir", required=True, help="diffusers folder or single file")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--devices", type=int, default=1,
                    help="shards of the windows and views, one a card (on the CPU: "
                         "CPU shards)")
    ap.add_argument("--prompt", default="portrait photo of an astronaut")
    ap.add_argument("--size", type=int, default=1024, help="phase-1 width and height")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--window", type=int, default=128, help="latent window size")
    ap.add_argument("--out", default="demofusion.png")
    args = ap.parse_args(argv)

    pipe, conditioner = load_model(args.model_dir, device=args.device)
    if args.devices > 1:
        devs = ([pipe.device] * args.devices if pipe.device.type == "cpu" else None)
        pipe.mesh = make_tile_mesh(args.devices, devices=devs)
    cond, uncond = conditioner.pair(args.prompt, "blurry", steps=args.steps)
    res = pipe.demofusion(cond, uncond, width=args.size, height=args.size,
                          cfg=DemoFusionConfig(scale_factor=3, mixture=True,
                                               window_size=args.window,
                                               overlap=args.window // 2),
                          sampler=SamplerConfig(steps=args.steps), seed=1)
    for i, imgs in enumerate(res.images):
        save_png(args.out.replace(".png", f"_scale{i + 1}.png"), imgs[0])
    print("saved all scales")
    return res


if __name__ == "__main__":
    main()
