"""The port's examples (``examples/torch/``) on the CPU, on a tiny LDM single
file (``tests/synth_ckpt.py``) with the port's config factories pointed at
the tiny configs while they load, as ``tests/test_torch_cli.py`` patches
them: each Python example's ``main`` at a small size, and the shell script's
command line (``PRINT_ARGS=1``) through the port's CLI with a tiny
ControlNet. Each writes a PNG through the port's codec (``save_png``)."""
import dataclasses
import importlib.util
import os
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from mdu_tpu.models import tiny_clip_config as jax_tiny_clip
from mdu_tpu.models import tiny_vae_config as jax_tiny_vae
from mdu_tpu.models.unet import UNetConfig as JaxUNetConfig
from mdu_tpu_torch import cli
from mdu_tpu_torch.models import clip as clip_mod
from mdu_tpu_torch.models import unet as unet_mod
from mdu_tpu_torch.models import vae as vae_mod
from mdu_tpu_torch.utils.image import load_image, save_png
from synth_ckpt import save_tiny_controlnet, save_tiny_ldm_checkpoint

torch.set_num_threads(2)
EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "torch"
TWO_LEVELS = dict(block_out_channels=(8, 16), cross_attention_dim=16, num_heads=2,
                  transformer_layers=(1, 0), norm_num_groups=4)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    ucfg, vcfg, ccfg = JaxUNetConfig(**TWO_LEVELS), jax_tiny_vae(), jax_tiny_clip()
    pu = unet_mod.UNetConfig(**dataclasses.asdict(ucfg))
    pv = vae_mod.VAEConfig(**dataclasses.asdict(vcfg))
    pc = clip_mod.CLIPTextConfig(**dataclasses.asdict(ccfg))
    mp.setattr(unet_mod, "sd15_unet_config", lambda: pu)
    mp.setattr(vae_mod, "VAEConfig", lambda **kw: pv)
    mp.setattr(clip_mod, "clip_l_config", lambda: pc)
    mp.setattr(cli, "_install_sigint_watcher", lambda: None)
    root = tmp_path_factory.mktemp("examples")
    ckpt = str(root / "tiny.safetensors")
    save_tiny_ldm_checkpoint(ckpt, ucfg, vcfg, ccfg)
    init = str(root / "init.png")
    save_png(init, np.random.default_rng(0).integers(0, 256, (32, 32, 3), dtype=np.uint8))
    yield dict(root=root, ckpt=ckpt, init=init, ucfg=ucfg)
    mp.undo()


def _example(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (example, its small-size arguments, the PNG it writes, that PNG's [H, W])
CASES = {
    "panorama_txt2img": (["--width", "256", "--height", "64", "--steps", "2", "--tile", "16",
                          "--overlap", "8"], "out.png", (64, 256)),
    "upscale_4x_noise_inversion": (["--steps", "2", "--tile", "8", "--init", None], "out.png",
                                   (128, 128)),
    "regional_prompts": (["--size", "128", "--steps", "2", "--tile", "8"], "out.png",
                         (128, 128)),
    "demofusion_x3": (["--size", "64", "--steps", "2", "--window", "8", "--devices", "2"],
                      "out_scale3.png", (192, 192)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_a_tiny_checkpoint(env, name):
    extra, png, hw = CASES[name]
    extra = [env["init"] if a is None else a for a in extra]
    out = str(env["root"] / f"{name}_out.png")
    res = _example(name).main(["--model-dir", env["ckpt"], "--device", "cpu", "--out", out,
                               *extra])
    assert torch.isfinite(res.latents).all()
    img = load_image(out.replace("out.png", png))
    assert img.shape == (*hw, 3) and img.dtype == np.uint8


def test_controlnet_tile_upscale_script(env):
    """The script's command line (``PRINT_ARGS=1``: the arguments it would
    hand ``python -m mdu_tpu_torch.cli``), run through the port's CLI in
    this process with a tiny ControlNet; the hint is the init image."""
    root = env["root"]
    controlnet = str(root / "controlnet.safetensors")
    save_tiny_controlnet(controlnet, env["ucfg"])
    out = str(root / "upscaled.png")
    run = subprocess.run(
        ["sh", str(EXAMPLES / "controlnet_tile_upscale.sh"), "--steps", "2",
         "--tile-width", "8", "--tile-height", "8", "--vae-decoder-tile", "16"],
        env={**os.environ, "PRINT_ARGS": "1", "MODEL": env["ckpt"], "CONTROLNET": controlnet,
             "INIT": env["init"], "OUT": out, "DEVICE": "cpu"},
        capture_output=True, text=True, check=True)
    argv = run.stdout.splitlines()
    assert argv[0] == "img2img" and argv[argv.index("--controlnet") + 1] == controlnet
    assert argv[argv.index("--device") + 1] == "cpu"
    cli.main(argv)
    assert load_image(out).shape == (128, 128, 3)
