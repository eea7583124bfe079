"""The port's command line (``mdu_tpu_torch/cli.py``) against the JAX
package's (``mdu_tpu/cli.py``), on a tiny LDM single file that both read
(``tests/synth_ckpt.py``; the config factories point at a two-level tiny
UNet, the tiny VAE and CLIP while the loaders run, as
``tests/test_cli.py:18-35`` patches them for JAX, and the SIGINT installers
are patched out).

* Parsing: for several argvs, the port's ``_configs`` (tiled diffusion,
  tiled VAE, sampler, regions) and its infotext equal the JAX CLI's.
* The slice as a whole: ``txt2img`` and ``img2img`` (Lanczos x2, noise
  inversion) through both CLIs in fp32 on the CPU, the port fed JAX's
  draws (the pipelines' noise entry points, as the pipeline tests feed
  them): the PNGs within 1 uint8 level, their ``parameters`` JSON equal,
  and ``info`` printing the same.
* ``<lora:name:w>`` tags merge the same weights (within 1e-6); ``--devices
  2`` on one device runs as 1; the loaders honour ``MDU_UNET_LAYOUT``; an
  interrupted run says so in its infotext; the SIGINT handler's two
  presses.

Two JAX CLI runs in all (module-scoped), each compiling a tiny pipeline."""
import argparse
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import mdu_tpu.cli as jcli
from mdu_tpu.models import tiny_clip_config as jax_tiny_clip
from mdu_tpu.models import tiny_vae_config as jax_tiny_vae
from mdu_tpu.models.unet import UNetConfig as JaxUNetConfig
from mdu_tpu.pipeline import DiffusionPipeline as JaxPipeline
from mdu_tpu_torch import cli
from mdu_tpu_torch.models import clip as clip_mod
from mdu_tpu_torch.models import unet as unet_mod
from mdu_tpu_torch.models import vae as vae_mod
from mdu_tpu_torch.models.convert import state_dict_from_jax
from mdu_tpu_torch.models.safetensors import save_file
from mdu_tpu_torch.pipeline import DiffusionPipeline
from mdu_tpu_torch.utils.image import image_text, load_image, save_png
from synth_ckpt import patch_tiny_configs, save_tiny_ldm_checkpoint

torch.set_num_threads(2)
TWO_LEVELS = dict(block_out_channels=(8, 16), cross_attention_dim=16, num_heads=2,
                  transformer_layers=(1, 0), norm_num_groups=4)
COMMON = ["--steps", "2", "--vae-decoder-tile", "8", "--vae-encoder-tile", "64",
          "--tile-width", "8", "--tile-height", "8", "--overlap", "4"]
PROMPT = ["--prompt", "a (test:1.2) scene", "--negative", "bad"]
INSTALL_SIGINT = cli._install_sigint_watcher      # before any fixture patches it out


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The tiny checkpoint, the patched config factories of both packages,
    both SIGINT installers patched out, and a LoRA beside the file."""
    mp = pytest.MonkeyPatch()
    ucfg, vcfg, ccfg = JaxUNetConfig(**TWO_LEVELS), jax_tiny_vae(), jax_tiny_clip()
    patch_tiny_configs(mp, ucfg, vcfg, ccfg)
    pu = unet_mod.UNetConfig(**dataclasses.asdict(ucfg))
    pv = vae_mod.VAEConfig(**dataclasses.asdict(vcfg))
    pc = clip_mod.CLIPTextConfig(**dataclasses.asdict(ccfg))
    mp.setattr(unet_mod, "sd15_unet_config", lambda: pu)
    mp.setattr(vae_mod, "VAEConfig", lambda **kw: pv)
    mp.setattr(clip_mod, "clip_l_config", lambda: pc)
    mp.setattr(jcli, "_install_sigint_watcher", lambda: None)
    mp.setattr(cli, "_install_sigint_watcher", lambda: None)
    root = tmp_path_factory.mktemp("cli")
    ckpt = str(root / "tiny.safetensors")
    up = save_tiny_ldm_checkpoint(ckpt, ucfg, vcfg, ccfg)
    os.makedirs(root / "loras")
    rng = np.random.default_rng(0)
    lora = {}
    for base, shape in (("down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q", (8, 8)),
                        ("mid_block_resnets_0_conv1", (16, 16, 3, 3))):
        r = 2
        lora[f"lora_unet_{base}.lora_down.weight"] = torch.from_numpy(
            rng.normal(size=(r,) + shape[1:]).astype(np.float32) * 0.3)
        lora[f"lora_unet_{base}.lora_up.weight"] = torch.from_numpy(
            rng.normal(size=(shape[0], r) + (1, 1)[:len(shape) - 2]).astype(np.float32) * 0.3)
        lora[f"lora_unet_{base}.alpha"] = torch.tensor(1.0)
    save_file(lora, str(root / "loras" / "tiny.safetensors"))
    init = str(root / "init.png")
    yy, xx = np.mgrid[0:64, 0:64]
    save_png(init, np.stack([(yy * 4) % 256, (xx * 4) % 256, (yy + xx) * 2 % 256],
                            -1).astype(np.uint8))
    yield dict(root=root, ckpt=ckpt, init=init, up=up)
    mp.undo()


def _jax_args(argv):
    """The JAX CLI's parsed arguments for ``argv`` (its commands caught)."""
    got = {}
    saved = {n: getattr(jcli, n) for n in ("cmd_txt2img", "cmd_img2img", "cmd_demofusion")}
    try:
        for n in saved:
            setattr(jcli, n, lambda a: got.setdefault("args", a))
        jcli.main(argv)
    finally:
        for n, f in saved.items():
            setattr(jcli, n, f)
    return got["args"]


def _port_args(argv):
    return cli.build_parser().parse_args(argv)


def _as_dict(obj):
    if obj is None:
        return None
    d = dataclasses.asdict(obj)
    return {k: (v.value if hasattr(v, "value") else v) for k, v in d.items()}


def _same_config(got, want):
    """Every field the port's config has, equal to the JAX config's."""
    if want is None or got is None:
        assert got is None and want is None
        return
    g, w = _as_dict(got), _as_dict(want)
    for k, v in g.items():
        if k == "regions":
            assert [_as_dict(r) for r in got.regions] == [_as_dict(r) for r in want.regions]
        elif k in w:
            assert v == w[k], k


def _regions_json(path):
    payload = {f"Region {i + 1}": dict(x=0.1 * i, y=0.2, w=0.5, h=0.4, prompt=f"r{i}",
                                       neg_prompt="", blend_mode="Foreground",
                                       feather_ratio=0.3, seed=11 + i) for i in range(3)}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f)
    return payload


ARGVS = {
    "txt2img defaults": ["txt2img", "--model-dir", "m.safetensors"],
    "img2img noise inversion": ["img2img", "--model-dir", "m", "--init", "x.png",
                                "--noise-inverse", "--noise-inverse-steps", "4",
                                "--method", "Mixture of Diffusers", "--denoising-strength",
                                "0.4", "--scale-factor", "4", "--overlap", "8", "-W", "64",
                                "-H", "96", "--sampler", "DPM++ 2M", "--schedule", "karras"],
    "demofusion": ["demofusion", "--model-dir", "m", "--scale", "2", "--bf16",
                   "--deepcache", "2", "--deepcache-branch", "2"],
    "regions json": ["txt2img", "--model-dir", "m", "--regions", "REGIONS_JSON",
                     "--no-draw-background", "--tile-batch-size", "8", "--deterministic"],
    "regions png": ["txt2img", "--model-dir", "m", "--regions", "REGIONS_PNG"],
    "style": ["txt2img", "--model-dir", "m", "--prompt", "a cat", "--negative", "dog",
              "--style", "warm", "--style", "missing", "--styles-file", "STYLES"],
    "no tiled vae": ["img2img", "--model-dir", "m", "--init", "x.png", "--no-tiled-vae",
                     "--no-tiled-diffusion", "--image-cfg-scale", "1.5", "--color-fix",
                     "--vae-streaming", "--vae-spill-dtype", "float8_e4m3fn"],
}


@pytest.mark.parametrize("case", list(ARGVS))
def test_configs_and_infotext_match_jax(tmp_path, case):
    """``_configs`` and ``_with_prompt(args, _info(...))`` of the two CLIs on
    the same argv; region seeds recovered from a PNG's metadata."""
    regions_json = str(tmp_path / "regions.json")
    payload = _regions_json(regions_json)
    regions_png = str(tmp_path / "regions.png")
    save_png(regions_png, np.zeros((8, 8, 3), np.uint8), {"parameters": json.dumps(
        {"Prompt": "x", "Tiled Diffusion": {"Region control": payload}})})
    styles = str(tmp_path / "styles.csv")
    with open(styles, "w", encoding="utf-8") as f:
        f.write("name,prompt,negative_prompt\nwarm,{prompt} in warm light,cold\n")
    subst = {"REGIONS_JSON": regions_json, "REGIONS_PNG": regions_png, "STYLES": styles}
    argv = [subst.get(a, a) for a in ARGVS[case]]
    jargs, pargs = _jax_args(argv), _port_args(argv)
    for a in (jargs, pargs):
        a._pipe = None
    jcli._apply_styles(jargs)
    cli._apply_styles(pargs)
    assert (pargs.prompt, pargs.negative) == (jargs.prompt, jargs.negative)
    jtd, jtv, jsp, jreg = jcli._configs(jargs)
    td, tv, sp, reg = cli._configs(pargs)
    _same_config(td, jtd)
    _same_config(tv, jtv)
    _same_config(sp, jsp)
    assert [_as_dict(r) for r in reg] == [_as_dict(r) for r in jreg]
    if "regions" in case:
        assert len(reg) == 3 and reg[1].seed == 12
    seeds = [7 + i for i in range(len(reg))] or None
    want = jcli._with_prompt(jargs, JaxPipeline._info(None, jsp, jtd, 7, seeds))
    got = cli._with_prompt(pargs, DiffusionPipeline._info(sp, td, 7, seeds))
    assert json.dumps(got) == json.dumps(want)


def _feed_jax_noise(mp):
    """Patch the port's txt2img and img2img to draw JAX's noise for their
    seed (txt2img: ``PRNGKey(seed)``; img2img: the encoder's
    ``fold_in(PRNGKey(seed), 3)`` and the sampling ``PRNGKey(seed)``)."""

    def txt2img(self, cond, uncond, width=512, height=512, sampler=None, seed=0,
                tiled_diffusion=None, tiled_vae=None, region_conds=(), **kw):
        noise = np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                             (1, 4, height // 8, width // 8)))
        return self._txt2img_from_noise(noise, cond, uncond, sampler, seed, tiled_diffusion,
                                        tiled_vae, region_conds=region_conds)

    def img2img(self, image, cond, uncond, sampler=None, seed=0, tiled_diffusion=None,
                tiled_vae=None, region_conds=(), mask=None, target_size=None, **kw):
        x = self._prepare_image(image, tiled_diffusion, target_size)
        shape = (1, 4, x.shape[2] // 8, x.shape[3] // 8)
        key = jax.random.PRNGKey(seed)
        enc = np.asarray(jax.random.normal(jax.random.fold_in(key, 3), shape, jnp.float32))
        noise = np.asarray(jax.random.normal(key, shape, jnp.float32))
        return self._img2img_from_noise(image, enc, noise, cond, uncond, sampler, seed,
                                        tiled_diffusion, tiled_vae, region_conds, mask=mask,
                                        target_size=target_size)

    mp.setattr(DiffusionPipeline, "txt2img", txt2img)
    mp.setattr(DiffusionPipeline, "img2img", img2img)


RUNS = {
    "txt2img": ["txt2img", "-W", "128", "-H", "64", "--seed", "7"] + PROMPT + COMMON,
    "img2img": ["img2img", "--init", "INIT", "--scale-factor", "2", "--noise-inverse",
                "--noise-inverse-steps", "2", "--noise-inverse-renoise-strength", "0",
                "--method", "Mixture of Diffusers", "--denoising-strength", "0.5",
                "--seed", "5", "--steps", "4", "--vae-decoder-tile", "8",
                "--vae-encoder-tile", "64", "--tile-width", "8", "--tile-height", "8",
                "--overlap", "4"] + PROMPT,
}


@pytest.fixture(scope="module")
def jax_runs(env):
    """The JAX CLI's PNG of each run of ``RUNS`` (the two JAX runs)."""
    out = {}
    for name, argv in RUNS.items():
        path = str(env["root"] / f"jax_{name}.png")
        argv = [env["init"] if a == "INIT" else a for a in argv]
        jcli.main(argv + ["--model-dir", env["ckpt"], "--out", path])
        out[name] = path
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_cli_runs_match_jax(env, jax_runs, name, monkeypatch, tmp_path, capsys):
    """The port's PNG within 1 uint8 level of the JAX CLI's, the same
    infotext, and ``info`` printing the same JSON for both files."""
    _feed_jax_noise(monkeypatch)
    path = str(tmp_path / f"{name}.png")
    argv = [env["init"] if a == "INIT" else a for a in RUNS[name]]
    cli.main(argv + ["--model-dir", env["ckpt"], "--out", path, "--device", "cpu"])
    err = capsys.readouterr().err
    assert "[Tiled Diffusion]: Done in" in err
    got, want = load_image(path), np.asarray(Image.open(jax_runs[name]).convert("RGB"))
    assert got.shape == want.shape == ((64, 128, 3) if name == "txt2img" else (128, 128, 3))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert json.loads(image_text(path)["parameters"]) == json.loads(
        Image.open(jax_runs[name]).text["parameters"])
    for p in (path, jax_runs[name]):
        cli.main(["info", p])
        port_out = capsys.readouterr().out
        jcli.main(["info", p])
        assert port_out == capsys.readouterr().out


def test_lora_tags_merge_what_jax_merges(env):
    """``<lora:tiny:0.7>`` in the prompt and ``<lora:gone:1>`` (missing):
    the merged UNet weights of both CLIs' ``_apply_prompt_networks``."""
    from mdu_tpu.models import single_file as jsingle
    from mdu_tpu_torch.models.single_file import load_single_file

    jpipe, _ = jsingle.load_single_file(env["ckpt"])
    pipe, _ = load_single_file(env["ckpt"], device="cpu")
    before = {k: v.clone() for k, v in pipe.unet.state_dict().items()}
    args = argparse.Namespace(prompt="a <lora:tiny:0.7> cat <lora:gone:1>", negative="",
                              lora_dir=None, model_dir=str(env["root"]))
    jcli._apply_prompt_networks(jpipe, args)
    cli._apply_prompt_networks(pipe, args)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jpipe.unet_params))
    got = pipe.unet.state_dict()
    changed = 0
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-6, msg=k)
        changed += not torch.equal(got[k], before[k])
    assert changed == 2


def test_devices_above_the_cards_run_as_one(env, monkeypatch, tmp_path, capsys):
    """``--devices 2`` with one device warns and gives the ``--devices 1``
    image (the mesh over two devices: ``tests/test_torch_mesh.py``)."""
    _feed_jax_noise(monkeypatch)
    outs = []
    for n in ("1", "2"):
        path = str(tmp_path / f"d{n}.png")
        cli.main(RUNS["txt2img"] + ["--model-dir", env["ckpt"], "--out", path, "--device",
                                    "cpu", "--devices", n])
        outs.append(load_image(path))
    assert "only 1 of 2 requested devices available" in capsys.readouterr().err
    np.testing.assert_array_equal(outs[0], outs[1])


def test_loaders_honour_the_layout_flag(env, monkeypatch):
    from mdu_tpu_torch.models.single_file import load_single_file

    monkeypatch.setenv("MDU_UNET_LAYOUT", "NHWC")
    pipe, _ = load_single_file(env["ckpt"], device="cpu")
    assert pipe.unet.layout == "NHWC"
    monkeypatch.setenv("MDU_UNET_LAYOUT", "NWHC")
    with pytest.raises(ValueError, match="MDU_UNET_LAYOUT"):
        load_single_file(env["ckpt"], device="cpu")


def test_interrupted_run_says_so(env, monkeypatch, tmp_path):
    """A pipeline flagged as the CLI registers it: every step runs no UNet,
    the image is still saved, and its infotext carries "Interrupted": true,
    as the JAX CLI's ``_with_prompt`` writes it."""
    _feed_jax_noise(monkeypatch)

    def flag(pipe):
        pipe.interrupted = True
        cli._INTERRUPT["pipe"] = pipe

    monkeypatch.setattr(cli, "_graceful_interrupt", flag)
    path = str(tmp_path / "int.png")
    cli.main(RUNS["txt2img"] + ["--model-dir", env["ckpt"], "--out", path, "--device", "cpu"])
    info = json.loads(image_text(path)["parameters"])
    assert info["Interrupted"] is True
    jargs = argparse.Namespace(prompt="p", negative="n", _pipe=argparse.Namespace(
        interrupted=True))
    assert jcli._with_prompt(jargs, {})["Interrupted"] is True
    cli._INTERRUPT["pipe"] = None


def test_sigint_handler_first_flags_second_raises(monkeypatch):
    """The plain handler: the first SIGINT sets ``interrupted``, the second
    raises KeyboardInterrupt."""
    import signal

    installed = {}
    monkeypatch.setattr(signal, "signal", lambda sig, h: installed.setdefault(sig, h))
    try:
        INSTALL_SIGINT()
        handler = installed[signal.SIGINT]
        with pytest.raises(KeyboardInterrupt):       # no pipeline registered yet
            handler(signal.SIGINT, None)
        pipe = argparse.Namespace(interrupted=False)
        cli._graceful_interrupt(pipe)
        handler(signal.SIGINT, None)
        assert pipe.interrupted is True
        with pytest.raises(KeyboardInterrupt):
            handler(signal.SIGINT, None)
    finally:
        cli._INTERRUPT["pipe"] = None


def test_help_lists_the_jax_flags_and_defaults():
    """Every subcommand, and every flag with its default, of the JAX CLI;
    ``--device`` is the port's only addition."""
    jparser = {}

    def grab(argv):
        import sys as _sys

        saved = _sys.argv
        try:
            jcli.main(argv)
        except SystemExit:
            pass
        finally:
            _sys.argv = saved

    pparser = cli.build_parser()
    psub = next(a for a in pparser._actions if isinstance(a, argparse._SubParsersAction))
    orig = argparse.ArgumentParser.parse_args

    def capture(self, *a, **k):
        jparser["p"] = self
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = capture
    try:
        grab(["info", "x"])
    finally:
        argparse.ArgumentParser.parse_args = orig
    jsub = next(a for a in jparser["p"]._actions if isinstance(a, argparse._SubParsersAction))
    assert list(psub.choices) == list(jsub.choices) == ["txt2img", "img2img", "demofusion",
                                                         "info", "vae-roundtrip"]
    for name, jp in jsub.choices.items():
        pp = psub.choices[name]
        jd = {a.dest: (a.default, a.option_strings, a.choices) for a in jp._actions}
        pd = {a.dest: (a.default, a.option_strings, a.choices) for a in pp._actions}
        assert set(pd) - set(jd) <= {"device"}, name
        for dest, spec in jd.items():
            assert pd[dest] == spec, (name, dest)
