"""Port parity for the txt2img slice: tile geometry, fusion, per-tile conds,
schedule and samplers, and the whole tiny tiled txt2img plus the exact tiled
decode against ``mdu_tpu``, fed the same noise. Also the import guard: the
port never imports JAX or the JAX package."""
import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdu_tpu.config as jcfg
from mdu_tpu.models import AutoencoderKL as JaxVAE
from mdu_tpu.models import UNet2DCondition as JaxUNet
from mdu_tpu.models import random_params
from mdu_tpu.models import tiny_vae_config as jax_tiny_vae
from mdu_tpu.models.unet import UNetConfig as JaxUNetConfig
from mdu_tpu.ops import fusion as jfusion
from mdu_tpu.pipeline import DiffusionPipeline as JaxPipeline
from mdu_tpu.samplers import samplers as jsamplers
from mdu_tpu.samplers.schedule import NoiseSchedule as JaxSchedule
from mdu_tpu.tiling import conds as jconds
from mdu_tpu.tiling import tiled_vae as jtvae
from mdu_tpu.tiling.schedulers import plan_tiled_diffusion as jax_plan
from mdu_tpu.utils import grid as jgrid
from mdu_tpu_torch import (DiffusionPipeline, Method, SamplerConfig,
                           TiledDiffusionConfig, TiledVAEConfig)
from mdu_tpu_torch.models import AutoencoderKL, UNet2DCondition, load_jax_params, tiny_vae_config
from mdu_tpu_torch.models.unet import UNetConfig
from mdu_tpu_torch.ops import fusion
from mdu_tpu_torch.samplers import samplers
from mdu_tpu_torch.samplers.schedule import NoiseSchedule
from mdu_tpu_torch.tiling import conds, tiled_vae
from mdu_tpu_torch.tiling.schedulers import plan_tiled_diffusion
from mdu_tpu_torch.utils import grid

torch.set_num_threads(2)
# a two-level UNet (the tiny config's first level and its mid-block): JAX
# compiles the pipelines in about half the four-level one's time
TWO_LEVELS = dict(block_out_channels=(8, 16), cross_attention_dim=16, num_heads=2,
                  transformer_layers=(1, 0), norm_num_groups=4)
REPO = Path(__file__).resolve().parents[1]

# (w, h, tile_w, tile_h, overlap): config 2's latent canvas first
CANVASES = [(256, 64, 96, 96, 48), (40, 16, 16, 16, 8), (97, 61, 32, 24, 16),
            (20, 20, 32, 32, 8), (130, 33, 48, 48, 100)]


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _boxes(bbs):
    return [(b.x, b.y, b.w, b.h) for b in bbs]


# ---------------------------------------------------------------- geometry


@pytest.mark.parametrize("w,h,tw,th,ov", CANVASES)
def test_grid_matches_jax(w, h, tw, th, ov):
    assert grid.clamp_overlap(tw, th, ov) == jgrid.clamp_overlap(tw, th, ov)
    ov = grid.clamp_overlap(tw, th, ov)
    assert grid.splitable(w, h, tw, th, ov) == jgrid.splitable(w, h, tw, th, ov)
    got, want = grid.split_grid(w, h, tw, th, ov), jgrid.split_grid(w, h, tw, th, ov)
    assert _boxes(got) == _boxes(want)
    np.testing.assert_array_equal(grid.paint_count(w, h, got), jgrid.paint_count(w, h, want))
    assert grid.paint_count(w, h, got).min() >= 1          # every pixel painted
    for bs in (1, 3, 8):
        assert ([_boxes(b) for b in grid.batch_bboxes(got, bs)]
                == [_boxes(b) for b in jgrid.batch_bboxes(want, bs)])


@pytest.mark.parametrize("w,h,tw,th,ov", CANVASES)
def test_plan_matches_jax(w, h, tw, th, ov):
    got = plan_tiled_diffusion(Method.MULTI_DIFF, h, w, th, tw, ov, tile_bs=3)
    want = jax_plan(jcfg.Method.MULTI_DIFF, h, w, th, tw, ov, tile_bs=3)
    assert (got.tile_h, got.tile_w, got.overlap) == (want.tile_h, want.tile_w, want.overlap)
    assert _boxes(got.bboxes) == _boxes(want.bboxes)
    assert [_boxes(b) for b in got.batched] == [_boxes(b) for b in want.batched]
    np.testing.assert_array_equal(got.weights, want.weights)


def test_config2_geometry():
    """2048 x 512 px: 5 tiles of 64 x 96 latent in one UNet batch."""
    plan = plan_tiled_diffusion(Method.MULTI_DIFF, 64, 256, 96, 96, 48, tile_bs=8)
    assert (plan.tile_h, plan.tile_w, len(plan.bboxes), plan.num_batches) == (64, 96, 5, 1)
    vplan = tiled_vae.plan_vae_tiles(64, 256, 128, tiled_vae.DECODER_PAD)
    assert (vplan.num_tiles, vplan.in_h, vplan.in_w) == (2, 64, 150)


@pytest.mark.parametrize("h,w,tile", [(64, 256, 128), (16, 40, 16), (70, 33, 16),
                                      (20, 20, 16)])
def test_vae_plan_matches_jax(h, w, tile):
    got = tiled_vae.plan_vae_tiles(h, w, tile, tiled_vae.DECODER_PAD)
    want = jtvae.plan_vae_tiles(h, w, tile, jtvae.DECODER_PAD)
    if want is None:
        assert got is None
        return
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    np.testing.assert_array_equal(got.local_masks(), want.local_masks())


# ------------------------------------------------------------ fusion, conds


def test_fusion_matches_jax(rng):
    bbs = grid.split_grid(40, 16, 16, 16, 8)
    jbbs = jgrid.split_grid(40, 16, 16, 16, 8)
    x = rng.normal(size=(2, 4, 16, 40)).astype(np.float32)
    tiles_t = fusion.gather_tiles(torch.from_numpy(x), bbs)
    tiles_j = jfusion.gather_tiles(jnp.asarray(x), jbbs)
    np.testing.assert_array_equal(tiles_t.numpy(), np.asarray(tiles_j))
    out = rng.normal(size=tiles_t.shape).astype(np.float32)
    w = grid.paint_count(40, 16, bbs)
    got = fusion.weighted_average(
        fusion.scatter_add_tiles(torch.zeros(2, 4, 16, 40), torch.from_numpy(out), bbs),
        torch.from_numpy(w))
    want = jfusion.weighted_average(
        jfusion.scatter_add_tiles(jnp.zeros((2, 4, 16, 40)), jnp.asarray(out), jbbs),
        jnp.asarray(w))
    _close(got, want, rel=1e-6)


def test_tile_cond_matches_jax(rng):
    bbs = grid.split_grid(40, 16, 16, 16, 8)[1:3]
    jbbs = jgrid.split_grid(40, 16, 16, 16, 8)[1:3]
    cond = {"crossattn": rng.normal(size=(1, 7, 16)).astype(np.float32),
            "concat": rng.normal(size=(1, 2, 16, 40)).astype(np.float32),
            "hint": rng.normal(size=(1, 3, 128, 320)).astype(np.float32)}
    got = conds.tile_cond({k: torch.from_numpy(v) for k, v in cond.items()}, bbs, (16, 40))
    want = jconds.tile_cond({k: jnp.asarray(v) for k, v in cond.items()}, jbbs, (16, 40))
    for k in cond:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    both = conds.concat_conds(got, got)
    assert both["crossattn"].shape == (4, 7, 16)


# ----------------------------------------------------- schedule, samplers


def test_schedule_matches_jax():
    js, ps = JaxSchedule(), NoiseSchedule()
    np.testing.assert_array_equal(ps.sampling_sigmas(20), js.sampling_sigmas(20))
    sig = np.concatenate([ps.sampling_sigmas(7)[:-1], [1e-4, 0.02, 50.0, 14.6146]])
    sig = sig.astype(np.float32)
    want = np.asarray(js.t_for_sigma(jnp.asarray(sig)))
    got = ps.t_for_sigma(torch.from_numpy(sig)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    assert got[-5] == 0.0 and got[-2] == 999.0            # clamped at both ends


@pytest.mark.parametrize("name", ["Euler", "DDIM"])
def test_samplers_match_jax_on_toy_denoiser(rng, name):
    x = rng.normal(size=(1, 4, 6, 6)).astype(np.float32) * 14.6
    sig = NoiseSchedule().sampling_sigmas(5)
    jfn = {"Euler": jsamplers.sample_euler, "DDIM": jsamplers.sample_ddim}[name]
    want = jfn(lambda x, s, i: x * 0.5 / (1 + s) + 0.1 * i, jnp.asarray(x), jnp.asarray(sig))
    got = samplers.get_sampler(name)(lambda x, s, i: x * 0.5 / (1 + s) + 0.1 * i,
                                     torch.from_numpy(x), torch.from_numpy(sig))
    _close(got, want, rel=1e-5)


# -------------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def pipes():
    ucfg = JaxUNetConfig(**TWO_LEVELS)
    unet, vae = JaxUNet(ucfg), JaxVAE(jax_tiny_vae())
    up = random_params(unet, 0, jnp.zeros((1, 4, 16, 16)), jnp.zeros((1,)),
                       jnp.zeros((1, 7, ucfg.cross_attention_dim)))
    vp = random_params(vae, 1, jnp.zeros((1, 3, 64, 64)), jax.random.PRNGKey(0))
    jpipe = JaxPipeline(unet, up, vae, vp)
    to_np = lambda p: jax.tree.map(np.asarray, p)            # noqa: E731
    port = DiffusionPipeline(
        load_jax_params(UNet2DCondition(UNetConfig(**TWO_LEVELS)), to_np(up)),
        load_jax_params(AutoencoderKL(tiny_vae_config()), to_np(vp)),
        device="cpu")
    c = {"crossattn": np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, 7, 16))) * 0.1}
    u = {"crossattn": np.asarray(jax.random.normal(jax.random.PRNGKey(1), (1, 7, 16))) * 0.1}
    return jpipe, port, c, u


TV = dict(decoder_tile_size=16, fast_decoder=False)


@pytest.mark.parametrize("name,deterministic", [("Euler", True), ("DDIM", False)])
def test_tiny_tiled_txt2img_matches_jax(pipes, name, deterministic):
    """320 x 128 px: 4 tiles of 16 x 16 latent in batches of 2 (padded to
    tile_bs 3 when deterministic), 3 steps at CFG 7, then the exact tiled
    lockstep decode (2 tiles)."""
    jpipe, port, c, u = pipes
    kw = dict(method=Method.MULTI_DIFF, tile_w=16, tile_h=16, overlap=8, tile_bs=3,
              deterministic=deterministic)
    res_j = jpipe.txt2img({k: jnp.asarray(v) for k, v in c.items()},
                          {k: jnp.asarray(v) for k, v in u.items()},
                          width=320, height=128,
                          sampler=jcfg.SamplerConfig(name=name, steps=3), seed=42,
                          tiled_diffusion=jcfg.TiledDiffusionConfig(**kw), decode=False)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(42), (1, 4, 16, 40)))
    res_t = port._txt2img_from_noise(noise, c, u, SamplerConfig(name=name, steps=3),
                                     42, TiledDiffusionConfig(**kw), decode=False)
    _close(res_t.latents, res_j.latents)
    assert res_t.info["Tiled Diffusion"] == res_j.info["Tiled Diffusion"]

    lat = np.array(res_j.latents)
    want = np.asarray(jpipe._decode_tensor(jnp.asarray(lat), jcfg.TiledVAEConfig(**TV)))
    got = port._decode_tensor(torch.from_numpy(lat), TiledVAEConfig(**TV))
    assert got.shape == (1, 3, 128, 320)
    _close(got, want)
    img = port._decode(torch.from_numpy(lat), TiledVAEConfig(**TV))
    assert img.shape == (1, 128, 320, 3) and img.dtype == np.uint8


def test_txt2img_entry_point_runs_on_cpu_when_asked(pipes):
    _, port, c, u = pipes
    res = port.txt2img(c, u, width=320, height=128, sampler=SamplerConfig(steps=2),
                       seed=3, tiled_diffusion=TiledDiffusionConfig(
                           tile_w=16, tile_h=16, overlap=8, tile_bs=4),
                       tiled_vae=TiledVAEConfig(**TV))
    assert res.images.shape == (1, 128, 320, 3)
    assert torch.isfinite(res.latents).all()


def test_pipeline_needs_cuda_unless_cpu_is_asked(pipes):
    _, port, _, _ = pipes
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        DiffusionPipeline(port.unet, port.vae)


def test_unported_features_raise(pipes):
    """No feature is left unported: step callbacks run (one call a step),
    DeepCache runs, image CFG asks for its image latent, an unknown upscaler
    is a KeyError, a guidance leaf on one side a ValueError, and a mesh
    without a 'tiles' axis the JAX package's ValueError (the mesh itself runs,
    ``tests/test_torch_mesh.py``)."""
    _, port, c, u = pipes
    tiny = dict(width=128, height=128, sampler=SamplerConfig(steps=1))
    seen = []
    port.txt2img(c, u, **tiny, step_callback=lambda i, x: seen.append(i), decode=False)
    assert seen == [0]
    res = port.txt2img(c, u, **{**tiny, "sampler": SamplerConfig(steps=2, deepcache=2)},
                       decode=False)
    assert torch.isfinite(res.latents).all()
    with pytest.raises(ValueError, match="image_cfg_scale"):
        port.txt2img(c, u, **{**tiny, "sampler": SamplerConfig(steps=1, image_cfg_scale=1.5)})
    # DemoFusion has its own entry point (the JAX planner would run the name
    # as MultiDiffusion)
    with pytest.raises(NotImplementedError, match="DiffusionPipeline.demofusion"):
        port.txt2img(c, u, **tiny, tiled_diffusion=TiledDiffusionConfig(
            method=Method.DEMO_FU, tile_w=8, tile_h=8, overlap=4))
    img = np.zeros((64, 64, 3), np.uint8)
    with pytest.raises(KeyError, match="R-ESRGAN"):
        port.img2img(img, c, u, sampler=SamplerConfig(steps=2, denoising_strength=0.5),
                     tiled_diffusion=TiledDiffusionConfig(upscaler="R-ESRGAN 4x+"))
    with pytest.raises(ValueError, match="guidance"):
        port.txt2img({**c, "guidance": np.zeros((1, 4, 16, 16), np.float32)}, u, **tiny)
    with pytest.raises(ValueError, match="tiles"):
        DiffusionPipeline(port.unet, port.vae, device="cpu", mesh=object())


def test_port_imports_no_jax():
    files = sorted(p for p in (REPO / "mdu_tpu_torch").rglob("*.py")
                   if "_build" not in p.parts) + [REPO / "chip_smoke.py"]
    files += sorted((REPO / "examples" / "torch").glob("*.py"))
    assert len(files) > 20
    assert REPO / "mdu_tpu_torch" / "parallel" / "training.py" in files
    assert REPO / "mdu_tpu_torch" / "ops" / "kernels" / "flash_bwd.py" in files
    assert REPO / "examples" / "torch" / "demofusion_x3.py" in files
    banned = ("jax", "jaxlib", "flax", "mdu_tpu", "safetensors")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [] if node.level else [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in banned, f"{path}: imports {name}"
