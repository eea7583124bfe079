"""Port parity for regional prompt control: the region specs and their JSON,
the region-seeded noise, the plan's grid and region weights under
MultiDiffusion and Mixture of Diffusers, the tiled denoiser with BACKGROUND
and FOREGROUND regions (unrolled and under ``MDU_FUSED_BLEND``), and the
tiny txt2img with regions and a tiny img2img on "DPM++ 2M Karras" against
``mdu_tpu``, fed the JAX package's composed noise.
Tolerance: atol 1e-6 x max|ref| for the combinator, 1e-4 x max|ref| for the
pipelines (fp32 on both sides, JAX at 'highest')."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdu_tpu.config as jcfg
from mdu_tpu.models import AutoencoderKL as JaxVAE
from mdu_tpu.models import UNet2DCondition as JaxUNet
from mdu_tpu.models import random_params
from mdu_tpu.models import tiny_unet_config as jax_tiny_unet
from mdu_tpu.models import tiny_vae_config as jax_tiny_vae
from mdu_tpu.pipeline import DiffusionPipeline as JaxPipeline
from mdu_tpu.tiling import regions as jregions
from mdu_tpu.tiling.schedulers import make_tiled_denoiser as jax_make_tiled_denoiser
from mdu_tpu.tiling.schedulers import plan_tiled_diffusion as jax_plan
from mdu_tpu.utils import bbox as jbbox
from mdu_tpu_torch import DiffusionPipeline, Method, SamplerConfig, TiledDiffusionConfig
from mdu_tpu_torch import config as pcfg
from mdu_tpu_torch.models import (AutoencoderKL, UNet2DCondition, load_jax_params,
                                  tiny_unet_config, tiny_vae_config)
from mdu_tpu_torch.tiling import regions
from mdu_tpu_torch.tiling.schedulers import make_tiled_denoiser, plan_tiled_diffusion
from mdu_tpu_torch.utils.bbox import BlendMode, RegionSpec

torch.set_num_threads(2)
FG = BlendMode.FOREGROUND


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def jspec(r: RegionSpec) -> jbbox.RegionSpec:
    """The JAX package's RegionSpec with the same fields."""
    d = dataclasses.asdict(r)
    d["blend_mode"] = jbbox.BlendMode(r.blend_mode.value)
    return jbbox.RegionSpec(**d)


# relative specs at the edges: on the border, past it, empty, negative, a size
# whose ceil overflows the canvas, and ordinary BACKGROUND / FOREGROUND ones
EDGE_SPECS = [RegionSpec(0.0, 0.0, 1.0, 1.0), RegionSpec(1.0, 1.0, 0.5, 0.5),
              RegionSpec(1.01, 0.0, 0.2, 0.2), RegionSpec(0.0, 1.2, 0.2, 0.2),
              RegionSpec(0.2, 0.2, 0.0, 0.3), RegionSpec(0.2, 0.2, 0.3, -0.1),
              RegionSpec(-0.1, -0.2, 0.5, 0.5), RegionSpec(0.33, 0.71, 0.7, 0.31, seed=3),
              RegionSpec(0.5, 0.0, 0.5, 0.5, "a", "b", FG, 1.7, 9),
              RegionSpec(0.13, 0.27, 0.41, 0.29, blend_mode=FG, feather_ratio=-0.2)]


@pytest.mark.parametrize("w,h", [(24, 16), (192, 192), (37, 21)])
def test_region_specs_match_jax(w, h):
    for r in EDGE_SPECS:
        jr = jspec(r)
        assert r.validate() == jr.validate()
        got, want = r.to_bbox(w, h), jr.to_bbox(w, h)
        assert (got.x, got.y, got.w, got.h) == (want.x, want.y, want.w, want.h)
        assert (got.feather_ratio, got.seed, got.prompt, got.blend_mode.value) == \
            (want.feather_ratio, want.seed, want.prompt, want.blend_mode.value)
    # floor for the origin, ceil for the size, clamped into the canvas
    b = RegionSpec(0.33, 0.71, 0.7, 0.31).to_bbox(w, h)
    assert (b.x, b.y) == (int(0.33 * w), int(0.71 * h))
    assert b.x + b.w <= w and b.y + b.h <= h


def test_region_json_round_trip_matches_jax():
    specs = [r for r in EDGE_SPECS if r.validate()]
    text = pcfg.regions_to_json(specs)
    assert text == jcfg.regions_to_json([jspec(r) for r in specs])
    back = pcfg.regions_from_json(text)
    want = jcfg.regions_from_json(text)
    assert [dataclasses.asdict(r) for r in back] == [dataclasses.asdict(r) for r in want]
    assert pcfg.regions_from_json(pcfg.regions_to_json(back)) == back
    info = {"Tiled Diffusion": {"Region control": json.loads(text)}}
    assert pcfg.regions_from_png_info(info) == back
    assert pcfg.regions_from_png_info({}) == []


TWELVE = [RegionSpec(i / 20, i / 50, 0.3, 0.25, prompt=f"p{i}", seed=i) for i in range(12)]


def test_region_json_keeps_the_order_of_twelve_regions():
    """"Region 10" .. "Region 12" come after "Region 9": the port reads the
    keys in the order of N, so a reloaded config of ten or more regions
    pairs region i with region_conds[i] as it was saved."""
    text = pcfg.regions_to_json(TWELVE)
    assert pcfg.regions_from_json(text) == TWELVE
    shuffled = json.dumps(dict(reversed(list(json.loads(text).items()))))
    assert pcfg.regions_from_json(shuffled) == TWELVE
    info = {"Tiled Diffusion": {"Region control": json.loads(text)}}
    assert [r.prompt for r in pcfg.regions_from_png_info(info)] == [f"p{i}" for i in range(12)]


def test_jax_region_json_reorders_twelve_regions():
    """The JAX package sorts the keys as strings (a known fault it keeps):
    its twelve regions come back as p0, p9, p10, p11, p1, ..., p8, and the
    port's differ from them."""
    text = jcfg.regions_to_json([jspec(r) for r in TWELVE])
    got = [r.prompt for r in jcfg.regions_from_json(text)]
    assert got == ["p0", "p9", "p10", "p11"] + [f"p{i}" for i in range(1, 9)]
    assert [r.prompt for r in pcfg.regions_from_json(text)] != got


@pytest.mark.parametrize("case", ["bg_overlap", "fg_over_bg", "batch"])
def test_compose_region_noise_matches_jax(case, monkeypatch):
    """The composition with the port's own patches injected into the JAX
    package's (each region's patch from a torch.Generator of its seed):
    BACKGROUND patches averaged where they overlap, FOREGROUND ones on top,
    averaged among themselves."""
    B = 2 if case == "batch" else 1
    base = np.random.default_rng(1).normal(size=(B, 4, 16, 24)).astype(np.float32)
    specs = {"bg_overlap": [RegionSpec(0.0, 0.0, 0.6, 1.0), RegionSpec(0.4, 0.25, 0.6, 0.5)],
             "fg_over_bg": [RegionSpec(0.0, 0.0, 0.6, 0.6),
                            RegionSpec(0.3, 0.3, 0.5, 0.5, blend_mode=FG),
                            RegionSpec(0.5, 0.4, 0.5, 0.6, blend_mode=FG),
                            RegionSpec(0.5, 0.5, 0.5, 0.5)],
             "batch": [RegionSpec(0.25, 0.0, 0.5, 1.0, blend_mode=FG)]}[case]
    seeds = [11, 12, 13, 14][:len(specs)]
    rbs = [r.to_bbox(24, 16) for r in specs]
    patches = [torch.randn((1, 4, r.h, r.w), generator=torch.Generator().manual_seed(s))
               for r, s in zip(rbs, seeds)]
    calls = iter(patches)
    monkeypatch.setattr(jregions.jax.random, "normal",
                        lambda key, shape, dtype: jnp.asarray(next(calls).numpy()))
    want = jregions.compose_region_noise(jnp.asarray(base), [jspec(r).to_bbox(24, 16)
                                                             for r in specs], seeds)
    got = regions.compose_region_noise(torch.from_numpy(base), rbs, seeds)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert regions.compose_region_noise(torch.from_numpy(base), [], []) is not None


def test_resolve_seed():
    gen = torch.Generator().manual_seed(4)
    assert regions.resolve_seed(77, gen) == 77
    s1 = regions.resolve_seed(-1, torch.Generator().manual_seed(4))
    s2 = regions.resolve_seed(None, torch.Generator().manual_seed(4))
    assert s1 == s2 and 0 <= s1 < 2**31 - 1
    assert regions.resolve_seed(-1, torch.Generator().manual_seed(5)) != s1


PLAN_REGIONS = [RegionSpec(0.0, 0.0, 0.5, 1.0, seed=1), RegionSpec(0.3, 0.2, 0.4, 0.5, seed=2),
                RegionSpec(0.25, 0.5, 0.5, 0.5, blend_mode=FG, feather_ratio=0.3),
                RegionSpec(1.5, 0.0, 0.2, 0.2)]                      # invalid: dropped


@pytest.mark.parametrize("method", [Method.MULTI_DIFF, Method.MIX_DIFF])
@pytest.mark.parametrize("draw_background", [True, False])
def test_region_plan_matches_jax(method, draw_background):
    got = plan_tiled_diffusion(method, 16, 32, 16, 16, 8, tile_bs=2, regions=PLAN_REGIONS,
                               draw_background=draw_background)
    want = jax_plan(method, 16, 32, 16, 16, 8, tile_bs=2,
                    regions=[jspec(r) for r in PLAN_REGIONS],
                    draw_background=draw_background)
    assert got.draw_background == want.draw_background == draw_background
    assert [(b.x, b.y, b.w, b.h) for b in got.bboxes] == \
        [(b.x, b.y, b.w, b.h) for b in want.bboxes]
    assert [len(b) for b in got.batched] == [len(b) for b in want.batched]
    assert [(r.x, r.y, r.w, r.h, r.blend_mode.value) for r in got.regions] == \
        [(r.x, r.y, r.w, r.h, r.blend_mode.value) for r in want.regions]
    assert len(got.regions) == 3
    np.testing.assert_array_equal(got.weights, want.weights)
    for a, b in zip(got.region_weights, want.region_weights):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    if not draw_background:
        assert got.bboxes == () and got.weights[0, 0, 0, -1] == 0.0
    # without a region the grid is always drawn
    bare = plan_tiled_diffusion(method, 16, 32, 16, 16, 8, draw_background=False)
    assert bare.draw_background and len(bare.bboxes) == 3


def test_max_regions(monkeypatch, capsys):
    """MDU_MAX_REGIONS keeps the first valid regions, with a warning; a
    region over a quarter of the canvas warns too."""
    monkeypatch.setenv("MDU_MAX_REGIONS", "2")
    got = plan_tiled_diffusion(Method.MULTI_DIFF, 16, 32, 16, 16, 8, regions=PLAN_REGIONS)
    assert "exceeds MDU_MAX_REGIONS=2" in capsys.readouterr().err
    want = jax_plan(Method.MULTI_DIFF, 16, 32, 16, 16, 8,
                    regions=[jspec(r) for r in PLAN_REGIONS])
    assert "exceeds MDU_MAX_REGIONS=2" in capsys.readouterr().err
    assert [(r.x, r.y, r.w, r.h) for r in got.regions] == \
        [(r.x, r.y, r.w, r.h) for r in want.regions] == [(0, 0, 16, 16), (9, 3, 13, 8)]
    monkeypatch.delenv("MDU_MAX_REGIONS")
    plan_tiled_diffusion(Method.MULTI_DIFF, 16, 32, 16, 16, 8, regions=PLAN_REGIONS[:1])
    assert "covers 50% of the canvas" in capsys.readouterr().err


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("method", [Method.MULTI_DIFF, Method.MIX_DIFF])
@pytest.mark.parametrize("draw_background", [True, False])
def test_region_combinator_matches_jax(rng, monkeypatch, method, fused, draw_background):
    """Toy tile and region denoisers through the combinator: BACKGROUND
    regions added into the canvas (MoD: weighted by gaussian x 1/sum(w)),
    FOREGROUND regions feather-blended after MultiDiffusion's divide; under
    MDU_FUSED_BLEND the port's plain version of #5 against the JAX
    package's interpret mode, the region adds after it."""
    if fused:
        monkeypatch.setenv("MDU_FUSED_BLEND", "interp")
    x = rng.normal(size=(2, 4, 16, 32)).astype(np.float32)
    kw = dict(tile_bs=2, draw_background=draw_background)
    plan = plan_tiled_diffusion(method, 16, 32, 16, 16, 8, regions=PLAN_REGIONS, **kw)
    jplan = jax_plan(method, 16, 32, 16, 16, 8, regions=[jspec(r) for r in PLAN_REGIONS], **kw)

    def tile_j(flat, sigma, step, bboxes, batch_i):
        return jnp.sin(flat) * sigma + 0.1 * batch_i + 0.01 * bboxes[0].x

    def tile_t(flat, sigma, step, bboxes, batch_i):
        return torch.sin(flat) * sigma + 0.1 * batch_i + 0.01 * bboxes[0].x

    def region_j(xr, sigma, step, i):
        return jnp.cos(xr) * sigma - 0.2 * i

    def region_t(xr, sigma, step, i):
        return torch.cos(xr) * sigma - 0.2 * i

    want = jax_make_tiled_denoiser(jplan, tile_j, region_j)(jnp.asarray(x), jnp.float32(1.5), 0)
    got = make_tiled_denoiser(plan, tile_t, region_t)(torch.from_numpy(x), torch.tensor(1.5), 0)
    _close(got, want, rel=1e-6)
    with pytest.raises(ValueError, match="region_denoise"):
        make_tiled_denoiser(plan, tile_t)


# ------------------------------------------------------------ the pipeline


@pytest.fixture(scope="module")
def pipes():
    ucfg = jax_tiny_unet()
    unet, vae = JaxUNet(ucfg), JaxVAE(jax_tiny_vae())
    up = random_params(unet, 0, jnp.zeros((1, 4, 16, 16)), jnp.zeros((1,)),
                       jnp.zeros((1, 7, ucfg.cross_attention_dim)))
    vp = random_params(vae, 1, jnp.zeros((1, 3, 64, 64)), jax.random.PRNGKey(0))
    jpipe = JaxPipeline(unet, up, vae, vp)
    to_np = lambda p: jax.tree.map(np.asarray, p)            # noqa: E731
    port = DiffusionPipeline(
        load_jax_params(UNet2DCondition(tiny_unet_config()), to_np(up)),
        load_jax_params(AutoencoderKL(tiny_vae_config()), to_np(vp)), device="cpu")
    conds = [np.asarray(jax.random.normal(jax.random.PRNGKey(k), (1, 7, 16))) * 0.1
             for k in range(4)]
    return jpipe, port, [{"crossattn": c} for c in conds]


def _j(c):
    return None if c is None else {k: jnp.asarray(v) for k, v in c.items()}


# a 16 x 32 latent: 3 grid tiles of 16 at overlap 8 in one batch; a BACKGROUND
# region over the left half (16 x 16) and a FOREGROUND one (16 x 8, feathered)
PIPE_REGIONS = [RegionSpec(0.0, 0.0, 0.5, 1.0, seed=111),
                RegionSpec(0.25, 0.5, 0.5, 0.5, blend_mode=FG, feather_ratio=0.3, seed=222)]


def _jax_region_noise(seed, shape, jplan, seeds):
    noise = jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32)
    return np.array(jregions.compose_region_noise(noise, jplan.regions, seeds))


@pytest.mark.parametrize("method,sampler,draw_background", [
    (Method.MULTI_DIFF, "Euler", True), (Method.MIX_DIFF, "DPM++ 2M", False)])
def test_tiny_regional_txt2img_matches_jax(pipes, method, sampler, draw_background):
    """256 x 128 px, 3 steps at CFG 7: both regions through the tiny UNet (the
    FOREGROUND one without an uncond: no CFG), under MultiDiffusion after the
    grid, under Mixture of Diffusers without it (the combinator's test holds
    MoD's grid and regions together), fed the JAX package's composed noise;
    the info names the regions and their seeds."""
    jpipe, port, conds = pipes
    kw = dict(method=method, tile_w=16, tile_h=16, overlap=8, tile_bs=3,
              draw_background=draw_background)
    td_j = jcfg.TiledDiffusionConfig(**kw, regions=[jspec(r) for r in PIPE_REGIONS])
    td_t = TiledDiffusionConfig(**kw, regions=list(PIPE_REGIONS))
    rc = [(conds[2], conds[1]), (conds[3], None)]
    res_j = jpipe.txt2img(_j(conds[0]), _j(conds[1]), width=256, height=128,
                          sampler=jcfg.SamplerConfig(name=sampler, steps=3), seed=42,
                          tiled_diffusion=td_j, region_conds=[(_j(a), _j(b)) for a, b in rc],
                          decode=False)
    jplan = jax_plan(method, 16, 32, 16, 16, 8, tile_bs=3, regions=td_j.regions,
                     draw_background=draw_background)
    noise = _jax_region_noise(42, (1, 4, 16, 32), jplan, [111, 222])
    res_t = port._txt2img_from_noise(noise, conds[0], conds[1],
                                     SamplerConfig(name=sampler, steps=3), 42, td_t,
                                     decode=False, region_conds=rc, region_seeds=[111, 222])
    _close(res_t.latents, res_j.latents)
    assert res_t.info == res_j.info
    assert res_t.info["Tiled Diffusion"]["Region control"]["Region 2"]["seed"] == 222
    assert pcfg.regions_from_png_info(res_t.info) == PIPE_REGIONS


def test_tiny_img2img_karras_matches_jax(pipes):
    """img2img from given latents (16 x 32) on "DPM++ 2M Karras", 5 steps at
    denoise 0.6 (3 steps on the Karras schedule), MultiDiffusion over 3
    tiles, fed the JAX package's sampling noise."""
    jpipe, port, conds = pipes
    kw = dict(tile_w=16, tile_h=16, overlap=8, tile_bs=3)
    sp = dict(name="DPM++ 2M Karras", steps=5, denoising_strength=0.6)
    lat = np.random.default_rng(9).normal(size=(1, 4, 16, 32)).astype(np.float32)
    res_j = jpipe.img2img(None, _j(conds[0]), _j(conds[1]), sampler=jcfg.SamplerConfig(**sp),
                          seed=7, init_latents=jnp.asarray(lat),
                          tiled_diffusion=jcfg.TiledDiffusionConfig(**kw), decode=False)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(7), (1, 4, 16, 32), jnp.float32))
    res_t = port._img2img_from_noise(None, None, noise, conds[0], conds[1],
                                     SamplerConfig(**sp), 7, TiledDiffusionConfig(**kw),
                                     init_latents=lat, decode=False)
    _close(res_t.latents, res_j.latents)
    assert res_t.info == res_j.info and res_t.info["Sampler"] == "DPM++ 2M Karras"


def test_regional_entry_points_run_on_cpu(pipes):
    """txt2img and img2img with a random region seed and a stochastic sampler
    on the CPU: the seed resolves the same way twice, and the image is
    reproducible from the seed."""
    _, port, conds = pipes
    td = TiledDiffusionConfig(tile_w=16, tile_h=16, overlap=8, tile_bs=3,
                              regions=[RegionSpec(0.5, 0.0, 0.5, 1.0, seed=-1)])
    kw = dict(width=256, height=128, sampler=SamplerConfig(name="Euler a", steps=2), seed=3,
              tiled_diffusion=td, region_conds=[(conds[2], conds[1])], decode=False)
    a = port.txt2img(conds[0], conds[1], **kw)
    b = port.txt2img(conds[0], conds[1], **kw)
    torch.testing.assert_close(a.latents, b.latents, rtol=0, atol=0)
    seed = a.info["Tiled Diffusion"]["Region control"]["Region 1"]["seed"]
    assert seed != -1 and seed == b.info["Tiled Diffusion"]["Region control"]["Region 1"]["seed"]
    lat = np.random.default_rng(2).normal(size=(1, 4, 16, 32)).astype(np.float32)
    res = port.img2img(None, conds[0], conds[1], sampler=SamplerConfig(name="DPM++ SDE",
                                                                       steps=3),
                       seed=3, tiled_diffusion=td, region_conds=[(conds[2], None)],
                       init_latents=lat, decode=False)
    assert torch.isfinite(res.latents).all()
    assert res.info["Tiled Diffusion"]["Region control"]["Region 1"]["seed"] == seed
    with pytest.raises(ValueError, match="region_conds"):
        port.txt2img(conds[0], conds[1], **{**kw, "region_conds": []})
    # per-region UNet weights: the UNet's own state_dict gives the same image
    # as none (within 1e-5 x max: on the CPU, oneDNN takes another path for
    # weights passed through functional_call); an unknown entry is refused
    own = port.txt2img(conds[0], conds[1], **kw, region_unet_params=[port.unet.state_dict()])
    _close(own.latents, a.latents, rel=1e-5)
    with pytest.raises(KeyError, match="does not have"):
        port.txt2img(conds[0], conds[1], **kw, region_unet_params=[{"no.such.weight": 0}])


def test_derived_seeds_are_distinct(pipes):
    """Four regions of seed -1 resolve to four seeds, and the samplers' noise
    on the CPU does not repeat the starting noise of the same seed (a CPU
    generator keeps only the low 32 bits of its seed)."""
    _, port, _ = pipes
    plan = plan_tiled_diffusion(Method.MULTI_DIFF, 16, 32, 16, 16, 8,
                                regions=[RegionSpec(x, y, 0.5, 0.5) for x in (0.0, 0.5)
                                         for y in (0.0, 0.5)])
    assert len(set(DiffusionPipeline._region_seeds(plan, 0))) == 4
    like = torch.zeros(1, 4, 8, 8)
    start = torch.randn(like.shape, generator=torch.Generator().manual_seed(0))
    assert not torch.equal(port._sampler_noise(None, 0)(like), start)


def test_jax_stochastic_karras_names_miss_their_key(pipes):
    """The JAX package's pipeline keys its stochastic set on the full name, so
    "Euler a Karras" is called without a key and fails; the port keys it on
    the name without " Karras" (``test_karras_names_dispatch_as_their_sampler``)."""
    jpipe, port, conds = pipes
    with pytest.raises(TypeError, match="key"):
        jpipe.txt2img(_j(conds[0]), _j(conds[1]), width=128, height=128,
                      sampler=jcfg.SamplerConfig(name="Euler a Karras", steps=2),
                      decode=False)
    res = port.txt2img(conds[0], conds[1], width=128, height=128,
                       sampler=SamplerConfig(name="Euler a Karras", steps=2), decode=False)
    assert torch.isfinite(res.latents).all()
