"""The tile mesh at inference (``mdu_tpu_torch/parallel/``, the sharded grid
of ``tiling/schedulers.py``, the pipeline's mesh branches and ``--devices``)
on the CPU, with meshes of 2 and 3 CPU shards (``make_tile_mesh(devices=
["cpu"] * n)``, the port's counterpart of the JAX tests' 8 virtual CPU
devices).

* The port's mesh against the port's single device, bitwise under
  ``deterministic`` (``tests/test_sharded_pipeline.py``'s rule): txt2img,
  MoD with regions, a scheduled cond, an AND cond, a canvas cond sliced per
  tile, img2img with noise inversion, batch 2 and DeepCache N = 2.
* The port's mesh against the JAX package's single device, at the parity
  bar of ``test_torch_pipeline.py`` (1e-4 x max), the sharded exact decode
  included; the sharded tile denoiser against ``mdu_tpu.parallel`` on its 8
  CPU devices (the one JAX mesh case), and the shards' pooled GroupNorm
  against ``mdu_tpu``'s pooled ``TileContext`` (2e-4 / 2e-5, the bars of
  ``tests/test_parallel.py``).
* The sharded decode and encode against the port's lockstep: within 1 uint8
  level, and moments within atol 2e-4, rtol 1e-4
  (``tests/test_sharded_pipeline.py:185,193``).
* The mesh guard, a failing shard, the memory-mode guard of the mesh decode,
  the fused blend (never on the mesh) and ``--devices 3`` with two devices.

Port-only cases run a two-level tiny UNet; the JAX side compiles one tiny
txt2img."""
import dataclasses
import sys
import threading

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
from mdu_tpu.ops.tile_context import TileContext as JaxTileContext
from mdu_tpu.ops.tile_context import tile_group_norm as jax_tile_group_norm
from mdu_tpu.parallel import make_sharded_tile_denoiser as jax_sharded_denoiser
from mdu_tpu.parallel import make_tile_mesh as jax_tile_mesh
from mdu_tpu.pipeline import DiffusionPipeline as JaxPipeline
from mdu_tpu.tiling.schedulers import plan_tiled_diffusion as jax_plan
from mdu_tpu_torch import (DemoFusionConfig, DiffusionPipeline, Method, SamplerConfig,
                           TiledDiffusionConfig, TiledVAEConfig)
from mdu_tpu_torch import pipeline as pipeline_mod
from mdu_tpu_torch.models import (AutoencoderKL, UNet2DCondition, load_jax_params,
                                  random_state_dict, tiny_vae_config)
from mdu_tpu_torch.models.unet import UNetConfig
from mdu_tpu_torch.ops.tile_context import TileContext, tile_group_norm
from mdu_tpu_torch.parallel import (TileMesh, make_sharded_tile_denoiser, make_tile_mesh,
                                    run_shards)
from mdu_tpu_torch.tiling import schedulers
from mdu_tpu_torch.tiling.schedulers import plan_tiled_diffusion
from mdu_tpu_torch.utils.bbox import BlendMode, RegionSpec

torch.set_num_threads(2)
TWO_LEVELS = dict(block_out_channels=(8, 16), cross_attention_dim=16, num_heads=2,
                  transformer_layers=(1, 0), norm_num_groups=4)
# 320 x 128 px: 4 tiles of 16 x 16 latent in batches of 2; 2 shards hold 2
# tiles each, 3 shards 2, 2 and the last tile twice
TD = TiledDiffusionConfig(method=Method.MULTI_DIFF, tile_w=16, tile_h=16, overlap=8,
                          tile_bs=2, deterministic=True)
TXT = dict(width=320, height=128, seed=42, decode=False)
MESHES = (2, 3)


def _cond(seed, dim=16, L=7):
    g = np.random.default_rng(seed)
    return {"crossattn": (g.normal(size=(1, L, dim)) * 0.1).astype(np.float32)}


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _pipes(unet, vae):
    """The pipeline on one device, then on meshes of 2 and 3 CPU shards."""
    return [DiffusionPipeline(unet, vae, device="cpu")] + [
        DiffusionPipeline(unet, vae, device="cpu", mesh=make_tile_mesh(devices=["cpu"] * n))
        for n in MESHES]


@pytest.fixture(scope="module")
def models():
    """The JAX two-level UNet and tiny VAE with their weights, and the port's
    modules with the same weights."""
    ucfg = JaxUNetConfig(**TWO_LEVELS)
    unet, vae = JaxUNet(ucfg), JaxVAE(jax_tiny_vae())
    up = random_params(unet, 0, jnp.zeros((1, 4, 16, 16)), jnp.zeros((1,)),
                       jnp.zeros((1, 7, 16)))
    vp = random_params(vae, 1, jnp.zeros((1, 3, 64, 64)), jax.random.PRNGKey(0))
    to_np = lambda p: jax.tree.map(np.asarray, p)            # noqa: E731
    port_unet = load_jax_params(UNet2DCondition(UNetConfig(**TWO_LEVELS)), to_np(up))
    port_vae = load_jax_params(AutoencoderKL(tiny_vae_config()), to_np(vp))
    return (unet, up, vae, vp), (port_unet, port_vae)


@pytest.fixture(scope="module")
def pipes(models):
    return _pipes(*models[1])


@pytest.fixture(scope="module")
def edit_pipes(models):
    """An 8-channel UNet (an image latent as its ``concat`` leaf), random
    weights drawn on the CPU."""
    unet = UNet2DCondition(UNetConfig(**TWO_LEVELS, in_channels=8))
    unet.load_state_dict(random_state_dict(unet, 3, device="cpu"))
    return _pipes(unet, models[1][1])


def _regions_case(pipe):
    regions = (RegionSpec(x=0.0, y=0.0, w=0.5, h=1.0, blend_mode=BlendMode.BACKGROUND),
               RegionSpec(x=0.5, y=0.0, w=0.25, h=0.5, blend_mode=BlendMode.FOREGROUND,
                          feather_ratio=0.3, seed=7))
    td = dataclasses.replace(TD, method=Method.MIX_DIFF, regions=regions)
    return pipe.txt2img(_cond(0), _cond(1), sampler=SamplerConfig(steps=3),
                        tiled_diffusion=td, region_conds=[(_cond(10), _cond(11)),
                                                          (_cond(12), _cond(13))], **TXT)


def _img2img_case(pipe):
    td = dataclasses.replace(TD, method=Method.MIX_DIFF, noise_inverse=True,
                             noise_inverse_steps=2, noise_inverse_renoise_strength=0.5)
    img = (np.random.default_rng(0).random((128, 320, 3)) * 255).astype(np.uint8)
    pipe.free_cache()
    return pipe.img2img(img, _cond(0), _cond(1), seed=1, decode=False, tiled_diffusion=td,
                        sampler=SamplerConfig(steps=4, denoising_strength=0.6))


def _canvas_case(pipe):
    """An image latent as the ``concat`` leaf of cond and uncond: cut to
    each tile on both paths."""
    lat = np.random.default_rng(8).normal(size=(1, 4, 16, 40)).astype(np.float32)
    return pipe.txt2img({**_cond(0), "concat": lat}, {**_cond(1), "concat": lat},
                        sampler=SamplerConfig(steps=3), tiled_diffusion=TD, **TXT)


CASES = {
    "txt2img": lambda p: p.txt2img(_cond(0), _cond(1), sampler=SamplerConfig(steps=3),
                                   tiled_diffusion=TD, **TXT),
    "mod_regions": _regions_case,
    "scheduled": lambda p: p.txt2img(
        {"__bank__": {"crossattn": np.concatenate([_cond(5)["crossattn"],
                                                   _cond(6)["crossattn"]])},
         "__index__": [0, 0, 1]}, _cond(1), sampler=SamplerConfig(steps=3),
        tiled_diffusion=TD, **TXT),
    "and": lambda p: p.txt2img({"__and__": [_cond(0), _cond(2)], "__weights__": (1.0, 0.6)},
                               _cond(1), sampler=SamplerConfig(steps=3), tiled_diffusion=TD,
                               **TXT),
    "canvas_cond": _canvas_case,
    "img2img_noise_inverse": _img2img_case,
    "batch2": lambda p: p.txt2img(_cond(0), _cond(1), sampler=SamplerConfig(steps=3),
                                  tiled_diffusion=TD, batch_size=2, **TXT),
    "deepcache": lambda p: p.txt2img(_cond(0), _cond(1), tiled_diffusion=TD,
                                     sampler=SamplerConfig(steps=3, deepcache=2), **TXT),
}


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_matches_single_device_bitwise(pipes, edit_pipes, case, monkeypatch):
    """2 and 3 shards give the single device's latents to the bit, through
    the sharded grid."""
    single, *meshes = edit_pipes if case == "canvas_cond" else pipes
    want = CASES[case](single).latents
    assert torch.isfinite(want).all()
    shards = []
    make = pipeline_mod.make_sharded_grid

    def counted(plan, mesh, *args):
        grid = make(plan, mesh, *args)
        return lambda *a: shards.append(mesh.tiles) or grid(*a)

    monkeypatch.setattr(pipeline_mod, "make_sharded_grid", counted)
    for pipe in meshes:
        torch.testing.assert_close(CASES[case](pipe).latents, want, rtol=0, atol=0)
    assert sorted(set(shards)) == list(MESHES)


def test_mesh_matches_jax(models):
    """2 shards against the JAX package's single device: MultiDiffusion
    txt2img fed JAX's noise, 3 Euler steps at CFG 7, then the sharded exact
    decode (2 tiles) against JAX's lockstep decode of the same latents."""
    (unet, up, vae, vp), _ = models
    jpipe = JaxPipeline(unet, up, vae, vp)
    _, mesh2, _ = _pipes(*models[1])
    kw = dict(method=Method.MULTI_DIFF, tile_w=16, tile_h=16, overlap=8, tile_bs=2,
              deterministic=True)
    res_j = jpipe.txt2img({"crossattn": jnp.asarray(_cond(0)["crossattn"])},
                          {"crossattn": jnp.asarray(_cond(1)["crossattn"])},
                          width=320, height=128, sampler=jcfg.SamplerConfig(steps=3),
                          seed=42, tiled_diffusion=jcfg.TiledDiffusionConfig(**kw),
                          decode=False)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(42), (1, 4, 16, 40)))
    res_t = mesh2._txt2img_from_noise(noise, _cond(0), _cond(1), SamplerConfig(steps=3), 42,
                                      TiledDiffusionConfig(**kw), decode=False)
    _close(res_t.latents, res_j.latents)
    tv = dict(decoder_tile_size=16, fast_decoder=False)
    lat = np.array(res_j.latents)
    want = np.asarray(jpipe._decode_tensor(jnp.asarray(lat), jcfg.TiledVAEConfig(**tv)))
    got = mesh2._decode_tensor(torch.from_numpy(lat), TiledVAEConfig(**tv))
    assert mesh2.last_vae_mode == "sharded"
    _close(got, want)


@pytest.mark.parametrize("method", [Method.MULTI_DIFF, Method.MIX_DIFF])
def test_sharded_tile_denoiser_matches_jax(rng, method):
    """``make_sharded_tile_denoiser`` on 3 CPU shards against
    ``mdu_tpu.parallel``'s on its 8 CPU devices, with a toy tile denoiser
    (``tests/test_parallel.py:22``)."""
    jplan = jax_plan(method, 64, 96, tile_h=32, tile_w=32, overlap=16,
                     tile_bs=2)
    plan = plan_tiled_diffusion(method, 64, 96, tile_h=32, tile_w=32, overlap=16, tile_bs=2)
    x = rng.normal(size=(1, 4, 64, 96)).astype(np.float32)
    want = jax.jit(jax_sharded_denoiser(jax_tile_mesh(8), jplan,
                                        lambda t, s: 2.0 * t + s))(
        jnp.asarray(x), jnp.asarray(0.5), jnp.asarray(0))
    got = make_sharded_tile_denoiser(make_tile_mesh(devices=["cpu"] * 3), plan,
                                     lambda t, s: 2.0 * t + s)(
        torch.from_numpy(x), torch.tensor(0.5), 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_pooled_group_norm_matches_jax(rng):
    """5 tiles on 3 shards (the last shard's second tile a padding tile that
    owns nothing): each shard's ``tile_group_norm`` pools over all shards
    through the mesh's all-reduce, as the JAX package's unsharded pooling
    does (``tests/test_parallel.py:44``); also under reference pooling."""
    T, C, h, w = 5, 8, 8, 8
    x = rng.normal(size=(T, C, h, w)).astype(np.float32) * 2 + 0.5
    masks = (rng.random((T, 1, h, w)) > 0.3).astype(np.float32)
    weight = rng.normal(size=(C,)).astype(np.float32)
    bias = rng.normal(size=(C,)).astype(np.float32)
    mesh = make_tile_mesh(devices=["cpu"] * 3)
    xp = np.concatenate([x, x[-1:]])
    mp = np.concatenate([masks, np.zeros_like(masks[:1])])
    for ref_pool in (False, True):
        want = jax_tile_group_norm(jnp.asarray(x), 4, jnp.asarray(weight), jnp.asarray(bias),
                                   JaxTileContext(T, (h, w), jnp.asarray(masks),
                                                  reference_pooling=ref_pool))

        def shard(d, dev, axis):
            part = slice(2 * d, 2 * d + 2)
            ctx = TileContext(2, (h, w), torch.from_numpy(mp[part]),
                              reference_pooling=ref_pool, axis=axis)
            return tile_group_norm(torch.from_numpy(xp[part]), 4, torch.from_numpy(weight),
                                   torch.from_numpy(bias), ctx)

        got = torch.cat(run_shards(mesh, shard))[:T]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("n", MESHES)
def test_sharded_vae_matches_lockstep(pipes, n):
    """The pipeline's exact decode and encode on the mesh against its
    lockstep on one device: within 1 uint8 level, moments within atol 2e-4,
    rtol 1e-4."""
    single, mesh = pipes[0], pipes[MESHES.index(n) + 1]
    tv = TiledVAEConfig(encoder_tile_size=96, decoder_tile_size=16, fast_decoder=False,
                        fast_encoder=False)
    z = torch.from_numpy(np.random.default_rng(3).normal(size=(1, 4, 24, 40))
                         .astype(np.float32) * 0.3)
    a, b = single._decode(z, tv), mesh._decode(z, tv)
    assert (single.last_vae_mode, mesh.last_vae_mode) == ("lockstep", "sharded")
    np.testing.assert_allclose(a.astype(np.int16), b.astype(np.int16), atol=1)
    img = np.random.default_rng(1).random((192, 320, 3)).astype(np.float32)
    x = torch.from_numpy(img.transpose(2, 0, 1)[None] * 2 - 1)
    ma, mb = single._encode(x, tv), mesh._encode(x, tv)
    assert mesh.last_vae_mode == "sharded"
    np.testing.assert_allclose(mb.numpy(), ma.numpy(), atol=2e-4, rtol=1e-4)


def test_mesh_decode_takes_the_memory_guard(pipes, monkeypatch, capsys):
    """Unlike the JAX package (``mdu_tpu/pipeline.py:1188-1189``), the mesh
    decode goes through the memory-mode guard: within the budget it runs
    sharded; over it, the exact streaming mode on the pipeline's device,
    which gives the single device's streamed image to the bit."""
    single, mesh = pipes[0], pipes[2]
    tv = TiledVAEConfig(decoder_tile_size=16, fast_decoder=False)
    z = torch.from_numpy(np.random.default_rng(4).normal(size=(1, 4, 24, 40))
                         .astype(np.float32) * 0.3)
    mesh._decode_tensor(z, tv)
    assert mesh.last_vae_mode == "sharded"
    monkeypatch.setenv("MDU_HBM_BYTES", str(2 ** 20))
    want = single._decode_tensor(z, tv)
    got = mesh._decode_tensor(z, tv)
    assert mesh.last_vae_mode == single.last_vae_mode != "sharded"
    assert "exact mode on one device" in capsys.readouterr().err
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("n_items,n_dev,bs,pad", [(5, 2, 2, True), (9, 2, 3, False),
                                                  (1, 2, 4, True), (8, 4, 2, False)])
def test_shard_walk(n_items, n_dev, bs, pad):
    """``schedulers.shard_walk``, the one walk of the tile grid and
    DemoFusion's windows and views on a mesh: the items padded to n_dev *
    k_local by repeating the last, each shard's run in chunks of ``bs``
    (padded to ``bs`` with the chunk's last item where asked), cache slots
    device-major, and the real items, in walk order, each item once."""
    devices = [torch.device("cpu")] * n_dev
    walk = schedulers.shard_walk(n_items, devices, bs, pad)
    k_local = -(-n_items // n_dev)
    n_local = -(-k_local // bs)
    assert [slot for _, slot, _, _ in walk] == list(range(n_dev * n_local))
    assert [i for _, _, ids, real in walk for i in ids[:real]] == list(range(n_items))
    for _, slot, ids, real in walk:
        run = min(bs, k_local - (slot % n_local) * bs)
        assert len(ids) == (bs if pad else run)
        assert ids[run:] == [ids[run - 1]] * (len(ids) - run)
        assert all(i == n_items - 1 for i in ids[real:run])     # the mesh's padding


def test_mesh_never_takes_the_fused_blend(pipes, monkeypatch):
    """Under MDU_FUSED_BLEND the mesh adds the tiles as the unsharded loop
    does and never calls #5 (``mdu_tpu/tiling/schedulers.py:303-305``): its
    latents are the unfused single device's to the bit."""
    single, mesh = pipes[0], pipes[1]
    want = CASES["txt2img"](single).latents
    calls = []
    blend = schedulers.fused_tile_blend
    monkeypatch.setattr(schedulers, "fused_tile_blend",
                        lambda *a, **k: calls.append(1) or blend(*a, **k))
    monkeypatch.setenv("MDU_FUSED_BLEND", "interp")
    got = CASES["txt2img"](mesh).latents
    assert calls == []
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    CASES["txt2img"](single)
    assert calls, "the single device takes #5 under the flag"


def test_mesh_guard_and_shard_threads(pipes):
    """The guard of ``mdu_tpu/pipeline.py:158-161`` (a 'tiles' axis), a mesh of
    another device type, ``make_tile_mesh``'s refusals, the modules' copies
    for another device; twelve shard threads
    (more than the cores) through 50 all-reduces at a short switch interval,
    each total exact; and a shard that fails: it raises, and the shard
    waiting for it at the all-reduce does not hang. DemoFusion runs on the
    mesh (its windows and views sharded, ``tests/test_torch_demofusion.py``
    holds it against JAX's mesh): the two-level UNet's x2 on 2 shards equals
    one device's within 1e-5 x max (the shards' chunks have other batch
    sizes than one device's batches)."""
    unet, vae = pipes[0].unet, pipes[0].vae
    df = (_cond(0), _cond(1), 128, 128, DemoFusionConfig(scale_factor=2),
          SamplerConfig(steps=2, denoising_strength=0.6))
    _close(pipes[1].demofusion(*df, decode=False).latents,
           pipes[0].demofusion(*df, decode=False).latents, rel=1e-5)
    with pytest.raises(ValueError, match="tiles"):
        DiffusionPipeline(unet, vae, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="mesh over"):
        DiffusionPipeline(unet, vae, device="cpu", mesh=TileMesh((torch.device("cuda", 0),)))
    with pytest.raises(ValueError, match="0 shards"):
        make_tile_mesh(0, devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
            make_tile_mesh()
    assert make_tile_mesh(2, devices=["cpu"] * 3).shape == {"tiles": 2}
    # a module's copy for another device is made outside inference mode (its
    # weights stay ordinary tensors) and kept
    single = pipes[0]
    assert single._on("unet", torch.device("cpu")) is single.unet
    with torch.inference_mode():
        copied = single._on("unet", torch.device("meta"))
    assert copied is not single.unet and copied is single._on("unet", torch.device("meta"))
    assert not any(p.is_inference() for p in copied.parameters())

    def rounds(d, dev, axis):
        return [axis.psum([torch.tensor([float(d + r)])])[0].item() for r in range(50)]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = run_shards(make_tile_mesh(devices=["cpu"] * 12), rounds)
    finally:
        sys.setswitchinterval(interval)
    assert got == [[float(66 + 12 * r) for r in range(50)]] * 12

    def shard(d, dev, axis):
        if d == 1:
            raise KeyError("shard one")
        return axis.psum([torch.ones(2)])

    done = []
    t = threading.Thread(target=lambda: done.append(
        pytest.raises(RuntimeError, run_shards, make_tile_mesh(devices=["cpu"] * 3), shard)))
    t.start()
    t.join(30)
    assert done and isinstance(done[0].value.__cause__, KeyError)


def test_cli_devices_above_the_available_warn_then_shard(monkeypatch, tmp_path, capsys):
    """``--devices 3`` where two devices are there: the JAX CLI's warning,
    then the run sharded over the two (``mdu_tpu/cli.py:139-150``); under
    ``--deterministic`` its PNG is the ``--devices 1`` run's to the bit.
    ``demofusion --devices 2`` shards its windows and views, its PNG within
    1 uint8 level of ``--devices 1``'s."""
    from mdu_tpu_torch import cli
    from mdu_tpu_torch.models import clip as clip_mod
    from mdu_tpu_torch.models import unet as unet_mod
    from mdu_tpu_torch.models import vae as vae_mod
    from mdu_tpu_torch.models.safetensors import save_file
    from mdu_tpu_torch.models.single_file import ldm_state_dict
    from mdu_tpu_torch.utils.image import load_image

    ucfg, vcfg, ccfg = UNetConfig(**TWO_LEVELS), tiny_vae_config(), clip_mod.tiny_clip_config()
    monkeypatch.setattr(unet_mod, "sd15_unet_config", lambda: ucfg)
    monkeypatch.setattr(vae_mod, "VAEConfig", lambda **kw: vcfg)
    monkeypatch.setattr(clip_mod, "clip_l_config", lambda: ccfg)
    monkeypatch.setattr(cli, "_install_sigint_watcher", lambda: None)
    monkeypatch.setattr(cli, "_available_devices", lambda dev: [dev, dev])
    mods = [UNet2DCondition(ucfg), AutoencoderKL(vcfg), clip_mod.CLIPTextModel(ccfg)]
    for seed, m in enumerate(mods):
        m.load_state_dict(random_state_dict(m, seed, device="cpu"))
    ckpt = str(tmp_path / "tiny.safetensors")
    save_file(ldm_state_dict(*mods), ckpt)
    outs = []
    for n in ("1", "3"):
        outs.append(str(tmp_path / f"d{n}.png"))
        cli.main(["txt2img", "--model-dir", ckpt, "--prompt", "a cat", "-W", "256", "-H", "128",
                  "--steps", "2", "--tile-width", "16", "--tile-height", "16", "--overlap", "8",
                  "--tile-batch-size", "2", "--deterministic", "--no-fast-decoder", "--seed", "3",
                  "--vae-decoder-tile", "16", "--device", "cpu", "--devices", n,
                  "--out", outs[-1]])
    err = capsys.readouterr().err
    assert "warning: only 2 of 3 requested devices available" in err
    assert "sharding grid tiles over 2 devices" in err
    np.testing.assert_array_equal(load_image(outs[0]), load_image(outs[1]))
    dfs = []
    for n in ("1", "2"):
        cli.main(["demofusion", "--model-dir", ckpt, "--prompt", "a cat", "-W", "128", "-H",
                  "128", "--steps", "2", "--scale", "2", "--window-size", "16", "--overlap",
                  "8", "--seed", "3", "--device", "cpu", "--devices", n,
                  "--vae-decoder-tile", "16", "--out", str(tmp_path / f"df{n}.png")])
        dfs.append(str(tmp_path / f"df{n}_scale1.png"))
    assert "sharding windows and views over 2 devices" in capsys.readouterr().err
    a, b = (load_image(p).astype(np.int16) for p in dfs)
    assert np.abs(a - b).max() <= 1

