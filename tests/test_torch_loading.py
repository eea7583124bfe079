"""Port parity for checkpoints: the port's ``.safetensors`` reader and writer
against the ``safetensors`` package, the loaded weights bit-equal to the
JAX package's loaded parameters (a tiny single-file LDM checkpoint, the same
as a ``.ckpt``, and a tiny SDXL diffusers folder), the LDM and OpenCLIP key
maps, LoRA merging, and per-region LoRA weights through the pipeline
against ``mdu_tpu`` (oracle: ``tests/test_lora.py:61``).
Tolerance: weights bit-equal; merged LoRA weights within 1e-6; the
pipeline's latents within 1e-4 x max|ref| (fp32, JAX at 'highest')."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import mdu_tpu.config as jcfg
from mdu_tpu.models import AutoencoderKL as JaxVAE
from mdu_tpu.models import UNet2DCondition as JaxUNet
from mdu_tpu.models import random_params
from mdu_tpu.models import tiny_clip_config as jax_tiny_clip
from mdu_tpu.models import tiny_vae_config as jax_tiny_vae
from mdu_tpu.models import loader as jloader
from mdu_tpu.models import lora as jlora
from mdu_tpu.models import single_file as jsingle
from mdu_tpu.models.unet import sd21_unet_config as jsd21_unet_config
from mdu_tpu.pipeline import DiffusionPipeline as JaxPipeline
from mdu_tpu.utils.bbox import RegionSpec as JaxRegionSpec
from mdu_tpu_torch import DiffusionPipeline, SamplerConfig, TiledDiffusionConfig
from mdu_tpu_torch.models import clip as clip_mod
from mdu_tpu_torch.models import loader, lora, single_file
from mdu_tpu_torch.models import safetensors as st
from mdu_tpu_torch.models import unet as unet_mod
from mdu_tpu_torch.models import vae as vae_mod
from mdu_tpu_torch.models.convert import state_dict_from_jax
from mdu_tpu_torch.utils.bbox import RegionSpec
from synth_ckpt import build_tiny_ldm_state, patch_tiny_configs

torch.set_num_threads(2)
# a two-level UNet (the tiny config's first level and its mid-block): JAX
# traces and compiles it in less than half the four-level tiny UNet's time
TWO_LEVELS = dict(block_out_channels=(8, 16), cross_attention_dim=16, num_heads=2,
                  transformer_layers=(1, 0), norm_num_groups=4)


def _same(module, params):
    """``module``'s state_dict bit-equal to JAX's parameter tree."""
    want = state_dict_from_jax(jax.tree.map(np.asarray, params))
    got = module.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_safetensors_against_the_package(tmp_path):
    sft = pytest.importorskip("safetensors.torch")
    g = torch.Generator().manual_seed(0)
    tensors = {"a.weight": torch.randn(3, 5, generator=g),
               "b": torch.randn(7, generator=g).to(torch.bfloat16),
               "c": torch.randn(2, 3, generator=g).half(), "ids": torch.arange(9),
               "n": torch.arange(4, dtype=torch.int32), "alpha": torch.tensor(4.0),
               "empty": torch.zeros(0, 3)}
    ours, theirs = str(tmp_path / "ours.safetensors"), str(tmp_path / "theirs.safetensors")
    st.save_file(tensors, ours, {"format": "pt"})
    sft.save_file(tensors, theirs, {"format": "pt"})
    for got in (sft.load_file(ours), st.load_file(theirs), st.load_file(ours)):
        assert set(got) == set(tensors)
        for k, v in tensors.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape
            torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    assert st.read_header(ours)["__metadata__"] == {"format": "pt"}
    with pytest.raises(ValueError, match="dtype"):
        st.save_file({"x": torch.zeros(2, dtype=torch.float64)}, ours)


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """The tiny LDM checkpoint of ``tests/synth_ckpt.py`` (its VAE attention as
    1x1 convs) as a .safetensors and as a .ckpt, the JAX loader's result of
    the .ckpt, and the parameters it was built from. The JAX and the port's
    config factories point at the tiny configs while the loaders run."""
    from mdu_tpu.models.unet import UNetConfig as JaxUNetConfig

    mp = pytest.MonkeyPatch()
    ucfg, vcfg, ccfg = JaxUNetConfig(**TWO_LEVELS), jax_tiny_vae(), jax_tiny_clip()
    patch_tiny_configs(mp, ucfg, vcfg, ccfg)
    pu = unet_mod.UNetConfig(**dataclasses.asdict(ucfg))
    pv = vae_mod.VAEConfig(**dataclasses.asdict(vcfg))
    pc = clip_mod.CLIPTextConfig(**dataclasses.asdict(ccfg))
    mp.setattr(unet_mod, "sd15_unet_config", lambda: pu)
    mp.setattr(vae_mod, "VAEConfig", lambda **kw: pv)
    mp.setattr(clip_mod, "clip_l_config", lambda: pc)
    state, up, _, cp = build_tiny_ldm_state(ucfg, vcfg, ccfg)
    root = tmp_path_factory.mktemp("ckpt")
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    paths = {".safetensors": str(root / "tiny.safetensors"), ".ckpt": str(root / "tiny.ckpt")}
    st.save_file(tensors, paths[".safetensors"])
    torch.save({"state_dict": tensors}, paths[".ckpt"])
    jpipe, jcond = jsingle.load_single_file(paths[".ckpt"])
    yield state, paths, jpipe, jcond, up, cp
    mp.undo()


@pytest.mark.parametrize("suffix", [".safetensors", ".ckpt"])
def test_single_file_loads_jax_weights(tiny_ckpt, suffix):
    """The port's UNet, VAE and CLIP weights from the .safetensors and from
    the .ckpt bit-equal to what the JAX loader loads; a hash tokenizer
    stands in."""
    state, paths, jpipe, jcond, up, cp = tiny_ckpt
    pipe, cond = single_file.load_single_file(paths[suffix], device="cpu")
    _same(pipe.unet, jpipe.unet_params)
    _same(pipe.vae, jpipe.vae_params)
    _same(cond.model, jcond.params)
    _same(pipe.unet, up)
    _same(cond.model, cp)
    assert single_file.detect_arch(state) == jsingle.detect_arch(state) == "sd1"
    assert pipe.schedule.prediction_type == "epsilon"
    assert type(cond.tokenizer).__name__ == "HashTokenizer"


def test_key_maps_match_jax():
    rng = np.random.default_rng(0)
    keys = ["model.diffusion_model.input_blocks.4.1.transformer_blocks.0.attn2.to_k.weight",
            "model.diffusion_model.output_blocks.2.1.conv.weight",
            "model.diffusion_model.middle_block.2.out_layers.3.bias",
            "model.diffusion_model.label_emb.0.2.weight",
            "first_stage_model.decoder.up.0.block.1.nin_shortcut.weight",
            "first_stage_model.encoder.mid.attn_1.proj_out.bias", "cond_stage_model.x"]
    for k in keys:
        assert single_file.ldm_unet_key_to_diffusers(k) == jsingle.ldm_unet_key_to_diffusers(k)
        assert single_file.ldm_vae_key_to_diffusers(k) == jsingle.ldm_vae_key_to_diffusers(k)
    oc = {"m.transformer.resblocks.0.attn.in_proj_weight": rng.normal(size=(24, 8)),
          "m.transformer.resblocks.0.attn.in_proj_bias": rng.normal(size=(24,)),
          "m.transformer.resblocks.0.ln_1.weight": rng.normal(size=(8,)),
          "m.transformer.resblocks.0.mlp.c_fc.bias": rng.normal(size=(32,)),
          "m.text_projection": rng.normal(size=(8, 16)),
          "m.positional_embedding": rng.normal(size=(77, 8)),
          "m.ln_final.bias": rng.normal(size=(8,))}
    oc = {k: v.astype(np.float32) for k, v in oc.items()}
    want = jsingle.openclip_text_to_hf(oc, "m.")
    got = single_file.openclip_text_to_hf({k: torch.from_numpy(v) for k, v in oc.items()}, "m.")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    k2 = "model.diffusion_model.input_blocks.4.1.transformer_blocks.0.attn2.to_k.weight"
    for ctx, arch in ((1024, "sd2"), (768, "sd1")):
        sd = {k2: torch.zeros(320, ctx)}
        assert single_file.detect_arch(sd) == jsingle.detect_arch(sd) == arch
    assert single_file.detect_arch({"conditioner.embedders.0.x": 1}) == "sdxl"
    assert dataclasses.asdict(unet_mod.sd21_unet_config()) == dataclasses.asdict(
        jsd21_unet_config())


def test_sdxl_folder_loads_jax_weights(tmp_path):
    """The tiny SDXL diffusers folder of ``tests/test_loader_controlnet.py:160``
    through both loaders: configs from the JSON files, every weight bit-equal,
    two tokenizers (the second padding with 0), the SDXL conds' shapes (their
    values against JAX's are ``tests/test_torch_text.py``'s)."""
    root = tmp_path / "sdxl"
    rng = np.random.default_rng(0)

    def dump(module, translate, sub, fname, cfg_json):
        """Random weights under every diffusers key of ``module`` (the port's
        module names are the JAX package's parameter paths)."""
        state = {translate(k.replace(".", "/")): torch.from_numpy(
                     (rng.normal(size=tuple(v.shape)) * 0.05).astype(np.float32))
                 for k, v in module.state_dict().items()}
        os.makedirs(root / sub, exist_ok=True)
        st.save_file(state, str(root / sub / fname))
        (root / sub / "config.json").write_text(json.dumps(cfg_json))

    ucfg = unet_mod.UNetConfig(block_out_channels=(8, 16, 16), cross_attention_dim=16,
                               num_heads=None, head_dim=8, transformer_layers=(0, 1, 2),
                               use_linear_projection=True, addition_embed_type="text_time",
                               addition_time_embed_dim=8, addition_pooled_dim=16,
                               norm_num_groups=4)
    with torch.device("meta"):
        modules = {"unet": unet_mod.UNet2DCondition(ucfg),
                   "vae": vae_mod.AutoencoderKL(vae_mod.VAEConfig(
                       block_out_channels=(8, 8, 16, 16), norm_num_groups=4))}
        for sub, proj in (("text_encoder", None), ("text_encoder_2", 16)):
            modules[sub] = clip_mod.CLIPTextModel(clip_mod.CLIPTextConfig(
                vocab_size=100, hidden_size=8, num_layers=2, num_heads=2, projection_dim=proj))
    dump(modules["unet"], jloader.translate_unet_name, "unet",
         "diffusion_pytorch_model.safetensors",
         {"block_out_channels": [8, 16, 16], "cross_attention_dim": 16,
          "attention_head_dim": [8, 8, 8], "norm_num_groups": 4,
          "transformer_layers_per_block": [0, 1, 2], "use_linear_projection": True,
          "addition_embed_type": "text_time", "addition_time_embed_dim": 8,
          "projection_class_embeddings_input_dim": 16 + 6 * 8,
          "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"]})
    dump(modules["vae"], jloader.translate_vae_name, "vae", "diffusion_pytorch_model.safetensors",
         {"block_out_channels": [8, 8, 16, 16], "norm_num_groups": 4})
    for sub, proj in (("text_encoder", None), ("text_encoder_2", 16)):
        cfg_json = {"vocab_size": 100, "hidden_size": 8, "num_hidden_layers": 2,
                    "num_attention_heads": 2, "max_position_embeddings": 77}
        if proj:
            cfg_json["projection_dim"] = proj
        dump(modules[sub], jloader.translate_clip_name, sub, "model.safetensors", cfg_json)
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1, "a</w>": 2, "cat</w>": 3}
    for tdir in ("tokenizer", "tokenizer_2"):
        os.makedirs(root / tdir, exist_ok=True)
        (root / tdir / "vocab.json").write_text(json.dumps(vocab))
        (root / tdir / "merges.txt").write_text("#v\n")

    jpipe, jcond = jloader.load_pipeline(str(root))
    pipe, cond = loader.load_pipeline(str(root), device="cpu")
    assert dataclasses.asdict(pipe.unet.cfg) == dataclasses.asdict(jpipe.unet.cfg)
    _same(pipe.unet, jpipe.unet_params)
    _same(pipe.vae, jpipe.vae_params)
    _same(cond.te1.model, jcond.te1.params)
    _same(cond.te2.model, jcond.te2.params)
    assert (cond.te2.tokenizer.pad_token, cond.te1.tokenizer.pad_token) == (0, 1)
    got = cond.cond("a cat", 128, 128)
    assert [tuple(got[k].shape) for k in ("crossattn", "vector", "time_ids")] == \
        [(1, 77, 16), (1, 16), (1, 6)]
    # StableSR's encoder loads from a file of its own (test_torch_adapters.py)
    with pytest.raises(FileNotFoundError):
        loader.load_guidance(str(root / "no_guidance.safetensors"), pipe.unet.cfg, device="cpu")


def _kohya(params, names, rank, seed):
    """A kohya LoRA over JAX parameter ``names``: (state for JAX, state for
    the port)."""
    flat = traverse_util.flatten_dict(params["params"], sep="/")
    rng = np.random.default_rng(seed)
    state = {}
    for name in names:
        w = np.asarray(flat[name])
        base = jloader.translate_unet_name(name)[:-len(".weight")].replace(".", "_")
        state[f"lora_unet_{base}.lora_down.weight"] = rng.normal(
            size=(rank,) + w.shape[1:]).astype(np.float32) * 0.3
        state[f"lora_unet_{base}.lora_up.weight"] = rng.normal(
            size=(w.shape[0], rank) + (1, 1)[:w.ndim - 2]).astype(np.float32) * 0.3
        state[f"lora_unet_{base}.alpha"] = np.float32(rank / 2)
    return state, {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


LORA_NAMES = ["down_0_attn_0/block_0/attn1/to_q/weight", "mid_res_0/conv1/weight",
              "up_1_attn_2/block_0/ff/out/weight"]


@pytest.fixture(scope="module")
def lora_pipes():
    from mdu_tpu.models.unet import UNetConfig as JaxUNetConfig
    from mdu_tpu_torch.models import (AutoencoderKL, UNet2DCondition, load_jax_params,
                                      tiny_vae_config)

    unet, vae = JaxUNet(JaxUNetConfig(**TWO_LEVELS)), JaxVAE(jax_tiny_vae())
    up = random_params(unet, 0, jnp.zeros((1, 4, 16, 16)), jnp.zeros((1,)),
                       jnp.zeros((1, 7, 16)))
    vp = random_params(vae, 1, jnp.zeros((1, 3, 64, 64)), jax.random.PRNGKey(0))
    to_np = lambda p: jax.tree.map(np.asarray, p)            # noqa: E731
    port = DiffusionPipeline(
        load_jax_params(UNet2DCondition(unet_mod.UNetConfig(**TWO_LEVELS)), to_np(up)),
        load_jax_params(AutoencoderKL(tiny_vae_config()), to_np(vp)), device="cpu")
    return JaxPipeline(unet, up, vae, vp), port, up


def test_merge_lora_matches_jax(lora_pipes):
    """Linear and conv deltas at alpha / rank, merged twice (``merge_loras``),
    against the JAX merge; a LoRA that names nothing returns the input."""
    _, port, up = lora_pipes
    s1, t1 = _kohya(up, LORA_NAMES, 2, 0)
    s2, t2 = _kohya(up, LORA_NAMES[:1], 3, 1)
    want = state_dict_from_jax(jax.tree.map(
        np.asarray, jlora.merge_loras(up, [(s1, 0.7), (s2, -0.4)])))
    got = lora.merge_loras(port.unet.state_dict(), [(t1, 0.7), (t2, -0.4)])
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-6, msg=k)
    changed = {n.replace("/", ".") for n in LORA_NAMES}
    base = port.unet.state_dict()
    assert all(torch.equal(got[k], base[k]) == (k not in changed) for k in base)
    sd = port.unet.state_dict()
    assert lora.merge_lora(sd, {"lora_unet_nothing.lora_down.weight": torch.zeros(2, 4)}) is sd


def test_per_region_lora_matches_jax(lora_pipes):
    """One step of a 256 x 128 txt2img with a region over the left half whose
    UNet has a LoRA merged (``tests/test_lora.py:61``): the port's latents
    within 1e-4 x max of JAX's, the LoRA moving the region and not the rest."""
    jpipe, port, up = lora_pipes
    s, t = _kohya(up, LORA_NAMES, 2, 2)
    cond = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (1, 7, 16))) * 0.1
    kw = dict(tile_w=16, tile_h=16, overlap=8)
    jregions = [JaxRegionSpec(0.0, 0.0, 0.5, 1.0, "left", seed=1)]
    res_j = jpipe.txt2img({"crossattn": jnp.asarray(cond)}, None, 256, 128,
                          jcfg.SamplerConfig(steps=1), seed=3,
                          tiled_diffusion=jcfg.TiledDiffusionConfig(regions=jregions, **kw),
                          region_conds=[({"crossattn": jnp.asarray(cond)}, None)],
                          region_unet_params=[jlora.merge_lora(up, s, 1.5)], decode=False)
    from mdu_tpu.tiling import regions as jreg
    from mdu_tpu.tiling.schedulers import plan_tiled_diffusion as jplan
    plan = jplan(jcfg.Method.MULTI_DIFF, 16, 32, 16, 16, 8, regions=jregions)
    noise = np.array(jreg.compose_region_noise(
        jax.random.normal(jax.random.PRNGKey(3), (1, 4, 16, 32), jnp.float32), plan.regions, [1]))
    td = TiledDiffusionConfig(regions=[RegionSpec(0.0, 0.0, 0.5, 1.0, "left", seed=1)], **kw)
    merged = lora.merge_lora(port.unet.state_dict(), t, 1.5)
    c = {"crossattn": cond}
    got = port._txt2img_from_noise(noise, c, None, SamplerConfig(steps=1), 3, td, decode=False,
                                   region_conds=[(c, None)], region_seeds=[1],
                                   region_unet_params=[merged])
    plain = port._txt2img_from_noise(noise, c, None, SamplerConfig(steps=1), 3, td,
                                     decode=False, region_conds=[(c, None)], region_seeds=[1])
    want = np.asarray(res_j.latents)
    np.testing.assert_allclose(got.latents.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    diff = (got.latents - plain.latents).abs()
    assert diff[..., :16].max() > 1e-4 and diff[..., 16:].max() < 1e-5
