"""Port parity for prompts: the tokenizers and every prompt parser equal to
``mdu_tpu``'s, the tiny CLIP text model, the conditioner's chunks, emphasis,
banks and AND conds, the SDXL conditioner, and a tiny txt2img from a
scheduled and from an AND prompt through the pipeline (oracles:
``tests/test_text.py``, ``tests/test_sdxl_misc.py:30-58``).
Tolerances: CLIP and conds within 1e-5 x max|ref|, the pipeline's latents
within 1e-4 x max|ref| (fp32 on both sides, JAX at 'highest')."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdu_tpu.config as jcfg
from mdu_tpu.models import AutoencoderKL as JaxVAE
from mdu_tpu.models import CLIPTextModel as JaxCLIP
from mdu_tpu.models import UNet2DCondition as JaxUNet
from mdu_tpu.models import random_params
from mdu_tpu.models import tiny_clip_config as jax_tiny_clip
from mdu_tpu.models.unet import UNetConfig as JaxUNetConfig
from mdu_tpu.models import tiny_vae_config as jax_tiny_vae
from mdu_tpu.pipeline import DiffusionPipeline as JaxPipeline
from mdu_tpu.text import TextConditioner as JaxConditioner
from mdu_tpu.text import prompt as jprompt
from mdu_tpu.text import tokenizer as jtok
from mdu_tpu.text.sdxl import SDXLConditioner as JaxSDXL
from mdu_tpu_torch import DiffusionPipeline, SamplerConfig, TiledDiffusionConfig
from mdu_tpu_torch.models import (AutoencoderKL, UNet2DCondition, UNetConfig, load_jax_params,
                                  tiny_vae_config)
from mdu_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel, tiny_clip_config
from mdu_tpu_torch.text import SDXLConditioner, TextConditioner, prompt, tokenizer

torch.set_num_threads(2)

PROMPTS = ["a cat", "a (cat)", "a ((cat:1.3)) [dog] and \\(lit\\)", "a (cat", "x BREAK y",
           "a [cat:dog:5] walks", "a [cat:dog:0.5] walks", "a [dog:5]", "a [cat::5]",
           "a [cat|dog|owl] photo", "a cat AND a dog:0.5 AND owl : 1.5",
           "a cat <lora:catstyle:0.8> in a hat <hypernet:h1>", "", "   spaced   out  ",
           "abc ab cab 7 9!", "[x|y|z] AND [a:b:2]"]


def _close(got, want, rel):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _vocab():
    """A char-level vocab with a few merges (whole-word-only vocabs send every
    word to <eot>)."""
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for i, ch in enumerate("abcdefghijklmnopqrstuvwxyz0123456789!()[]"):
        vocab[ch] = 2 + 2 * i
        vocab[ch + "</w>"] = 3 + 2 * i
    vocab.update({"ab": 200, "ab</w>": 201, "abc</w>": 202, "ca": 203, "cat</w>": 204})
    merges = [("a", "b"), ("ab", "c</w>"), ("a", "b</w>"), ("c", "a"), ("ca", "t</w>")]
    return vocab, merges


def test_tokenizers_match_jax(tmp_path):
    vocab, merges = _vocab()
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version\n" + "\n".join(" ".join(m) for m in merges))
    files = (str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt"))
    for kw in ({}, {"pad_with_eot": False}):
        ours = tokenizer.CLIPTokenizer.from_files(*files, max_length=12, **kw)
        theirs = jtok.CLIPTokenizer.from_files(*files, max_length=12, **kw)
        for p in PROMPTS:
            assert ours.tokenize(p) == theirs.tokenize(p), p
            assert ours(p) == theirs(p), p
    assert tokenizer.CLIPTokenizer(vocab, merges).tokenize("abc ab cat") == [202, 201, 204]
    hashed, jhashed = tokenizer.HashTokenizer(1000, 16), jtok.HashTokenizer(1000, 16)
    for p in PROMPTS:
        assert hashed(p) == jhashed(p)
    assert tokenizer.bytes_to_unicode() == jtok.bytes_to_unicode()


def test_prompt_parsers_match_jax(tmp_path):
    for p in PROMPTS:
        assert prompt.parse_prompt_attention(p) == jprompt.parse_prompt_attention(p)
        assert prompt.extract_networks(p) == jprompt.extract_networks(p)
        assert ([dataclasses.astuple(c) for c in prompt.split_composable(p)]
                == [dataclasses.astuple(c) for c in jprompt.split_composable(p)])
        assert prompt.has_alternation(p) == jprompt.has_alternation(p)
        for steps in (1, 4, 10):
            assert (prompt.parse_prompt_schedule(p, steps)
                    == jprompt.parse_prompt_schedule(p, steps))
            for step in range(steps):
                assert (prompt.prompt_at_step_with_alternation(p, step, steps)
                        == jprompt.prompt_at_step_with_alternation(p, step, steps))
    csv = tmp_path / "styles.csv"
    csv.write_text("name,prompt,negative_prompt\nwarm,\"{prompt}, warm light\",cold\n"
                   "film,grainy,\nNone,x,y\n", encoding="utf-8")
    table = prompt.load_styles(str(csv))
    assert table == jprompt.load_styles(str(csv))
    for styles in ([], ["warm"], ["film", "warm"], ["missing"]):
        assert (prompt.apply_styles("a cat", "blurry", styles, table)
                == jprompt.apply_styles("a cat", "blurry", styles, table))


def _clip_pair(cfg_kw, seed=0):
    jcfg_clip = dataclasses.replace(jax_tiny_clip(), **cfg_kw)
    jmodel = JaxCLIP(jcfg_clip)
    params = random_params(jmodel, seed, jnp.zeros((1, jcfg_clip.max_length), jnp.int32))
    port = load_jax_params(CLIPTextModel(CLIPTextConfig(**dataclasses.asdict(jcfg_clip))),
                           jax.tree.map(np.asarray, params)).eval()
    return jmodel, params, port


@pytest.mark.parametrize("cfg_kw", [
    {}, {"clip_skip": 2}, {"clip_skip": 2, "ln_penultimate": False, "projection_dim": 12,
                           "hidden_act": "gelu"}], ids=["clip-l", "skip2", "bigg-like"])
def test_clip_matches_jax(cfg_kw):
    jmodel, params, port = _clip_pair(cfg_kw)
    ids = np.random.default_rng(0).integers(0, 990, size=(2, 16)).astype(np.int32)
    ids[:, 5] = 999                                  # the eot at a pooled position
    ids[1, 9:] = 999                                 # padded with eot: the first counts
    hidden, pooled = jmodel.apply(params, jnp.asarray(ids))
    with torch.no_grad():
        h, p = port(torch.from_numpy(ids).long())
    _close(h, hidden, 1e-5)
    _close(p, pooled, 1e-5)
    assert tiny_clip_config() == CLIPTextConfig(**dataclasses.asdict(jax_tiny_clip()))


@pytest.fixture(scope="module")
def conditioners():
    jmodel, params, port = _clip_pair({}, seed=2)
    return JaxConditioner(jmodel, params), TextConditioner(port, device="cpu")


def _cond_close(got, want, rel=1e-5):
    """A cond of the port against the JAX one: the same form, leaves close,
    bank indices and AND weights equal."""
    if "__and__" in want:
        assert got["__weights__"] == want["__weights__"]
        assert len(got["__and__"]) == len(want["__and__"])
        for g, w in zip(got["__and__"], want["__and__"]):
            _cond_close(g, w, rel)
        return
    assert set(got) == set(want)
    if "__bank__" in want:
        np.testing.assert_array_equal(np.asarray(got["__index__"]), np.asarray(want["__index__"]))
        _close(got["__bank__"]["crossattn"], want["__bank__"]["crossattn"], rel)
        return
    _close(got["crossattn"], want["crossattn"], rel)


def test_conditioner_matches_jax(conditioners):
    """Chunks (emphasis, BREAK, a prompt of 40 words: 3 chunks of 14 tokens),
    weighted encodes with the mean restored, and every form of ``cond``."""
    jtc, tc = conditioners
    long_prompt = " ".join(f"word{i}" for i in range(40))
    texts = ["a cat", "a (cat:1.8) [dog]", "x BREAK y (z)", long_prompt]
    for t in texts:
        assert tc._weighted_ids(t) == jtc._weighted_ids(t)
    z, pooled = tc.encode(texts)
    jz, jpooled = jtc.encode(texts)
    assert z.shape == (4, 48, 16)
    _close(z, jz, 1e-5)
    _close(pooled, jpooled, 1e-5)
    for p, steps in (("a [cat:dog:2] photo", 4), ("a [cat|dog] photo", 4), ("a cat", 4),
                     ("a [cat:dog:8] photo", 4), ("a cat AND a dog:0.5", None),
                     ("a [cat:dog:2] photo AND a photo", 4), ("<lora:x:0.5> a (cat)", None)):
        _cond_close(tc.cond(p, steps), jtc.cond(p, steps))
        assert tc.last_networks == jtc.last_networks
    for got, want in zip(tc.pair("a cat", "blurry", 4), jtc.pair("a cat", "blurry", 4)):
        _cond_close(got, want)
    for got, want in zip(tc.region_pair("a cat", "a hat", "ugly", "blurry"),
                         jtc.region_pair("a cat", "a hat", "ugly", "blurry")):
        _cond_close(got, want)


def test_banks_and_and_conds_resolve_like_jax(conditioners):
    """The pipeline's step functions pick the same bank entries and AND
    branches as the JAX package's ``_as_cond_fn``."""
    jtc, tc = conditioners
    port = DiffusionPipeline.__new__(DiffusionPipeline)
    port.device = torch.device("cpu")
    for p in ("a [cat:dog:2] photo AND a photo:0.5", "a [cat|dog|owl] photo"):
        fn = DiffusionPipeline._as_cond_fn(port._prepare(tc.cond(p, 4), port._cond))
        jfn = JaxPipeline._as_cond_fn(jtc.cond(p, 4))
        for step in (0, 1, 3, 7):
            _cond_close(fn(step), jfn(jnp.asarray(step)))


def test_sdxl_conditioner_matches_jax():
    def pair(hidden, proj, seed):
        jmodel, params, port = _clip_pair({"hidden_size": hidden, "num_heads": 2,
                                           "projection_dim": proj}, seed)
        return JaxConditioner(jmodel, params), TextConditioner(port, device="cpu")

    (j1, t1), (j2, t2) = pair(8, None, 0), pair(8, 16, 1)
    got = SDXLConditioner(t1, t2).cond("a castle", width=256, height=128)
    want = JaxSDXL(j1, j2).cond("a castle", width=256, height=128)
    assert got["crossattn"].shape == (1, 16, 16) and got["vector"].shape == (1, 16)
    for key in ("crossattn", "vector", "time_ids"):
        _close(got[key], want[key], 1e-5)
    np.testing.assert_array_equal(got["time_ids"].numpy(), [[128, 256, 0, 0, 128, 256]])


# a two-level UNet (the tiny config's first level and its mid-block), whose
# txt2img JAX compiles in less than half the four-level one's time
TWO_LEVELS = dict(block_out_channels=(8, 16), cross_attention_dim=16, num_heads=2,
                  transformer_layers=(1, 0), norm_num_groups=4)


@pytest.fixture(scope="module")
def pipes():
    unet, vae = JaxUNet(JaxUNetConfig(**TWO_LEVELS)), JaxVAE(jax_tiny_vae())
    up = random_params(unet, 0, jnp.zeros((1, 4, 16, 16)), jnp.zeros((1,)),
                       jnp.zeros((1, 16, 16)))
    vp = random_params(vae, 1, jnp.zeros((1, 3, 64, 64)), jax.random.PRNGKey(0))
    to_np = lambda p: jax.tree.map(np.asarray, p)            # noqa: E731
    port = DiffusionPipeline(load_jax_params(UNet2DCondition(UNetConfig(**TWO_LEVELS)), to_np(up)),
                             load_jax_params(AutoencoderKL(tiny_vae_config()), to_np(vp)),
                             device="cpu")
    return JaxPipeline(unet, up, vae, vp), port


def test_txt2img_from_prompts_matches_jax(pipes, conditioners):
    """256 x 128 px, 4 Euler steps at CFG 7 over 3 tiles of 16 (one batch),
    from an AND of a plain branch and an alternating one at weight 0.5 (a
    bank inside an AND cond), with a scheduled uncond (a bank switched at
    step 3); the prompts move the latents away from a plain prompt's."""
    jpipe, port = pipes
    jtc, tc = conditioners
    text, neg = "a cat AND a [dog|owl]:0.5", "blurry [x:y:3]"
    td = dict(tile_w=16, tile_h=16, overlap=8, tile_bs=3)
    res_j = jpipe.txt2img(jtc.cond(text, 4), jtc.cond(neg, 4), 256, 128,
                          jcfg.SamplerConfig(steps=4), seed=5,
                          tiled_diffusion=jcfg.TiledDiffusionConfig(**td), decode=False)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(5), (1, 4, 16, 32)))

    def run(cond, uncond):
        return port._txt2img_from_noise(noise, cond, uncond, SamplerConfig(steps=4), 5,
                                        TiledDiffusionConfig(**td), decode=False).latents

    got = run(tc.cond(text, 4), tc.cond(neg, 4))
    _close(got, res_j.latents, 1e-4)
    plain = run(tc.cond("a cat"), tc.cond("blurry x"))
    assert (plain - got).abs().max() > 1e-3
    assert (run(tc.cond("a cat"), tc.cond(neg, 4)) - plain).abs().max() > 1e-3
    # noise inversion takes a plain cond only; DemoFusion resolves the AND
    # and scheduled cond every step
    image = np.zeros((128, 256, 3), np.uint8)
    with pytest.raises(ValueError, match="plain cond"):
        port._img2img_from_noise(image, noise, noise, tc.cond(text, 4), None,
                                 SamplerConfig(steps=2, denoising_strength=0.5), 5,
                                 TiledDiffusionConfig(noise_inverse=True, **td), decode=False)
    res = port.demofusion(tc.cond(text, 2), tc.cond(neg, 2), 64, 64,
                          sampler=SamplerConfig(steps=2), decode=False)
    assert res.latents.shape == (1, 4, 24, 24) and torch.isfinite(res.latents).all()   # x3
