"""Port parity for SDXL and ControlNet: the tiny SDXL UNet (``text_time``
addition embedding, linear projections, per-level depths) and the tiny
ControlNet with its zero gates filled with random values, the UNet fed its
residuals, the hint path of ``tiling/conds.py`` and ``hint_to_tensor``,
``random_state_dict``'s zero rule and ``load_jax_params`` of both trees,
against ``mdu_tpu``. Tolerance: atol 1e-4 x max|ref| (fp32 on both sides,
JAX at 'highest')."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from mdu_tpu.models import UNet2DCondition as JaxUNet
from mdu_tpu.models import random_params
from mdu_tpu.models.controlnet import ControlNet as JaxControlNet
from mdu_tpu.models.unet import sdxl_unet_config as jax_sdxl_config
from mdu_tpu.models.unet import tiny_sdxl_unet_config as jax_tiny_sdxl
from mdu_tpu.tiling import conds as jconds
from mdu_tpu.utils import image as jimage
from mdu_tpu.utils.bbox import BBox as JaxBBox
from mdu_tpu_torch import DiffusionPipeline, SamplerConfig
from mdu_tpu_torch.models import (AutoencoderKL, ControlNet, StableSRGuidance, UNet2DCondition,
                                  load_jax_params, random_state_dict, sdxl_unet_config,
                                  state_dict_from_jax, tiny_sdxl_unet_config, tiny_vae_config)
from mdu_tpu_torch.models.unet import UNetConfig
from mdu_tpu_torch.tiling import conds
from mdu_tpu_torch.utils.bbox import BBox
from mdu_tpu_torch.utils.image import hint_to_tensor

torch.set_num_threads(2)
CTX = 16                     # the tiny config's cross-attention width


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _np(params):
    return jax.tree.map(np.asarray, params)


def _is_gate(name: str) -> bool:
    return (any(seg.startswith("zero") for seg in name.split("/"))
            or "cond_embedding/conv_out" in name)


def fill_gates(params, seed: int, scale: float = 0.3):
    """``params`` with every zero-initialised ControlNet gate drawn from a
    normal of std ``scale``, so that a wrong residual path shows."""
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(params["params"], sep="/")
    flat = {k: (jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * scale)
                if _is_gate(k) else v) for k, v in flat.items()}
    return {"params": traverse_util.unflatten_dict(flat, sep="/")}


def build_tiny_sdxl(cfg=None):
    """The tiny SDXL UNet and ControlNet on both sides (``cfg``: the JAX
    package's config, the tiny SDXL one by default), the ControlNet's gates
    random: (jax unet, params, jax controlnet, params, port unet, port cn)."""
    cfg = cfg or jax_tiny_sdxl()
    added = {"text_embeds": jnp.zeros((1, cfg.addition_pooled_dim)),
             "time_ids": jnp.ones((1, cfg.num_time_ids))}
    unet, cn = JaxUNet(cfg), JaxControlNet(cfg)
    up = random_params(unet, 0, jnp.zeros((1, 4, 16, 16)), jnp.zeros((1,)),
                       jnp.zeros((1, 7, CTX)), added)
    cp = fill_gates(random_params(cn, 2, jnp.zeros((1, 4, 16, 16)), jnp.zeros((1,)),
                                  jnp.zeros((1, 7, CTX)), jnp.zeros((1, 3, 128, 128)), added), 3)
    port_cfg = UNetConfig(**dataclasses.asdict(cfg))
    port_unet = load_jax_params(UNet2DCondition(port_cfg), _np(up)).eval()
    port_cn = load_jax_params(ControlNet(port_cfg), _np(cp)).eval()
    return unet, up, cn, cp, port_unet, port_cn


@pytest.fixture(scope="module")
def sdxl_pair():
    return build_tiny_sdxl()


def _inputs(rng, B, h, w):
    x = rng.normal(size=(B, 4, h, w)).astype(np.float32)
    t = np.array([5.0, 701.3, 340.0][:B], np.float32)
    ctx = rng.normal(size=(B, 7, CTX)).astype(np.float32)
    vec = rng.normal(size=(B, 16)).astype(np.float32)
    tids = rng.uniform(0, 1024, size=(B, 6)).astype(np.float32)
    hint = rng.uniform(size=(B, 3, h * 8, w * 8)).astype(np.float32)
    return x, t, ctx, vec, tids, hint


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_config_matches_jax():
    assert sdxl_unet_config().__dict__ == jax_sdxl_config().__dict__
    assert tiny_sdxl_unet_config().__dict__ == jax_tiny_sdxl().__dict__


@pytest.mark.parametrize("B,h,w", [(2, 16, 16), (1, 12, 20)])
def test_tiny_sdxl_unet_matches_jax(rng, sdxl_pair, B, h, w):
    """text_time over [vector, timestep_embedding(time_ids, 8)], linear
    projections, depths (0, 1, 2) and the mid block at depth 2; 12 x 20 is
    off the 4x downsampling."""
    unet, up, _, _, port, _ = sdxl_pair
    x, t, ctx, vec, tids, _ = _inputs(rng, B, h, w)
    added = {"text_embeds": jnp.asarray(vec), "time_ids": jnp.asarray(tids)}
    want = jax.jit(unet.apply)(up, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), added)
    X, T, C, V, I = _t(x, t, ctx, vec, tids)
    with torch.no_grad():
        got = port(X, T, C, {"text_embeds": V, "time_ids": I})
    _close(got, want)


def test_tiny_controlnet_and_residuals_match_jax(rng, sdxl_pair):
    """The ControlNet with random gates on a random hint: every residual, and
    the UNet fed them."""
    unet, up, cn, cp, port_unet, port_cn = sdxl_pair
    x, t, ctx, vec, tids, hint = _inputs(rng, 2, 16, 16)
    added = {"text_embeds": jnp.asarray(vec), "time_ids": jnp.asarray(tids)}
    jx, jt_, jc = jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)
    down, mid = jax.jit(cn.apply)(cp, jx, jt_, jc, jnp.asarray(hint), added)
    want = jax.jit(lambda p, r: unet.apply(p, jx, jt_, jc, added, residuals=r))(up, (down, mid))
    X, T, C, V, I, Hn = _t(x, t, ctx, vec, tids, hint)
    pa = {"text_embeds": V, "time_ids": I}
    with torch.no_grad():
        pdown, pmid = port_cn(X, T, C, Hn, pa)
        got = port_unet(X, T, C, pa, residuals=(pdown, pmid))
    assert len(pdown) == len(down) == 9
    for g, w in zip(pdown, down):
        _close(g, w)
    _close(pmid, mid)
    assert float(np.abs(np.asarray(mid)).max()) > 0.1        # the gates are open
    _close(got, want)


def test_hint_path_matches_jax(rng, monkeypatch):
    """quantize_control_hints (by size, and forced), dequantize_hint,
    fit_cond_canvases, hint_to_tensor and the per-tile cut of a control list."""
    img = (rng.random((40, 24, 3)) * 255).astype(np.uint8)
    _close(hint_to_tensor(img), jimage.hint_to_tensor(img), rel=0)
    _close(hint_to_tensor(img[..., 0]), jimage.hint_to_tensor(img[..., 0]), rel=0)

    hint = rng.uniform(-0.2, 1.2, size=(1, 3, 96, 64)).astype(np.float32)
    cond = {"crossattn": rng.normal(size=(1, 7, CTX)).astype(np.float32), "control": [hint]}
    jc = {k: ([jnp.asarray(h) for h in v] if k == "control" else jnp.asarray(v))
          for k, v in cond.items()}
    pc = {k: ([torch.from_numpy(h) for h in v] if k == "control" else torch.from_numpy(v))
          for k, v in cond.items()}
    # fitted to a 16 x 10 latent: 128 x 80 pixels
    jfit, pfit = jconds.fit_cond_canvases(jc, (16, 10)), conds.fit_cond_canvases(pc, (16, 10))
    _close(pfit["control"][0], jfit["control"][0], rel=1e-6)
    assert conds.fit_cond_canvases(pfit, (16, 10))["control"][0] is pfit["control"][0]
    # quantised from the same values on both sides
    same = {**pfit, "control": [torch.from_numpy(np.array(jfit["control"][0]))]}
    for mode in ("auto", "1", "0"):
        monkeypatch.setenv("MDU_HINT_UINT8", mode)
        jq, pq = jconds.quantize_control_hints(jfit), conds.quantize_control_hints(same)
        assert str(pq["control"][0].dtype).split(".")[-1] == str(jq["control"][0].dtype)
        _close(pq["control"][0].float(), np.asarray(jq["control"][0]).astype(np.float32), rel=0)
        _close(conds.dequantize_hint(pq["control"][0]),
               jconds.dequantize_hint(jq["control"][0]), rel=1e-7)
    # a uint8 hint fits through its dequantised values
    q = conds.quantize_control_hints(pfit, min_pixels=0)
    jq = jconds.quantize_control_hints(jfit, min_pixels=0)
    _close(conds.fit_cond_canvases(q, (12, 12))["control"][0],
           jconds.fit_cond_canvases(jq, (12, 12))["control"][0], rel=1e-6)
    # the per-tile cut: the hint at 8x the latent bbox, crossattn repeated
    boxes = [(0, 0, 6, 8), (4, 8, 6, 8)]
    pt = conds.tile_cond(pfit, [BBox(*b) for b in boxes], (16, 10))
    jt_ = jconds.tile_cond(jfit, [JaxBBox(*b) for b in boxes], (16, 10))
    _close(pt["control"][0], jt_["control"][0], rel=1e-6)
    _close(pt["crossattn"], jt_["crossattn"], rel=0)
    both = conds.concat_conds(pt, pt)
    assert both["control"][0].shape[0] == 4 and both["crossattn"].shape[0] == 4


def test_random_state_dict_keeps_the_gates_at_zero():
    """JAX's random_params rule: every zero* module and
    cond_embedding.conv_out are zero; the other weights are drawn."""
    port = ControlNet(tiny_sdxl_unet_config())
    sd = random_state_dict(port, 0, device="cpu")
    assert set(sd) == set(port.state_dict())
    gates = [k for k in sd if k.split(".")[0].startswith("zero")
             or k.startswith("cond_embedding.conv_out")]
    assert len(gates) == 2 * 11                  # zero_0 .. zero_8, zero_mid, conv_out
    assert all(float(sd[k].abs().max()) == 0.0 for k in gates)
    assert float(sd["cond_embedding.block_1.weight"].abs().max()) > 0.0
    assert float(sd["down_1_attn_0.proj_in.weight"].abs().max()) > 0.0
    cfg = jax_tiny_sdxl()
    jp = random_params(JaxControlNet(cfg), 2, jnp.zeros((1, 4, 16, 16)), jnp.zeros((1,)),
                       jnp.zeros((1, 7, CTX)), jnp.zeros((1, 3, 128, 128)),
                       {"text_embeds": jnp.zeros((1, 16)), "time_ids": jnp.ones((1, 6))})
    jsd = state_dict_from_jax(_np(jp))
    assert sorted(k for k, v in jsd.items() if float(v.abs().max()) == 0.0
                  and not k.endswith("bias")) == sorted(k for k in gates
                                                        if not k.endswith("bias"))


def test_load_jax_params_strict_for_both_trees(sdxl_pair):
    _, up, _, cp, port_unet, port_cn = sdxl_pair
    for params, port in ((up, port_unet), (cp, port_cn)):
        sd = state_dict_from_jax(_np(params))
        assert set(sd) == set(port.state_dict())
        with pytest.raises(RuntimeError, match="Missing key"):
            port.load_state_dict(dict(list(sd.items())[1:]), strict=True)
    assert "add_embed_1.weight" in port_unet.state_dict()
    assert tuple(port_unet.down_1_attn_0.proj_in.weight.shape) == (16, 16)   # linear


def test_sdxl_pipeline_needs_its_vector_and_raises_for_stablesr(sdxl_pair):
    _, _, _, _, port_unet, port_cn = sdxl_pair
    vae = AutoencoderKL(tiny_vae_config())
    pipe = DiffusionPipeline(port_unet, vae, device="cpu", controlnet=port_cn)
    noise = torch.zeros(1, 4, 8, 8)
    with pytest.raises(ValueError, match="vector"):
        pipe._txt2img_from_noise(noise, {"crossattn": torch.zeros(1, 7, CTX)}, None,
                                 SamplerConfig(steps=1), decode=False)
    # StableSR's guidance leaf is taken, and must be on the uncond as well
    guided = DiffusionPipeline(port_unet, vae, device="cpu", controlnet=port_cn,
                               guidance_model=StableSRGuidance(port_unet.cfg))
    vec = torch.zeros(1, 16)
    c = {"crossattn": torch.zeros(1, 7, CTX), "vector": vec,
         "guidance": torch.zeros(1, 4, 8, 8)}
    assert set(guided._cond(c)) == set(c)
    with pytest.raises(ValueError, match="guidance"):
        guided._txt2img_from_noise(noise, c, {"crossattn": torch.zeros(1, 7, CTX),
                                              "vector": vec}, SamplerConfig(steps=1),
                                   decode=False)
