"""Port parity: layers, the tiny SD1.5 UNet and the tiny VAE decoder against
the JAX modules, with weights carried by ``state_dict_from_jax``.
Tolerance: atol 1e-4 * max|ref| (fp32 on both sides, JAX at 'highest')."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdu_tpu.models import AutoencoderKL as JaxVAE
from mdu_tpu.models import UNet2DCondition as JaxUNet
from mdu_tpu.models import random_params
from mdu_tpu.models import tiny_unet_config as jax_tiny_unet
from mdu_tpu.models import tiny_vae_config as jax_tiny_vae
from mdu_tpu.models.layers import LayerNorm as JaxLayerNorm
from mdu_tpu.models.layers import timestep_embedding as jax_temb
from mdu_tpu.models.unet import FeedForwardGEGLU as JaxGEGLU
from mdu_tpu.ops.tile_context import TileContext as JaxTileContext
from mdu_tpu.ops.tile_context import tile_group_norm as jax_tile_group_norm
from mdu_tpu_torch.models import (VAE_ENCODER_PREFIXES, AutoencoderKL, UNet2DCondition,
                                  load_jax_params, random_state_dict, state_dict_from_jax,
                                  tiny_unet_config, tiny_vae_config)
from mdu_tpu_torch.models.layers import LayerNorm, timestep_embedding
from mdu_tpu_torch.models.unet import FeedForwardGEGLU
from mdu_tpu_torch.ops.tile_context import TileContext, tile_group_norm

torch.set_num_threads(2)


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _np(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def unet_pair():
    cfg = jax_tiny_unet()
    unet = JaxUNet(cfg)
    params = random_params(unet, 0, jnp.zeros((1, 4, 16, 16)), jnp.zeros((1,)),
                           jnp.zeros((1, 7, cfg.cross_attention_dim)))
    port = load_jax_params(UNet2DCondition(tiny_unet_config()), _np(params)).eval()
    return unet, params, port


@pytest.fixture(scope="module")
def vae_pair():
    vae = JaxVAE(jax_tiny_vae())
    params = random_params(vae, 1, jnp.zeros((1, 3, 32, 32)), jax.random.PRNGKey(0))
    port = load_jax_params(AutoencoderKL(tiny_vae_config()), _np(params),
                           VAE_ENCODER_PREFIXES).eval()
    return vae, params, port


# ------------------------------------------------------------------ layers


@pytest.mark.parametrize("mode", ["plain", "pooled", "masked", "masked_up",
                                  "masked_reference"])
def test_group_norm_modes_match_jax(rng, mode):
    T, B, C, G, h, w = 2, 2, 8, 4, 8, 12
    x = (rng.normal(size=(T * B, C, h, w)) * 3 + 1).astype(np.float32)
    wt = rng.normal(size=(C,)).astype(np.float32)
    bs = rng.normal(size=(C,)).astype(np.float32)
    masks = np.zeros((T, 1, h, w), np.float32)
    masks[0, :, :, :7] = 1.0
    masks[1, :, :, 7:] = 1.0
    jctx = pctx = None
    if mode != "plain":
        use = None if mode == "pooled" else masks
        ref = mode == "masked_reference"
        jctx = JaxTileContext(T, (h, w), None if use is None else jnp.asarray(use),
                              reference_pooling=ref)
        pctx = TileContext(T, (h, w), None if use is None else torch.from_numpy(use),
                           reference_pooling=ref)
    if mode == "masked_up":              # masks derived at 2x resolution
        x = np.repeat(np.repeat(x, 2, axis=2), 2, axis=3)
    want = jax_tile_group_norm(jnp.asarray(x), G, jnp.asarray(wt), jnp.asarray(bs), jctx)
    got = tile_group_norm(torch.from_numpy(x), G, torch.from_numpy(wt),
                          torch.from_numpy(bs), pctx)
    _close(got, want)


def test_layer_norm_matches_jax(rng):
    x = (rng.normal(size=(2, 5, 16)) * 2 + 3).astype(np.float32)
    mod = JaxLayerNorm()
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(lambda a: a + 0.3, params)
    port = load_jax_params(LayerNorm(16), _np(params))
    _close(port(torch.from_numpy(x)), mod.apply(params, jnp.asarray(x)))


def test_geglu_uses_tanh_gelu(rng):
    x = rng.normal(size=(2, 5, 8)).astype(np.float32) * 2
    mod = JaxGEGLU(8)
    params = random_params(mod, 3, jnp.asarray(x))
    port = load_jax_params(FeedForwardGEGLU(8), _np(params))
    _close(port(torch.from_numpy(x)), mod.apply(params, jnp.asarray(x)), rel=1e-5)


def test_timestep_embedding_matches_jax():
    t = np.array([0.0, 1.5, 999.0, 431.7], np.float32)
    for dim in (8, 320, 9):
        _close(timestep_embedding(torch.from_numpy(t), dim),
               jax_temb(jnp.asarray(t), dim))


# ------------------------------------------------------------ whole models


@pytest.mark.parametrize("B,h,w", [(2, 16, 16), (1, 12, 20)])
def test_tiny_unet_matches_jax(rng, unet_pair, B, h, w):
    """12 x 20 is not divisible by 8: the up path resizes to the skip's size
    (nearest at half-pixel centres on both sides)."""
    unet, params, port = unet_pair
    x = rng.normal(size=(B, 4, h, w)).astype(np.float32)
    t = np.array([5.0, 701.3][:B], np.float32)
    ctx = rng.normal(size=(B, 7, 16)).astype(np.float32)
    want = jax.jit(unet.apply)(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    _close(got, want)


def test_tiny_vae_decode_matches_jax(rng, vae_pair):
    vae, params, port = vae_pair
    z = rng.normal(size=(1, 4, 6, 10)).astype(np.float32)
    want = jax.jit(lambda p, z: vae.apply(p, z, method=vae.decode))(params, jnp.asarray(z))
    with torch.no_grad():
        got = port.decode(torch.from_numpy(z))
    _close(got, want)


def test_state_dict_from_jax_names_and_strictness(unet_pair, vae_pair):
    _, uparams, port_unet = unet_pair
    sd = state_dict_from_jax(_np(uparams))
    assert set(sd) == set(port_unet.state_dict())
    assert all(v.shape == port_unet.state_dict()[k].shape for k, v in sd.items())
    # no transposes: a conv weight is the same OIHW array on both sides
    w = np.asarray(uparams["params"]["down_0_res_0"]["conv1"]["weight"])
    np.testing.assert_array_equal(sd["down_0_res_0.conv1.weight"].numpy(), w)

    _, vparams, port_vae = vae_pair
    with pytest.raises(RuntimeError, match="Unexpected key"):
        port_vae.load_state_dict(state_dict_from_jax(_np(vparams)), strict=True)
    kept = state_dict_from_jax(_np(vparams), VAE_ENCODER_PREFIXES)
    assert set(kept) == set(port_vae.state_dict())


def test_random_state_dict_scheme():
    port = UNet2DCondition(tiny_unet_config())
    sd = random_state_dict(port, 0, dtype=torch.bfloat16, device="cpu")
    assert set(sd) == set(port.state_dict())
    assert all(v.dtype == torch.bfloat16 for v in sd.values())
    assert float(sd["conv_in.bias"].abs().max()) == 0.0
    assert float(sd["norm_out.weight"].min()) == 1.0
    w = sd["down_0_res_0.conv1.weight"].float()
    bound = (3.0 / (8 * 9)) ** 0.5
    assert float(w.abs().max()) <= bound * 1.01 and float(w.std()) > bound / 3
    again = random_state_dict(port, 0, device="cpu")
    torch.testing.assert_close(again["conv_in.weight"].to(torch.bfloat16), sd["conv_in.weight"])
    meta = UNet2DCondition(tiny_unet_config()).to("meta")
    meta.load_state_dict(again, strict=True, assign=True)
    assert meta.conv_in.weight.device.type == "cpu"
    if not torch.cuda.is_available():
        # the weights are drawn on the card unless the caller names the CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            random_state_dict(port, 0)
