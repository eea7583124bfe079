"""Port parity for the tiled VAE of the img2img slice: the encoder untiled
and exact-tiled (pooled GroupNorm statistics), the fast encoder with and
without ``color_fix`` and the fast decoder (estimated statistics injected
into every GroupNorm), the encoder's tile plan and the memory footprints,
each against ``mdu_tpu`` on the CPU with the same weights and inputs.
Tolerance: atol 1e-4 * max|ref| (fp32 on both sides, JAX at 'highest')."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdu_tpu.models import AutoencoderKL as JaxVAE
from mdu_tpu.models import random_params
from mdu_tpu.models import tiny_vae_config as jax_tiny_vae
from mdu_tpu.tiling import tiled_vae as jtvae
from mdu_tpu_torch.models import AutoencoderKL, load_jax_params, tiny_vae_config
from mdu_tpu_torch.tiling import tiled_vae

torch.set_num_threads(2)


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.fixture(scope="module")
def vae_pair():
    vae = JaxVAE(jax_tiny_vae())
    params = random_params(vae, 1, jnp.zeros((1, 3, 64, 64)), jax.random.PRNGKey(0))
    port = load_jax_params(AutoencoderKL(tiny_vae_config()),
                           jax.tree.map(np.asarray, params)).eval()
    return vae, params, port


def _image(seed, shape):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 0.4
    return np.clip(x, -1, 1)


@pytest.mark.parametrize("h,w,tile", [(2048, 2048, 1024), (8192, 8192, 512), (192, 192, 64),
                                      (200, 136, 48), (96, 96, 64)])
def test_encoder_plan_matches_jax(h, w, tile):
    """Config 3's encode (4 tiles of 1056), the 8K's (256 of 576), small ones."""
    got = tiled_vae.plan_vae_tiles(h, w, tile, tiled_vae.ENCODER_PAD)
    want = jtvae.plan_vae_tiles(h, w, tile, jtvae.ENCODER_PAD)
    assert tiled_vae.ENCODER_PAD == jtvae.ENCODER_PAD == 32
    if want is None:
        assert got is None
        return
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    if (h, tile) == (2048, 1024):
        assert (got.num_tiles, got.in_h) == (4, 1056)
    if (h, tile) == (8192, 512):
        assert (got.num_tiles, got.in_h) == (256, 576)


def test_footprints_match_jax():
    for which in ("encoder", "decoder"):
        for ts, n, b, tb in ((1024, 4, 1, 8), (64, 16, 1, 8), (512, 256, 2, 4)):
            assert (tiled_vae.lockstep_footprint_bytes(which, ts, n, b)
                    == jtvae.lockstep_footprint_bytes(which, ts, n, b))
            assert (tiled_vae.fast_footprint_bytes(which, ts, n, b, tb)
                    == jtvae.fast_footprint_bytes(which, ts, n, b, tb))


@pytest.mark.parametrize("mode", ["untiled", "exact_tiled"])
def test_encode_matches_jax(vae_pair, mode):
    """192 x 192 px; exact tiled at tile 64: 4 lockstep tiles of 128 with
    pooled statistics."""
    vae, params, port = vae_pair
    x = _image(0, (1, 3, 192, 192))
    if mode == "untiled":
        want = jax.jit(lambda x: vae.apply(params, x, method=vae.encode_moments))(x)
        with torch.no_grad():
            got = port.encode_moments(torch.from_numpy(x))
    else:
        want = jax.jit(lambda x: jtvae.tiled_vae_encode_moments(vae, params, x, 64))(x)
        with torch.no_grad():
            got = tiled_vae.tiled_vae_encode_moments(port, torch.from_numpy(x), 64)
    assert got.shape == (1, 8, 24, 24)
    _close(got, want)


@pytest.mark.parametrize("color_fix", [False, True])
def test_fast_encode_matches_jax(vae_pair, color_fix):
    """2 images of 200 x 136 px at tile 48: 4 x 2 tiles of 112 x 104 in chunks
    of tile_batch 3 x B 2 = 6 (the last chunk padded); with ``color_fix`` the
    estimated statistics before the first downsample and pooled ones after."""
    vae, params, port = vae_pair
    x = _image(1, (2, 3, 200, 136))
    fn = lambda x: jtvae.tiled_vae_encode_moments(               # noqa: E731
        vae, params, x, 48, fast=True, tile_batch=3, color_fix=color_fix)
    want = jax.jit(fn)(x)
    with torch.no_grad():
        got = tiled_vae.tiled_vae_encode_moments(port, torch.from_numpy(x), 48, fast=True,
                                                 tile_batch=3, color_fix=color_fix)
    assert got.shape == (2, 8, 25, 17)
    _close(got, want)


def test_fast_decode_matches_jax(vae_pair):
    """A 40 x 34 latent at tile 8: 16 tiles of 30 x 30 (halo 11) in chunks of
    tile_batch 5 (the last padded), statistics from a nearest-exact 8 x 8
    (moved to the latent's per-channel mean and population std)."""
    vae, params, port = vae_pair
    z = np.random.default_rng(2).normal(size=(1, 4, 40, 34)).astype(np.float32)
    fn = lambda z: jtvae.tiled_vae_decode(vae, params, z, 8, fast=True,   # noqa: E731
                                          tile_batch=5)
    want = jax.jit(fn)(z)
    with torch.no_grad():
        got = tiled_vae.tiled_vae_decode(port, torch.from_numpy(z), 8, fast=True,
                                         tile_batch=5)
    assert got.shape == (1, 3, 320, 272)
    _close(got, want)
