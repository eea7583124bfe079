"""Port parity: the plain versions of the two flash kernels against the JAX
Pallas kernels in interpret mode, and the port's attention dispatch against
``mdu_tpu.ops.attention``. Tolerances as in tests/test_pallas.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdu_tpu.ops.attention import multi_head_attention as jax_mha
from mdu_tpu.ops.attention import sdpa as jax_sdpa
from mdu_tpu.ops.pallas import flash_attention as jax_flash
from mdu_tpu.ops.pallas import flash_attention_t_fm as jax_flash_fm
from mdu_tpu_torch.ops import attention as port_attention
from mdu_tpu_torch.ops.kernels import (LAUNCHES, flash_attention, flash_attention_fm,
                                       flash_attention_fm_plain, flash_attention_plain)

torch.set_num_threads(2)
TOL = dict(rtol=2e-4, atol=2e-4)


def _qkv(rng, B, H, Lq, Lk, D):
    return tuple(rng.normal(size=(B, H, L, D)).astype(np.float32)
                 for L in (Lq, Lk, Lk))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("Lq,Lk,D", [
    (128, 128, 64),
    (200, 200, 40),     # unaligned L and D (SD1.5 head dim)
    (256, 77, 64),      # cross-attention shape: large kv padding on the TPU
    (513, 513, 160),
])
def test_fm_plain_matches_pallas(rng, Lq, Lk, D):
    q, k, v = _qkv(rng, 1, 2, Lq, Lk, D)
    want = np.asarray(jax_flash_fm(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   block_q=128, block_k=128, interpret=True))
    got = flash_attention_fm_plain(*_t(q, k, v)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("clamp", [False, True])
def test_fm_plain_extreme_logits(rng, clamp):
    """Logits beyond the default shift need smax = 60; with clamp=True the
    scores above smax are flattened exactly as the TPU kernel does."""
    q, k, v = _qkv(rng, 1, 1, 130, 130, 32)
    q[:, :, :64] *= 8.0
    kw = dict(smax=60.0, clamp=clamp)
    want = np.asarray(jax_flash_fm(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   block_q=128, block_k=128, interpret=True, **kw))
    got = flash_attention_fm_plain(*_t(q, k, v), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)


def test_fm_plain_clamp_flattens(rng):
    """clamp=True with a small smax changes the result, the same way on
    both sides."""
    q, k, v = _qkv(rng, 1, 1, 96, 96, 16)
    q *= 6.0
    want = np.asarray(jax_flash_fm(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   smax=5.0, clamp=True, interpret=True))
    got = flash_attention_fm_plain(*_t(q, k, v), smax=5.0, clamp=True).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    exact = np.asarray(jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    assert np.abs(got - exact).max() > 1e-2


@pytest.mark.parametrize("Lq,Lk,D", [
    (128, 128, 64),
    (200, 200, 40),
    (256, 77, 64),      # kv padding on the TPU, masked kv edge here
    (513, 513, 128),
])
def test_lane_plain_matches_pallas(rng, Lq, Lk, D):
    q, k, v = _qkv(rng, 1, 2, Lq, Lk, D)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                block_q=128, block_k=128, interpret=True))
    got = flash_attention_plain(*_t(q, k, v)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_lane_plain_scale_override(rng):
    q, k, v = _qkv(rng, 1, 1, 128, 128, 32)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                scale=0.05, interpret=True))
    got = flash_attention_plain(*_t(q, k, v), scale=0.05).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_plain_versions_round_p_like_the_kernels(rng):
    """In bf16 both plain versions round p to bf16 before the product and
    stay close to exact attention."""
    q, k, v = _qkv(rng, 1, 2, 96, 96, 40)
    exact = np.asarray(jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    qb, kb, vb = (x.to(torch.bfloat16) for x in _t(q, k, v))
    for fn in (flash_attention_fm_plain, flash_attention_plain):
        out = fn(qb, kb, vb)
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy(), exact, rtol=5e-2, atol=5e-2)


def test_wrappers_take_the_plain_version_on_cpu_only(rng):
    q, k, v = _t(*_qkv(rng, 1, 1, 64, 64, 16))
    before = dict(LAUNCHES)
    torch.testing.assert_close(flash_attention_fm(q, k, v), flash_attention_fm_plain(q, k, v),
                               rtol=0, atol=0)
    torch.testing.assert_close(flash_attention(q, k, v), flash_attention_plain(q, k, v),
                               rtol=0, atol=0)
    assert LAUNCHES == before                 # no kernel ran
    meta = [x.to("meta") for x in (q, k, v)]
    for fn in (flash_attention_fm, flash_attention):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*meta)


@pytest.mark.parametrize("B,Lq,Lk,H,D,q_chunk", [
    (2, 64, 64, 2, 8, None),
    (1, 100, 7, 2, 8, None),      # cross-attention
    (1, 96, 96, 1, 16, 32),       # chunked (VAE mid-block form)
])
def test_multi_head_attention_matches_jax(rng, B, Lq, Lk, H, D, q_chunk):
    q = rng.normal(size=(B, Lq, H * D)).astype(np.float32)
    k = rng.normal(size=(B, Lk, H * D)).astype(np.float32)
    v = rng.normal(size=(B, Lk, H * D)).astype(np.float32)
    want = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H,
                              q_chunk=q_chunk))
    got = port_attention.multi_head_attention(*_t(q, k, v), H, q_chunk=q_chunk).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_flash_variant_follows_head_dim():
    assert port_attention._flash_variant(512) is flash_attention
    assert port_attention._flash_variant(40) is flash_attention_fm
    assert port_attention._flash_variant(80) is flash_attention_fm
