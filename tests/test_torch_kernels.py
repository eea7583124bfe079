"""Port parity: the plain versions of the two flash kernels against the JAX
Pallas kernels in interpret mode, and the port's attention dispatch against
``mdu_tpu.ops.attention``. Tolerances as in tests/test_pallas.py."""
import math

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
    (300, 300, 512),    # the VAE's head width (the wide form's function)
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


# ------------------------------------------- the fp32 kernels' three TF32 passes


def _tf32_rna(x):
    """x rounded to tf32 (10 mantissa bits), to the nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds the big part."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_trunc(x):
    """x as the tensor cores read an fp32 word in tf32: the low 13 mantissa
    bits dropped."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def _mm3(a, b):
    """a @ b as the tensor-core forms run it: big = tf32(x), small = x - big,
    small.big + big.small + big.big with fp32 sums (a product of two tf32
    values is exact in fp32)."""
    ab, bb = _tf32_rna(a), _tf32_rna(b)
    sa, sb = _tf32_trunc(a - ab), _tf32_trunc(b - bb)
    return (sa @ bb + ab @ sb) + ab @ bb


def _emulated_attention(q, k, v, mm, online):
    scale = np.float32(q.shape[-1] ** -0.5)
    s = mm(q, np.swapaxes(k, -1, -2)) * scale
    shift = s.max(-1, keepdims=True) if online else np.float32(30.0)
    p = np.exp(s - shift).astype(np.float32)
    den = np.maximum(p.sum(-1, keepdims=True), np.float32(1e-30))
    return mm(p, v) / den


@pytest.mark.parametrize("shape,online", [((1, 2, 256, 40), False),
                                          ((1, 1, 256, 512), True)])
def test_three_tf32_passes_keep_fp32_precision(rng, shape, online):
    """The split of the fp32 tensor-core forms (csrc/flash_attention_f32_sm90.cuh),
    emulated in numpy on #1's fixed shift at config 2's D = 40 and #2's online
    softmax at the VAE's D = 512: within the kernels' 1e-4 bar of the fp32
    plain version, where one TF32 pass is not."""
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    plain = flash_attention_plain if online else flash_attention_fm_plain
    want = plain(*_t(q, k, v)).numpy()
    got = _emulated_attention(q, k, v, _mm3, online)
    assert np.abs(got - want).max() <= 1e-4
    one_pass = _emulated_attention(q, k, v, lambda a, b: _tf32_trunc(a) @ _tf32_trunc(b),
                                   online)
    assert np.abs(one_pass - want).max() > 1e-4


@pytest.mark.parametrize("D", [13, 40, 512])
def test_bf16_exp_exact_inputs_leave_no_score_ambiguous(rng, D):
    """The inputs of the card's bf16_exp checks: q and k small integers and a
    power-of-two scale (D^-0.5 rounded down). Every shifted score is then exact in fp32 (equal to
    its float64 value), whatever the order of the sum over d, so no score can
    round to another bf16 in a kernel than in the plain version: the plain
    version does not move, bit for bit, when q.k is summed in the reverse
    order."""
    q, k = (rng.integers(-2, 3, size=(1, 2, 256, D)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(1, 2, 256, D)).astype(np.float32)
    scale = 2.0 ** -math.ceil(math.log2(D) / 2)    # D^-0.5 rounded down
    e = np.einsum("bhid,bhjd->bhij", q.astype(np.float64), k.astype(np.float64)) * scale - 30.0
    assert (e.astype(np.float32) == e).all()
    assert e.std() > 1.0                 # the softmax is not flat
    tq, tk, tv = _t(q, k, v)
    got = flash_attention_fm_plain(tq, tk, tv, scale, bf16_exp=True)
    rev = flash_attention_fm_plain(tq.flip(-1).contiguous(), tk.flip(-1).contiguous(), tv,
                                   scale, bf16_exp=True)
    assert torch.equal(rev, got)
    assert (flash_attention_fm_plain(tq, tk, tv, scale) - got).abs().max() > 1e-3
