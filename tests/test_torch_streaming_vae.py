"""Port parity for the streaming exact tiled VAE: the op walk and its
segments, stream-host and stream-device decode and encode against the JAX
package's lockstep mode, the fp8 and fp32 spills, the group sizing and the
footprints under ``MDU_HBM_BYTES``, and the pipeline's choice of mode.
Tolerances: the JAX tests' own (``tests/test_tiled_vae.py``): streamed
decode within 2e-4, encode within 3e-4 (rtol and atol); fp8 spills a mean
error under 0.12 on [-1, 1] outputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdu_tpu.models import AutoencoderKL as JaxVAE
from mdu_tpu.models import random_params
from mdu_tpu.models import tiny_vae_config as jax_tiny_vae
from mdu_tpu.pipeline import DiffusionPipeline as JaxPipeline
from mdu_tpu.tiling import streaming_vae as jsv
from mdu_tpu.tiling import tiled_vae as jtvae
from mdu_tpu_torch import DiffusionPipeline, TiledVAEConfig
from mdu_tpu_torch.models import (AutoencoderKL, UNet2DCondition, load_jax_params,
                                  random_state_dict, tiny_unet_config, tiny_vae_config)
from mdu_tpu_torch.tiling import streaming_vae as sv
from mdu_tpu_torch.tiling import tiled_vae

torch.set_num_threads(2)
Z_SHAPE, X_SHAPE = (1, 4, 48, 48), (1, 3, 256, 256)
TOL = {"decoder": 2e-4, "encoder": 3e-4}


@pytest.fixture(scope="module")
def vae_pair():
    """The tiny VAE on both sides, the inputs, and JAX's lockstep results:
    decode at tile 24 (4 tiles of 46), encode at tile 128 (4 tiles of 192)."""
    vae = JaxVAE(jax_tiny_vae())
    params = random_params(vae, 7, jnp.zeros((1, 3, 64, 64)), jax.random.PRNGKey(0))
    port = load_jax_params(AutoencoderKL(tiny_vae_config()),
                           jax.tree.map(np.asarray, params)).eval()
    rng = np.random.default_rng(11)
    z = (rng.normal(size=Z_SHAPE) * 0.5).astype(np.float32)
    x = (rng.normal(size=X_SHAPE) * 0.3).astype(np.float32)
    want = {"decoder": np.asarray(jax.jit(
                lambda z: jtvae.tiled_vae_decode(vae, params, z, tile_size=24))(z)),
            "encoder": np.asarray(jax.jit(
                lambda x: jtvae.tiled_vae_encode_moments(vae, params, x, tile_size=128))(x))}
    return vae, params, port, {"decoder": z, "encoder": x}, want


def _stream(port, inputs, which, **kw):
    ts = 24 if which == "decoder" else 128
    return sv.streaming_tiled_vae(port, torch.from_numpy(inputs[which]), which, ts,
                                  group_size=2, **kw)


def test_op_walk_matches_jax(vae_pair):
    """The same ops in the same order, so the same segments, as the JAX walk
    over Flax's modules."""
    vae, params, port, _, _ = vae_pair
    bound = vae.bind(params)
    for ours, theirs in ((sv.decoder_ops(port), jsv.decoder_ops(bound)),
                         (sv.encoder_ops(port), jsv.encoder_ops(bound))):
        kinds = [k for k, _ in ours]
        assert kinds == [k for k, _ in theirs]
        spans = jsv._segment_spans(kinds)
        assert sv._segment_spans(kinds) == spans
        # the port carries one tensor across a ResnetBlock's first norm and
        # the attention's: the store_res before them moves into their segment
        carried = sv._carry_spans(kinds)
        assert len(carried) == len(spans) and carried[0][0] == 0
        assert all(a[1] == b[0] for a, b in zip(carried, carried[1:]))
        assert carried[-1][1] == len(kinds)
        moved = 0
        for (s0, e0), (s1, e1) in zip(spans, carried):
            assert s0 - s1 in (0, 1)
            if s0 != s1:                      # a store_res just before the norm
                assert (kinds[s1], kinds[s0]) == ("store_res", "norm")
                moved += 1
        assert moved == kinds.count("store_res")


@pytest.mark.parametrize("host_resident", [True, False], ids=["stream-host", "stream-device"])
@pytest.mark.parametrize("which", ["decoder", "encoder"])
def test_streamed_matches_jax_lockstep(vae_pair, which, host_resident):
    _, _, port, inputs, want = vae_pair
    got = _stream(port, inputs, which, host_resident=host_resident)
    assert got is not None and tuple(got.shape) == want[which].shape
    np.testing.assert_allclose(got.numpy(), want[which], rtol=TOL[which], atol=TOL[which])


def test_spills(vae_pair):
    """fp8 spills stay close to the full-precision stream-host decode (the
    statistics are pooled before the cast); an fp32 spill of an fp32 VAE is
    the same to the bit; the last segment's output keeps the VAE's dtype."""
    _, _, port, inputs, _ = vae_pair
    exact = _stream(port, inputs, "decoder")
    fp8 = _stream(port, inputs, "decoder", spill_dtype="float8_e4m3fn")
    assert fp8.dtype == exact.dtype == torch.float32 and torch.isfinite(fp8).all()
    err = (fp8 - exact).abs().mean().item()
    assert 0 < err < 0.12, err
    same = _stream(port, inputs, "decoder", spill_dtype="float32")
    torch.testing.assert_close(same, exact, rtol=0, atol=0)
    with pytest.raises(ValueError, match="spill dtype"):
        _stream(port, inputs, "decoder", spill_dtype="float9")


def test_bypass_small(vae_pair):
    _, _, port, _, _ = vae_pair
    assert sv.streaming_tiled_vae(port, torch.zeros(1, 4, 16, 16), "decoder", 96) is None


@pytest.mark.parametrize("budget_gib", [64, 8, 1])
def test_group_size_and_footprints_match_jax(monkeypatch, budget_gib):
    monkeypatch.setenv("MDU_HBM_BYTES", str(budget_gib * 2 ** 30))
    for args in (("decoder", 256, 256, 1, 4, True), ("decoder", 8192, 1088, 1, 4, True),
                 ("decoder", 2048, 1088, 1, 4, True), ("encoder", 1088, 1088, 2, 8, False),
                 ("encoder", 576, 576, 1, 3, True)):
        assert sv.auto_group_size(*args) == jsv.auto_group_size(*args), args
    for which in ("encoder", "decoder"):
        for ts, n, b, g in ((1024, 4, 1, 4), (64, 16, 1, 2), (64, 256, 1, 4), (512, 256, 2, 8)):
            assert (tiled_vae.segment_tile_bytes(which, ts)
                    == jtvae.segment_tile_bytes(which, ts))
            assert (tiled_vae.streaming_device_footprint_bytes(which, ts, n, b, g)
                    == jtvae.streaming_device_footprint_bytes(which, ts, n, b, g))


@pytest.mark.parametrize("which,tile,side", [("decoder", 64, 256), ("decoder", 64, 1024),
                                             ("encoder", 1024, 2048), ("encoder", 64, 640)])
def test_mode_choice_matches_jax(monkeypatch, which, tile, side):
    """Config 3's decode and encode, the 8K's decode and a small encode, at
    budgets around each footprint: the port's rule picks JAX's mode."""
    pad = tiled_vae.ENCODER_PAD if which == "encoder" else tiled_vae.DECODER_PAD
    plan = tiled_vae.plan_vae_tiles(side, side, tile, pad)
    marks = [tiled_vae.lockstep_footprint_bytes(which, tile, plan.num_tiles, 1),
             tiled_vae.streaming_device_footprint_bytes(which, tile, plan.num_tiles, 1, 1)]
    seen = set()
    for budget in [m + d for m in marks for d in (-1, 0, 1)] + [2 ** 40, 2 ** 20]:
        monkeypatch.setenv("MDU_HBM_BYTES", str(budget))
        want = JaxPipeline._exact_vae_mode(which, tile, side, side, 1, 1)
        assert sv.exact_vae_mode(which, tile, side, side, 1, 1, budget) == want
        seen.add(want)
    assert {"lockstep", "stream-host"} <= seen


@pytest.fixture(scope="module")
def pipe(vae_pair):
    _, _, port, _, _ = vae_pair
    unet = UNet2DCondition(tiny_unet_config())
    unet.load_state_dict(random_state_dict(unet, 0, device="cpu"))
    return DiffusionPipeline(unet, port, device="cpu")


def test_pipeline_streams_where_lockstep_does_not_fit(vae_pair, pipe, monkeypatch):
    """The pipeline's decode and encode under budgets that force each mode
    (its ``last_vae_mode``), each within the JAX tolerance of JAX's lockstep
    result; ``streaming=True`` means stream-host; fast modes never stream."""
    _, _, _, inputs, want = vae_pair
    tv = TiledVAEConfig(decoder_tile_size=24, encoder_tile_size=128, fast_decoder=False,
                        fast_encoder=False, tile_batch=2)
    lat = torch.from_numpy(inputs["decoder"]) * pipe.vae.cfg.scaling_factor
    img = torch.from_numpy(inputs["encoder"])
    for budget, mode in ((2 ** 40, "lockstep"), (1, "stream-host")):
        monkeypatch.setenv("MDU_HBM_BYTES", str(budget))
        for which, run in (("decoder", lambda: pipe._decode_tensor(lat, tv)),
                           ("encoder", lambda: pipe._encode(img, tv))):
            got = run()
            assert pipe.last_vae_mode == mode
            np.testing.assert_allclose(got.numpy(), want[which], rtol=TOL[which],
                                       atol=TOL[which])
    monkeypatch.delenv("MDU_HBM_BYTES")
    got = pipe._decode_tensor(lat, TiledVAEConfig(decoder_tile_size=24, fast_decoder=False,
                                                  streaming=True, tile_batch=2,
                                                  spill_dtype="float32"))
    assert pipe.last_vae_mode == "stream-host"
    np.testing.assert_allclose(got.numpy(), want["decoder"], rtol=2e-4, atol=2e-4)
    pipe._decode_tensor(lat, TiledVAEConfig(decoder_tile_size=24, streaming=False))
    assert pipe.last_vae_mode == "fast"
