"""The dp x tp train step (``mdu_tpu_torch/parallel/training.py``) and the
flash backward's plain version, on the CPU.

* The port's step on ``["cpu"] * 8`` (dp = 4, tp = 2) against
  ``mdu_tpu.parallel.make_train_step`` on the JAX tests' 8 CPU devices: a
  one-level tiny UNet in fp32, JAX's draws (``split(key)`` -> ``randint``,
  ``normal``) fed to the port, two steps. The loss within 1e-5 relative; the
  gradient through AdamW's first moment (mu = 0.1 g after the first step)
  within 1e-4 of its largest entry. Adam's first step is lr * g / (|g| +
  eps): where |g| is within rounding of 0 its sign is noise on both sides,
  so the updated parameters are compared within 1e-3 * lr where |g| is at
  least 10x the gradient's tolerance, and elsewhere held to Adam's bound
  |step| <= lr * (1 + wd |theta|) (plus the fp32 rounding of the
  difference). The second step compares loss, mu and nu
  within 1e-4 (its gradient is taken at the parameters that differ by that
  noise).
* v-prediction: the port's step loss against the v target on JAX's UNet
  forward (one forward compile); on the port, dp = 2 x tp = 2 and remat
  against dp = tp = 1.
* ``param_shardings`` name for name against JAX's; each tp device holds only
  its slices; a batch with ``added_cond`` refused on both sides.
* The fault the port decides: ``jax.grad`` through an interpret-mode Pallas
  flash kernel raises (jax 0.9.0: an AssertionError in ``pallas_call``'s JVP
  rule). ``flash_attention_bwd_plain`` against autograd of each
  forward's plain version and against ``jax.grad`` of ``ops/attention.py::
  sdpa``.
* On a CPU tensor the flash wrappers run their plain versions, which
  autograd differentiates (``tests/test_torch_kernels_gpu.py`` holds the
  backward kernel and the refusals of #4-#6 on the card).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from mdu_tpu.models import UNet2DCondition as JaxUNet
from mdu_tpu.models import random_params
from mdu_tpu.models.unet import UNetConfig as JaxUNetConfig
from mdu_tpu.ops.attention import sdpa as jax_sdpa
from mdu_tpu.ops.pallas.flash_attention import flash_attention_t_fm as jax_flash_t_fm
from mdu_tpu.parallel import make_train_mesh as jax_train_mesh
from mdu_tpu.parallel import make_train_step as jax_train_step
from mdu_tpu.parallel import param_shardings as jax_param_shardings
from mdu_tpu.samplers import NoiseSchedule as JaxSchedule
from mdu_tpu_torch.models import UNet2DCondition, load_jax_params
from mdu_tpu_torch.models.unet import UNetConfig
from mdu_tpu_torch.ops.kernels import (flash_attention_bwd_plain, flash_attention_fm,
                                       flash_attention_plain, flash_attention_t)
from mdu_tpu_torch.ops.kernels.flash import flash_attention_fm_plain
from mdu_tpu_torch.parallel import (NamedSharding, TrainMesh, make_train_mesh,
                                    make_train_step, param_shardings, replicated)
from mdu_tpu_torch.samplers.schedule import NoiseSchedule

torch.set_num_threads(2)
# one level with a transformer: every split kind (q, k, v, GEGLU proj,
# time_emb_proj; to_out, ff.out) divides by tp = 2, and JAX compiles the
# sharded train step in about two thirds of a two-level UNet's time
ONE_LEVEL = dict(block_out_channels=(16,), cross_attention_dim=16, num_heads=2,
                 transformer_layers=(1,), norm_num_groups=4)
B, L, LR, WD = 4, 7, 1e-5, 1e-4
KEYS = (1, 2)


def _flat(tree):
    tree = tree["params"] if "params" in tree else tree
    return {k.replace("/", "."): np.asarray(v)
            for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def _jax_draws(seed, shape):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    t = jax.random.randint(k1, (shape[0],), 0, 1000)
    return {"t": torch.from_numpy(np.asarray(t).astype(np.int64)),
            "noise": torch.from_numpy(np.array(jax.random.normal(k2, shape, jnp.float32)))}


def _batch(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 4, 16, 16)).astype(np.float32),
            rng.normal(size=(n, L, 16)).astype(np.float32))


def _jax_run(dp, tp, n, schedule=None, remat=False):
    """Two JAX steps on a dp x tp mesh of the CPU devices: each step's loss,
    parameters and AdamW moments, the initial parameters, and what a batch
    with ``added_cond`` raised."""
    unet = JaxUNet(JaxUNetConfig(**ONE_LEVEL))
    lat, ctx = _batch(0, n)
    params = random_params(unet, 0, jnp.asarray(lat[:1]), jnp.zeros((1,)),
                           jnp.asarray(ctx[:1]))
    run = {"params0": _flat(params), "lat": lat, "ctx": ctx, "steps": []}
    mesh = jax_train_mesh(dp, tp)
    init_state, jitted = jax_train_step(unet, mesh, schedule=schedule, remat=remat)
    batch = {"latents": jnp.asarray(lat), "context": jnp.asarray(ctx)}
    with mesh:
        params, opt_state, p_shard = init_state(params)
        run["specs"] = {k.replace("/", "."): tuple(v.spec) for k, v in
                        traverse_util.flatten_dict(p_shard["params"], sep="/").items()}
        step = jitted(p_shard)
        for seed in KEYS:
            params, opt_state, loss = step(params, opt_state, batch, jax.random.PRNGKey(seed))
            adam = opt_state[0]
            run["steps"].append(dict(loss=float(loss), params=_flat(params),
                                     mu=_flat(adam.mu), nu=_flat(adam.nu)))
        try:
            step(params, opt_state, {**batch, "added_cond": {"time_ids": jnp.zeros((n, 6))}},
                 jax.random.PRNGKey(3))
            run["added_cond"] = None
        except ValueError as exc:
            run["added_cond"] = str(exc)
    return run


def _port_run(run, dp, tp, schedule=None, remat=False):
    unet = load_jax_params(UNet2DCondition(UNetConfig(**ONE_LEVEL)),
                           {"params": {k: v for k, v in run["params0"].items()}})
    mesh = make_train_mesh(dp, tp, devices=["cpu"] * (dp * tp))
    init_state, jitted = make_train_step(unet, mesh, schedule=schedule, remat=remat)
    params, opt_state, p_shard = init_state()
    step = jitted(p_shard)
    batch = {"latents": torch.from_numpy(run["lat"]), "context": torch.from_numpy(run["ctx"])}
    steps = []
    for seed in KEYS:
        params, opt_state, loss = step(params, opt_state, batch,
                                       _jax_draws(seed, run["lat"].shape))
        sd = params.state_dict()
        # copies: the next step updates the tensors in place
        steps.append(dict(loss=loss.item(), params={k: v.numpy().copy() for k, v in sd.items()},
                          mu={k: opt_state.moment("exp_avg", k).numpy().copy() for k in sd},
                          nu={k: opt_state.moment("exp_avg_sq", k).numpy().copy()
                              for k in sd}))
    return dict(steps=steps, state=params, opt=opt_state, step=step, batch=batch)


@pytest.fixture(scope="module")
def epsilon():
    """JAX's dp = 4 x tp = 2 steps (the first compile) and the port's."""
    run = _jax_run(4, 2, B)
    return run, _port_run(run, 4, 2)


def _max(tree):
    return max(np.abs(v).max() for v in tree.values())


def _hold_first_step(jax_step, port_step, params0):
    """Loss, gradient (mu = 0.1 g) and Adam's first update, as the module
    docstring states."""
    assert abs(port_step["loss"] - jax_step["loss"]) <= 1e-5 * abs(jax_step["loss"])
    g_tol = 1e-4 * _max(jax_step["mu"])
    for name, mu in jax_step["mu"].items():
        np.testing.assert_allclose(port_step["mu"][name], mu, rtol=0, atol=g_tol,
                                   err_msg=name)
    for name, theta1 in jax_step["params"].items():
        got = port_step["params"][name] - params0[name]
        want = theta1 - params0[name]
        firm = np.abs(jax_step["mu"][name]) >= 10 * g_tol
        np.testing.assert_allclose(got[firm], want[firm], rtol=0, atol=1e-3 * LR,
                                   err_msg=name)
        # Adam's bound, and the fp32 rounding of theta_1 - theta_0
        bound = LR * (1 + WD * np.abs(params0[name])) + 2 * np.spacing(np.abs(params0[name]))
        assert (np.abs(got) <= bound).all(), name


@pytest.mark.parametrize("part", ["loss_and_gradient", "second_step"])
def test_train_step_dp4_tp2_matches_jax(epsilon, part):
    run, port = epsilon
    if part == "loss_and_gradient":
        _hold_first_step(run["steps"][0], port["steps"][0], run["params0"])
        return
    jax_step, port_step = run["steps"][1], port["steps"][1]
    assert abs(port_step["loss"] - jax_step["loss"]) <= 1e-4 * abs(jax_step["loss"])
    for key in ("mu", "nu"):
        tol = 1e-4 * _max(jax_step[key])
        for name, want in jax_step[key].items():
            np.testing.assert_allclose(port_step[key][name], want, rtol=0, atol=tol,
                                       err_msg=f"{key} {name}")


def test_v_prediction_loss_matches_jax(epsilon):
    """Under ``v_prediction`` the port's step (dp = 2, tp = 1) takes the
    loss against sqrt(a) noise - sqrt(1 - a) x0 (``mdu_tpu/parallel/
    training.py:83-86``): its loss equals the one computed from JAX's UNet
    forward on the same x_t, within 1e-5 relative."""
    run, _ = epsilon
    sch = dataclasses.replace(NoiseSchedule(), prediction_type="v_prediction")
    unet = load_jax_params(UNet2DCondition(UNetConfig(**ONE_LEVEL)), {"params": run["params0"]})
    init_state, jitted = make_train_step(unet, make_train_mesh(2, 1, devices=["cpu"] * 2),
                                         schedule=sch)
    params, opt, sh = init_state()
    draws = _jax_draws(1, run["lat"].shape)
    _, _, loss = jitted(sh)(params, opt, {"latents": torch.from_numpy(run["lat"]),
                                          "context": torch.from_numpy(run["ctx"])}, draws)
    a = np.asarray(JaxSchedule().alphas_cumprod, np.float32)[draws["t"].numpy()]
    a = a.reshape(-1, 1, 1, 1)
    noise = draws["noise"].numpy()
    x_t = np.sqrt(a) * run["lat"] + np.sqrt(1 - a) * noise
    jparams = {"params": traverse_util.unflatten_dict(
        {k.replace(".", "/"): jnp.asarray(v) for k, v in run["params0"].items()}, sep="/")}
    pred = np.asarray(JaxUNet(JaxUNetConfig(**ONE_LEVEL)).apply(
        jparams, jnp.asarray(x_t), jnp.asarray(draws["t"].numpy(), jnp.float32),
        jnp.asarray(run["ctx"])))
    want = np.mean((pred - (np.sqrt(a) * noise - np.sqrt(1 - a) * run["lat"])) ** 2)
    assert abs(loss.item() - want) <= 1e-5 * want


@pytest.mark.parametrize("case", ["dp2_tp2", "remat"])
def test_port_step_matches_one_replica(epsilon, case):
    """dp = 2 x tp = 2, and dp = tp = 1 under remat, against the port's dp =
    tp = 1 on the same draws: the gradients agree within 1e-5 of their
    largest entry (dp adds two half-batch gradients; tp adds the row-parallel
    partials), the losses within 1e-6; remat recomputes the same forward, so
    its step equals the plain one to the bit."""
    run, _ = epsilon
    ref = _port_run(run, 1, 1)["steps"]
    got = _port_run(run, 2, 2)["steps"] if case == "dp2_tp2" else \
        _port_run(run, 1, 1, remat=True)["steps"]
    for a, b in zip(got, ref):
        if case == "remat":
            assert a["loss"] == b["loss"]
            for name in b["params"]:
                np.testing.assert_array_equal(a["params"][name], b["params"][name])
            continue
        assert abs(a["loss"] - b["loss"]) <= 1e-6 * abs(b["loss"])
        tol = 1e-5 * _max(b["mu"])
        for name in b["mu"]:
            np.testing.assert_allclose(a["mu"][name], b["mu"][name], rtol=0, atol=tol)


def test_param_shardings_match_jax(epsilon):
    """Name for name, the JAX rule on the port's ``state_dict`` names; the
    suffix traps: ``time_emb_proj`` column-parallel, a linear ``proj_out``
    row-parallel (SDXL's linear projection)."""
    run, port = epsilon
    specs = {k: s.spec for k, s in port["state"].shardings.items()}
    assert specs == run["specs"]
    assert specs["down_0_res_0.time_emb_proj.weight"] == ("tp", None)
    assert specs["down_0_attn_0.block_0.ff.out.weight"] == (None, "tp")
    assert specs["down_0_attn_0.block_0.ff.proj.weight"] == ("tp", None)
    lin = UNet2DCondition(UNetConfig(**dict(ONE_LEVEL, use_linear_projection=True)))
    mesh = make_train_mesh(1, 2, devices=["cpu"] * 2)
    sh = param_shardings(lin, mesh)
    jsh = jax_param_shardings({k.replace(".", "/"): jnp.zeros(v.shape)
                               for k, v in lin.state_dict().items()},
                              jax_train_mesh(1, 2))
    assert {k: s.spec for k, s in sh.items()} == {
        k.replace("/", "."): tuple(v.spec)
        for k, v in traverse_util.flatten_dict(jsh, sep="/").items()}
    assert sh["down_0_attn_0.proj_out.weight"].spec == (None, "tp")
    assert sh["down_0_attn_0.proj_in.weight"].spec == ()
    assert replicated(mesh) == NamedSharding(mesh, ())


def test_each_tp_device_holds_only_its_slices(epsilon):
    run, port = epsilon
    state, mesh = port["state"], port["state"].mesh
    assert isinstance(mesh, TrainMesh) and mesh.shape == {"dp": 4, "tp": 2}
    full = run["params0"]
    for name, sharding in state.shardings.items():
        for r in range(mesh.dp):
            held = state.shards(name, r)
            if sharding.spec == ():
                assert len(held) == 1 and tuple(held[0].shape) == full[name].shape
                continue
            dim = 0 if sharding.spec == ("tp", None) else 1
            assert len(held) == 2
            for j, t in enumerate(held):
                want = list(full[name].shape)
                want[dim] //= 2
                assert list(t.shape) == want and t.device == mesh.devices[r][j]
    # the replicas stay equal to the bit
    sd0 = state.state_dict(0)
    for r in range(1, mesh.dp):
        for name, t in state.state_dict(r).items():
            assert torch.equal(t, sd0[name])


def test_added_cond_is_refused_on_both_sides(epsilon):
    run, port = epsilon
    assert run["added_cond"] is not None          # jax.jit: the batch's pytree
    batch = {**port["batch"], "added_cond": {"time_ids": torch.zeros(B, 6)}}
    with pytest.raises(ValueError, match="added_cond"):
        port["step"](port["state"], port["opt"], batch, _jax_draws(3, (B, 4, 16, 16)))


def test_train_mesh_rules():
    mesh = make_train_mesh(2, 2, devices=["cpu"] * 4)
    assert mesh.devices == ((torch.device("cpu"),) * 2,) * 2
    with pytest.raises(ValueError, match="need 6 devices"):
        make_train_mesh(3, 2, devices=["cpu"] * 4)
    with pytest.raises(TypeError):
        make_train_step(UNet2DCondition(UNetConfig(**ONE_LEVEL)), mesh=object())
    unet = UNet2DCondition(UNetConfig(**ONE_LEVEL))
    init_state, jitted = make_train_step(unet, make_train_mesh(2, 1, devices=["cpu"] * 2))
    params, opt, sh = init_state()
    lat = torch.zeros(3, 4, 16, 16)
    with pytest.raises(ValueError, match="does not split"):
        jitted(sh)(params, opt, {"latents": lat, "context": torch.zeros(3, L, 16)},
                   torch.Generator().manual_seed(0))


def test_jax_grad_through_a_pallas_flash_kernel_raises(rng):
    """The JAX package's Pallas kernels have no transpose rule, so a train
    step through one fails; the port gives #1-#3 a backward kernel."""
    q = jnp.asarray(rng.normal(size=(1, 1, 128, 16)).astype(np.float32))

    def loss(q):
        return jax_flash_t_fm(q, q, q, interpret=True).sum()

    # jax 0.9.0 on the CPU: an AssertionError in pallas_call's JVP rule
    with pytest.raises((AssertionError, ValueError, NotImplementedError)) as exc:
        jax.grad(loss)(q)
    assert any("pallas" in str(entry.path) for entry in exc.traceback)


@pytest.mark.parametrize("shape", [(2, 3, 100, 40, 77), (1, 2, 64, 80, 130),
                                   (1, 1, 33, 160, 33)])
def test_flash_backward_plain_matches_autograd_and_jax(rng, shape):
    b, h, lq, d, lk = shape
    q, do = (rng.normal(size=(b, h, lq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(b, h, lk, d)).astype(np.float32) for _ in range(2))
    o = flash_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)))
    got = flash_attention_bwd_plain(*(torch.from_numpy(x) for x in (q, k, v)), o,
                                    torch.from_numpy(do))
    _, vjp = jax.vjp(jax_sdpa, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
    for fwd in (flash_attention_plain, flash_attention_fm_plain):
        ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        ref = torch.autograd.grad(fwd(*ts), ts, torch.from_numpy(do))
        for g, r in zip(got, ref):
            assert (g - r).abs().max().item() <= 1e-5 * r.abs().max().item()


def test_kernel_wrappers_differentiate_their_plain_version_on_the_cpu(rng):
    """On a CPU tensor each wrapper runs its plain version, so autograd
    gives the plain version's gradient there (the card's backward kernel is
    held to it by ``chip_smoke.py``)."""
    x = torch.from_numpy(rng.normal(size=(1, 2, 40, 16)).astype(np.float32))
    for fn in (flash_attention_fm, flash_attention_t):
        q = x.clone().requires_grad_()
        fn(q, x, x).sum().backward()
        assert q.grad is not None and torch.isfinite(q.grad).all()
