"""The dp x tp train step (counterpart of ``mdu_tpu/parallel/training.py``).

* dp: the batch splits over the mesh's rows. Each row holds a replica of
  the UNet and computes its loss and gradient on its part; the gradients
  are added on the first replica's device in dp order and divided by dp
  (as ``ShardReducer`` adds), every replica takes the same AdamW step on
  them, so the replicas stay equal to the bit.
* tp: the linears that ``param_shardings`` splits live as slices on the tp
  devices of each row: a column-parallel weight's rows (the attention's q,
  k, v, the GEGLU's ``proj``, ``time_emb_proj``), a row-parallel weight's
  columns (``to_out``, ``ff.out``). The forward computes the unsharded
  function: the column slices' outputs are concatenated (so the GEGLU
  splits h and gate after the gather), the row slices' partial products
  added in shard order, the bias added once.

Loss: DDPM epsilon-MSE, or the v target under ``v_prediction``; optimiser:
optax's ``adamw(lr)`` (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4), as
the JAX step. One process drives every device, one replica after another.

On the card each long self-attention runs a flash kernel whose gradient
comes from ``csrc/flash_attention_bwd.cu`` (``ops/kernels/flash.py``); the
kernels with no backward (#4, #6, behind their flags) raise under grad.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..models.layers import Linear
from ..samplers.schedule import NoiseSchedule
from .mesh import NamedSharding, TrainMesh

__all__ = ["param_shardings", "make_train_step", "TrainState", "AdamWState"]

# [out, in] linear weights whose OUT dim splits over tp (column parallel)
_COL_PARALLEL = ("to_q/weight", "to_k/weight", "to_v/weight", "proj/weight",
                 "fc1/weight", "q/weight", "k/weight", "v/weight")
# [out, in] linear weights whose IN dim splits over tp (row parallel)
_ROW_PARALLEL = ("to_out/weight", "out/weight", "fc2/weight")
COL, ROW = ("tp", None), (None, "tp")
ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)   # optax.adamw's defaults


def param_shardings(params, mesh) -> Dict[str, NamedSharding]:
    """``NamedSharding`` of each parameter (a state_dict or a module), by the
    JAX rule on the name with ``.`` read as ``/``: 2-D leaves only, suffix
    matches, and the split dim divisible by tp; the rest replicated."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    tp = mesh.shape.get("tp", 1)
    out = {}
    for name, leaf in params.items():
        key, spec = name.replace(".", "/"), ()
        if tp > 1 and leaf.dim() == 2:
            if key.endswith(_COL_PARALLEL) and leaf.shape[0] % tp == 0:
                spec = COL
            elif key.endswith(_ROW_PARALLEL) and leaf.shape[1] % tp == 0:
                spec = ROW
        out[name] = NamedSharding(mesh, spec)
    return out


class _ParallelLinear(nn.Module):
    """A ``Linear`` whose weight lies in tp slices, slice j on ``devices[j]``:
    rows (``COL``: each slice's outputs concatenated) or columns (``ROW``:
    each slice's partial product on its part of the input, added in shard
    order). The bias, if any, stays whole on ``devices[0]`` and is added
    once; the output is on ``devices[0]``."""

    def __init__(self, lin: Linear, spec, devices):
        super().__init__()
        self.dtype, self.spec, self.devices = lin.dtype, spec, tuple(devices)
        dim = 0 if spec == COL else 1
        w = lin.weight.detach()
        self.shards = nn.ParameterList(
            nn.Parameter(c.to(d, copy=True)) for c, d in zip(w.chunk(len(devices), dim),
                                                            devices))
        self.bias = (nn.Parameter(lin.bias.detach().to(devices[0], copy=True))
                     if lin.bias is not None else None)

    def full_weight(self) -> torch.Tensor:
        dim = 0 if self.spec == COL else 1
        return torch.cat([s.detach().to(self.devices[0]) for s in self.shards], dim)

    def forward(self, x):
        home = self.devices[0]
        x = x.to(self.dtype)
        if self.spec == COL:
            y = torch.cat([F.linear(x.to(d), w.to(self.dtype)).to(home)
                           for w, d in zip(self.shards, self.devices)], dim=-1)
        else:
            parts = x.split([w.shape[1] for w in self.shards], dim=-1)
            y = None
            for part, w, d in zip(parts, self.shards, self.devices):
                p = F.linear(part.to(d), w.to(self.dtype)).to(home)
                y = p if y is None else y + p
        return y if self.bias is None else y + self.bias.to(self.dtype)


class TrainState:
    """The replicas of one train step: ``replicas[r]`` is the UNet of dp row
    r, its split linears on that row's tp devices."""

    def __init__(self, mesh: TrainMesh, replicas: List[nn.Module], names: List[str],
                 shardings: Dict[str, NamedSharding]):
        self.mesh, self.replicas, self.names, self.shardings = mesh, replicas, names, shardings

    def _leaf(self, replica: nn.Module, name: str):
        spec = self.shardings[name].spec
        if spec == ():
            return replica.get_parameter(name)
        return replica.get_submodule(name.rsplit(".", 1)[0])

    def shards(self, name: str, replica: int = 0) -> List[torch.Tensor]:
        """The tensors that hold parameter ``name`` in dp row ``replica``: its
        tp slices, or the one replicated tensor."""
        leaf = self._leaf(self.replicas[replica], name)
        return list(leaf.shards) if isinstance(leaf, _ParallelLinear) else [leaf]

    def state_dict(self, replica: int = 0) -> Dict[str, torch.Tensor]:
        """The whole parameters of dp row ``replica`` (slices gathered onto
        the row's first device), under the UNet's own names."""
        out = {}
        for name in self.names:
            leaf = self._leaf(self.replicas[replica], name)
            out[name] = (leaf.full_weight() if isinstance(leaf, _ParallelLinear)
                         else leaf.detach())
        return out


class AdamWState:
    """One ``torch.optim.AdamW`` a dp row, over that row's tensors."""

    def __init__(self, state: TrainState, lr: float):
        self.state = state
        self.optimizers = [torch.optim.AdamW(rep.parameters(), lr=lr, **ADAMW)
                           for rep in state.replicas]

    def moment(self, key: str, name: str, replica: int = 0) -> Optional[torch.Tensor]:
        """AdamW's ``exp_avg`` or ``exp_avg_sq`` of parameter ``name``
        (optax's mu or nu), its slices gathered; None before the first step."""
        opt = self.optimizers[replica]
        parts = [opt.state[p][key].to(self.state.mesh.devices[replica][0])
                 for p in self.state.shards(name, replica) if p in opt.state]
        if not parts:
            return None
        spec = self.state.shardings[name].spec
        return parts[0] if spec == () else torch.cat(parts, 0 if spec == COL else 1)


def _split_linears(module: nn.Module, shardings: Dict[str, NamedSharding], devices) -> None:
    for prefix, sub in list(module.named_modules()):
        if not isinstance(sub, Linear):
            continue
        spec = shardings[f"{prefix}.weight"].spec
        if spec == ():
            continue
        parent_name, _, attr = prefix.rpartition(".")
        parent = module.get_submodule(parent_name) if parent_name else module
        setattr(parent, attr, _ParallelLinear(sub, spec, devices))


def _draws(key, lat: torch.Tensor, num_train_timesteps: int):
    """(t, noise) of a step: given as ``{"t": ..., "noise": ...}``, or drawn
    from a ``torch.Generator`` (t first, then the noise)."""
    if isinstance(key, Mapping):
        return torch.as_tensor(key["t"]), torch.as_tensor(key["noise"])
    if isinstance(key, torch.Generator):
        t = torch.randint(0, num_train_timesteps, (lat.shape[0],), generator=key,
                          device=key.device)
        noise = torch.randn(lat.shape, generator=key, device=key.device, dtype=lat.dtype)
        return t, noise
    raise TypeError(f"a step's key is a torch.Generator or {{'t', 'noise'}}, got {type(key)}")


def make_train_step(unet: nn.Module, mesh: TrainMesh, schedule: Optional[NoiseSchedule] = None,
                    learning_rate: float = 1e-5, remat: bool = False):
    """Returns ``(init_state, jitted_step)`` with the JAX step's contract:
    ``params, opt_state, p_shard = init_state(params)`` (``params`` a
    state_dict of ``unet``, or None for its own), ``step = jitted_step(p_shard)``,
    ``params, opt_state, loss = step(params, opt_state, batch, key)``.
    ``batch`` = {"latents": [B, 4, h, w], "context": [B, L, D]}; B splits
    over dp. ``key``: a ``torch.Generator``, or the step's draws as
    {"t": [B] ints, "noise": like latents}. ``remat`` recomputes the UNet's
    forward in the backward (``torch.utils.checkpoint``, non-reentrant)."""
    if not isinstance(mesh, TrainMesh):
        raise TypeError(f"make_train_step takes a make_train_mesh mesh, got {type(mesh)}")
    schedule = schedule or NoiseSchedule()
    alphas = torch.as_tensor(np.asarray(schedule.alphas_cumprod), dtype=torch.float32)
    v_target = schedule.prediction_type == "v_prediction"

    def init_state(params: Optional[Mapping[str, torch.Tensor]] = None):
        params = dict(unet.state_dict() if params is None else params)
        shardings = param_shardings(params, mesh)
        replicas = []
        for row in mesh.devices:
            rep = copy.deepcopy(unet)
            rep.load_state_dict(params)
            rep = rep.to(row[0])
            _split_linears(rep, shardings, row)
            replicas.append(rep.train())
        state = TrainState(mesh, replicas, list(params), shardings)
        return state, AdamWState(state, learning_rate), shardings

    def loss_fn(rep, lat, ctx, t, noise):
        a = alphas.to(lat.device)[t].reshape(-1, 1, 1, 1)
        x_t = torch.sqrt(a) * lat + torch.sqrt(1 - a) * noise
        tf = t.to(torch.float32)
        pred = (checkpoint(rep, x_t, tf, ctx, use_reentrant=False) if remat
                else rep(x_t, tf, ctx))
        target = torch.sqrt(a) * noise - torch.sqrt(1 - a) * lat if v_target else noise
        return torch.mean((pred - target) ** 2)

    def train_step(params: TrainState, opt_state: AdamWState, batch, key):
        extra = set(batch) - {"latents", "context"}
        if extra:
            raise ValueError(
                f"the batch holds {sorted(extra)}: the step takes only 'latents' and "
                f"'context', as the JAX step does (its batch sharding names those two "
                f"keys, so jax.jit refuses a batch with 'added_cond'; ROADMAP, the JAX "
                f"package's known faults)")
        lat, ctx = batch["latents"], batch["context"]
        B, dp = lat.shape[0], mesh.dp
        if B % dp:
            raise ValueError(f"a batch of {B} does not split over dp = {dp}")
        t, noise = _draws(key, lat, schedule.num_train_timesteps)
        n = B // dp
        losses = []
        for r, rep in enumerate(params.replicas):
            home = mesh.devices[r][0]
            part = slice(r * n, (r + 1) * n)
            rep.zero_grad(set_to_none=True)
            loss = loss_fn(rep, lat[part].to(home), ctx[part].to(home), t[part].to(home),
                           noise[part].to(home))
            loss.backward()
            losses.append(loss.detach())
        # the dp mean of each gradient, added on replica 0's device in dp order
        per_replica = [list(rep.parameters()) for rep in params.replicas]
        for tensors in zip(*per_replica):
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in tensors]
            total = grads[0].clone()
            for g in grads[1:]:
                total += g.to(total.device)
            total /= dp
            for p in tensors:
                p.grad = total.to(p.device, copy=True)
        for opt in opt_state.optimizers:
            opt.step()
        root = mesh.devices[0][0]
        loss = losses[0].to(root)
        for other in losses[1:]:
            loss = loss + other.to(root)
        return params, opt_state, loss / dp

    def jitted_step(p_shard):
        """The step for parameters laid out as ``p_shard`` (what
        ``init_state`` returned); the port runs it eagerly."""
        return train_step

    return init_state, jitted_step
