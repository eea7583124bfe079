"""The tile mesh and the train mesh (counterpart of ``mdu_tpu/parallel/mesh.py``).

The JAX package's tile mesh is a ``jax.sharding.Mesh`` with one axis,
``tiles``, driven by one controller: ``shard_map`` runs a shard per device
and XLA places the gathers and the ``psum``. The port keeps that single
controller: a ``TileMesh`` is the list of ``torch.device``s the tile shards
run on, in shard order, and one process drives them all. A device may
repeat: ``make_tile_mesh(devices=["cuda:0"] * 2)`` runs two shards on one
card, and ``devices=["cpu"] * n`` gives n shards on the CPU, the port's
counterpart of the JAX tests' 8 virtual CPU devices.

``all_reduce`` is the mesh's one collective, the counterpart of ``psum``
over the ``tiles`` axis: each shard's thread hands in its partial sums, the
partials go to the mesh's first device and are added there in shard order
(so the total does not depend on which thread came first), and each shard
gets the totals back on its own device.

The train mesh (``make_train_mesh``) is a dp x tp grid of devices, which
may repeat in the same way: ``devices=["cuda:0"] * 4`` gives dp = tp = 2 on
one card, ``["cpu"] * 8`` the JAX tests' dp = 4, tp = 2. A ``NamedSharding``
names how a parameter lies on it, as ``jax.sharding.NamedSharding`` does:
``spec`` ``()`` replicated, ``("tp", None)`` its rows split over tp,
``(None, "tp")`` its columns.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple, Union

import torch

DeviceLike = Union[str, torch.device]


def canonical_device(device: DeviceLike) -> torch.device:
    """``cuda`` -> ``cuda:<current>``, so that equal devices compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class TileMesh:
    """Tile shards over ``devices`` (shard i on ``devices[i]``)."""

    devices: Tuple[torch.device, ...]

    @property
    def shape(self):
        """The axis sizes, as ``jax.sharding.Mesh.shape`` names them."""
        return {"tiles": len(self.devices)}

    @property
    def tiles(self) -> int:
        return len(self.devices)

    def reducer(self) -> "ShardReducer":
        """A fresh all-reduce meeting point for one sharded call."""
        return ShardReducer(self.devices)


def make_tile_mesh(n_devices: Optional[int] = None,
                   devices: Optional[Sequence[DeviceLike]] = None) -> TileMesh:
    """A mesh of ``n_devices`` shards: the first ``n_devices`` of ``devices``
    (a device may repeat), or by default of the cards (all of them when
    ``n_devices`` is None)."""
    devs = [canonical_device(d) for d in (devices if devices is not None else _cards())]
    n = len(devs) if n_devices is None else n_devices
    if not 1 <= n <= len(devs):
        raise ValueError(f"a mesh of {n} shards over {len(devs)} devices")
    if len({d.type for d in devs[:n]}) != 1:
        raise ValueError(f"a mesh's devices are of one type, got {devs[:n]}")
    return TileMesh(tuple(devs[:n]))


class ShardReducer:
    """The sum over shards of each shard's tensors, met by one thread a
    shard (``all_reduce``). A shard that fails breaks the barrier, so that
    the others raise instead of waiting for it."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = tuple(devices)
        self._barrier = threading.Barrier(len(self.devices))
        self._parts: List[Optional[List[torch.Tensor]]] = [None] * len(self.devices)
        self._total: Optional[List[torch.Tensor]] = None

    def all_reduce(self, shard: int, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        root = self.devices[0]
        self._parts[shard] = [t.to(root) for t in tensors]
        if self._barrier.wait() == 0:
            total = [t.clone() for t in self._parts[0]]
            for part in self._parts[1:]:
                for acc, t in zip(total, part):
                    acc += t
            self._total = total
        self._barrier.wait()
        # the next call replaces the list only after every shard has met
        # again, so each reads these totals first
        return [t.to(self.devices[shard]) for t in self._total]

    def abort(self) -> None:
        self._barrier.abort()


@dataclass(frozen=True)
class ShardAxis:
    """Shard ``shard``'s side of ``reducer``: what a ``TileContext`` holds
    on a mesh."""

    reducer: ShardReducer
    shard: int

    def psum(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return self.reducer.all_reduce(self.shard, tensors)


@dataclass(frozen=True)
class TrainMesh:
    """A dp x tp grid of devices: ``devices[r][j]`` holds tp shard j of data
    replica r."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self):
        """The axis sizes, as ``jax.sharding.Mesh.shape`` names them."""
        return {"dp": len(self.devices), "tp": len(self.devices[0])}

    @property
    def dp(self) -> int:
        return len(self.devices)

    @property
    def tp(self) -> int:
        return len(self.devices[0])


@dataclass(frozen=True)
class NamedSharding:
    """How a tensor lies on ``mesh``: ``spec`` names the mesh axis each of
    its dims splits over (None: not split; ``()``: replicated)."""

    mesh: Any
    spec: Tuple[Optional[str], ...] = ()


def _cards() -> List[torch.device]:
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("a mesh takes the CUDA devices by default and none is "
                           "available; pass devices=['cpu'] * n for CPU shards")
    return [torch.device("cuda", i) for i in range(count)]


def make_train_mesh(dp: int, tp: int,
                    devices: Optional[Sequence[DeviceLike]] = None) -> TrainMesh:
    """The first dp * tp of ``devices`` (by default the cards; a device may
    repeat) as a dp x tp grid, row by row."""
    devs = [canonical_device(d) for d in (devices if devices is not None else _cards())]
    if dp < 1 or tp < 1 or len(devs) < dp * tp:
        raise ValueError(f"need {dp * tp} devices, have {len(devs)}")
    devs = devs[:dp * tp]
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"a mesh's devices are of one type, got {devs}")
    return TrainMesh(tuple(tuple(devs[r * tp:(r + 1) * tp]) for r in range(dp)))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())
