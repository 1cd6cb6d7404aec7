"""Device mesh with a ``clients`` axis and one inner axis: port of the part
of ``bcfl_tpu/core/mesh.py`` that runs on one host (``CLIENT_AXIS``,
``ClientMesh``, ``client_mesh``, ``fed_tp_mesh``, with JAX's checks and
messages).

The JAX package lays its clients and an inner ``tp`` or ``seq`` axis over a
``jax.sharding.Mesh``; the port keeps the same grid as a :class:`Mesh` of
``torch.device`` entries. On a 1-D mesh the clients axis spreads: client
shard ``s`` lives on ``ClientMesh.client_devices[s]`` and holds clients
``[s * per_device, (s + 1) * per_device)`` (:meth:`ClientMesh.shard_of`,
JAX's device-major layout), and the engine trains each shard's clients on
its own device. On a 2-D mesh ``(clients, tp)`` or ``(clients, seq)``
every row of the grid is a client shard: shard ``s`` trains its clients
on its own row of inner devices (:meth:`ClientMesh.row_devices`,
JAX's ``mesh.devices[s]``), its inner shard ``i`` on the row's ``i``-th
device, and ``ClientMesh.client_devices[s]`` is the row's first device,
where the shard's clients are issued. A device list may name one
device more than once (``[cuda:0, cuda:0]``), as the JAX package's virtual
host devices name one host: the shards then share that device, which
proves the sharded arithmetic and gives no memory or speed gain. Without
a list, :func:`client_mesh` takes the visible CUDA devices, as JAX takes
``jax.devices()``, and refuses, in JAX's words, an inner axis larger than
their count.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

CLIENT_AXIS = "clients"


def _largest_divisor_leq(n: int, cap: int) -> int:
    for d in range(min(n, cap), 0, -1):
        if n % d == 0:
            return d
    return 1


def visible_devices() -> List[torch.device]:
    """The visible CUDA devices, in index order (none without a GPU)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A row-major grid of devices with named axes: the port's
    ``jax.sharding.Mesh``."""

    flat: Tuple[torch.device, ...]
    dims: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    def axis_devices(self, axis: str, at: Optional[Dict[str, int]] = None
                     ) -> List[torch.device]:
        """The devices along ``axis`` at index ``at[a]`` of every other
        axis ``a`` (0 where ``at`` does not name it)."""
        at = at or {}
        grid = np.empty(len(self.flat), dtype=object)
        grid[:] = self.flat
        grid = grid.reshape(self.dims)
        index = tuple(slice(None) if a == axis else at.get(a, 0)
                      for a in self.axis_names)
        return list(grid[index].reshape(-1))


def _mesh(devices: Sequence[torch.device], dims: Tuple[int, ...],
          axis_names: Tuple[str, ...]) -> Mesh:
    n = int(np.prod(dims))
    return Mesh(tuple(devices[:n]), tuple(int(d) for d in dims),
                tuple(axis_names))


@dataclasses.dataclass(frozen=True)
class ClientMesh:
    """A mesh hosting ``num_clients`` clients on its ``clients`` axis,
    ``per_device`` of them stacked on each client shard.

    ``tp > 1`` makes the mesh 2-D ``(clients, tp)``: each client's
    forward and backward span ``tp`` devices through the megatron split of
    the frozen base (:func:`bcfl_tpu_torch.models.tp_param_specs`).
    ``sp > 1`` makes it ``(clients, seq)``: each client's attention rides
    exact ring attention over ``sp`` sequence blocks
    (:mod:`bcfl_tpu_torch.parallel.sp`).
    """

    mesh: Mesh
    num_clients: int
    per_device: int
    tp: int = 1
    sp: int = 1

    @property
    def inner_axis(self) -> Optional[str]:
        return "tp" if self.tp > 1 else "seq" if self.sp > 1 else None

    def row_devices(self, shard: int) -> List[torch.device]:
        """Client shard ``shard``'s inner devices (its inner shard ``i`` on
        the ``i``-th; JAX's ``mesh.devices[shard]``); on a 1-D mesh the
        shard's one device."""
        if self.inner_axis is None:
            return [self.client_devices[shard]]
        return self.mesh.axis_devices(self.inner_axis,
                                      at={CLIENT_AXIS: shard})

    @property
    def devices(self) -> List[torch.device]:
        """The first client shard's inner devices (:meth:`row_devices` of
        shard 0): one device per inner axis position, the one device of a
        1-D mesh's first shard."""
        return self.row_devices(0)

    @property
    def client_devices(self) -> List[torch.device]:
        """One device per client shard (shard ``s`` on
        ``client_devices[s]``; on a 2-D mesh the first device of the
        shard's row)."""
        return self.mesh.axis_devices(CLIENT_AXIS)

    @property
    def train_devices(self) -> List[torch.device]:
        """The devices the client shards train on, one per shard, 1-D or
        2-D: the device each shard's clients are issued on (on a 2-D mesh
        the first of its row, the others carrying its inner shards)."""
        return self.client_devices

    def train_device(self, client: int) -> torch.device:
        """The device stacked client ``client`` trains on: its shard's
        entry of :attr:`train_devices`."""
        return self.train_devices[self.shard_of(client)]

    def shard_of(self, client: int) -> int:
        """The client shard holding stacked client ``client``: shard ``s``
        (a row of a 2-D mesh) holds clients ``[s * per_device, (s + 1) *
        per_device)``, the JAX package's device-major layout."""
        if not 0 <= client < self.num_clients:
            raise ValueError(f"client {client} is not one of the mesh's "
                             f"{self.num_clients}")
        return client // self.per_device


def fed_tp_mesh(client_shards: int, tp: int,
                devices: Optional[Sequence] = None) -> Mesh:
    """2-D ``(clients, tp)`` mesh: each client spans ``tp`` devices for
    megatron tensor parallelism, tp innermost. Used by
    :mod:`bcfl_tpu_torch.parallel.fed_tp`."""
    devices = ([torch.device(d) for d in devices] if devices is not None
               else visible_devices())
    need = client_shards * tp
    if len(devices) < need:
        raise ValueError(
            f"fed_tp_mesh needs {need} devices ({client_shards} client shards"
            f" x tp={tp}), have {len(devices)}")
    return _mesh(devices, (client_shards, tp), (CLIENT_AXIS, "tp"))


def client_mesh(num_clients: int, devices: Optional[Sequence] = None,
                tp: int = 1, sp: int = 1) -> ClientMesh:
    """Build the clients mesh over ``devices`` (default: the visible CUDA
    devices): the largest divisor of ``num_clients`` that fits the device
    count gives the client shards, each reserving ``tp`` (or ``sp``)
    devices on the inner axis."""
    devices = ([torch.device(d) for d in devices] if devices is not None
               else visible_devices())
    if tp < 1 or sp < 1:
        raise ValueError(f"tp/sp must be >= 1, got tp={tp} sp={sp}")
    if tp > 1 and sp > 1:
        raise ValueError(
            "compose one inner axis per run: tp x sp 3-D meshes are not "
            "supported (pick tensor OR sequence parallelism per client)")
    inner_n, inner_axis = (tp, "tp") if tp > 1 else (sp, "seq")
    if inner_n > 1:
        if len(devices) < inner_n:
            raise ValueError(
                f"{inner_axis}={inner_n} needs at least that many devices, "
                f"have {len(devices)}")
        d = _largest_divisor_leq(num_clients, len(devices) // inner_n)
        return ClientMesh(_mesh(devices, (d, inner_n),
                                (CLIENT_AXIS, inner_axis)),
                          num_clients=num_clients,
                          per_device=num_clients // d, tp=tp, sp=sp)
    if not devices:
        raise ValueError("client_mesh needs at least one device, have 0")
    d = _largest_divisor_leq(num_clients, len(devices))
    return ClientMesh(_mesh(devices, (d,), (CLIENT_AXIS,)),
                      num_clients=num_clients, per_device=num_clients // d)
