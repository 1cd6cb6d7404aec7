"""Device mesh with a ``clients`` axis and one inner axis: port of
``bcfl_tpu/core/mesh.py`` (``CLIENT_AXIS``, ``ClientMesh``,
``client_mesh``, ``fed_tp_mesh``, ``distributed_init``, ``pod_devices``,
``pod_client_mesh``, with JAX's checks and messages; the
``NamedSharding`` helpers have no counterpart).

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

The pod (``bcfl_tpu/core/mesh.py``'s ``distributed_init``,
``pod_devices``, ``pod_client_mesh``): :func:`distributed_init` joins P
processes in a ``torch.distributed`` gloo group under JAX's
``BCFL_COORDINATOR`` / ``BCFL_NUM_PROCESSES`` / ``BCFL_PROCESS_ID``
contract, and :func:`pod_devices` gathers every process's own devices,
process 0's first (JAX's hosts-major order), each a :class:`PodDevice`
naming its process. A mesh over them keeps, per device, the process that
owns it (:meth:`ClientMesh.shard_process`): a device of this process
stands as itself, another process's as a ``meta`` device, which holds
the shapes of what lives there and never its data. A process's own
devices are what it sees: its visible CUDA devices (start each process
of a multi-card host with its own ``CUDA_VISIBLE_DEVICES``, as each pod
host sees only its own chips) or the list it is given.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

CLIENT_AXIS = "clients"
#: seconds a pod's group waits on a process before its call raises
POD_TIMEOUT_S = 600.0


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
    #: the process that owns each device of ``flat`` (a pod's), or empty:
    #: every device is this process's
    owners: Tuple[int, ...] = ()

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    def owner(self, device_index: int) -> int:
        """The process owning ``flat[device_index]``."""
        return (self.owners[device_index] if self.owners
                else process_index())

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


def _mesh(devices: Sequence, dims: Tuple[int, ...],
          axis_names: Tuple[str, ...]) -> Mesh:
    n = int(np.prod(dims))
    flat, owners = _local_view(devices[:n])
    return Mesh(tuple(flat), tuple(int(d) for d in dims), tuple(axis_names),
                tuple(owners) if any(
                    isinstance(d, PodDevice) for d in devices) else ())


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

    def shard_process(self, shard: int) -> int:
        """The process that owns client shard ``shard`` (its first
        device's): the one that trains its clients."""
        return self.mesh.owner(int(np.ravel_multi_index(
            (shard,) + (0,) * (len(self.mesh.dims) - 1), self.mesh.dims)))

    @property
    def home_shard(self) -> int:
        """This process's first client shard: where its model lives (0,
        the lead's shard, off a pod)."""
        return self.shard_processes.index(process_index())

    @property
    def home(self) -> torch.device:
        """The device of :attr:`home_shard`."""
        return self.client_devices[self.home_shard]

    @property
    def shard_processes(self) -> List[int]:
        """The owning process of every client shard, in shard order."""
        return [self.shard_process(s)
                for s in range(self.mesh.shape[CLIENT_AXIS])]

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
    devices = (_devices_of(devices) if devices is not None
               else pod_devices())
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
    devices = (_devices_of(devices) if devices is not None
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
        mesh = ClientMesh(_mesh(devices, (d, inner_n),
                                (CLIENT_AXIS, inner_axis)),
                          num_clients=num_clients,
                          per_device=num_clients // d, tp=tp, sp=sp)
        _check_pod_shards(mesh, devices)
        return mesh
    if not devices:
        raise ValueError("client_mesh needs at least one device, have 0")
    d = _largest_divisor_leq(num_clients, len(devices))
    mesh = ClientMesh(_mesh(devices, (d,), (CLIENT_AXIS,)),
                      num_clients=num_clients, per_device=num_clients // d)
    _check_pod_shards(mesh, devices)
    return mesh


# ------------------------------------------------------------------ the pod


@dataclasses.dataclass(frozen=True)
class PodDevice:
    """A device of a pod: ``device`` as its own ``process`` names it (JAX's
    ``Device`` with its ``process_index``)."""

    process: int
    device: torch.device


def _devices_of(devices: Sequence) -> list:
    return [d if isinstance(d, PodDevice) else torch.device(d)
            for d in devices]


def _local_view(devices: Sequence) -> Tuple[list, list]:
    """``devices`` as this process addresses them (another process's
    :class:`PodDevice` as the ``meta`` device) and the process owning
    each (a plain device is this process's)."""
    me = process_index()
    flat, owners = [], []
    for d in devices:
        if isinstance(d, PodDevice):
            owners.append(d.process)
            flat.append(d.device if d.process == me
                        else torch.device("meta"))
        else:
            owners.append(me)
            flat.append(torch.device(d))
    return flat, owners


def _check_pod_shards(mesh: ClientMesh, devices: Sequence) -> None:
    """Every process of a pod must own a client shard: a process with none
    would have no clients to train and nothing to hold its shapes."""
    procs = {d.process for d in devices if isinstance(d, PodDevice)}
    if len(procs) <= 1:
        return
    idle = sorted(procs - set(mesh.shard_processes))
    if idle:
        raise ValueError(
            f"{mesh.num_clients} clients over the pod's {len(devices)} "
            f"devices make {len(mesh.shard_processes)} client shards, and "
            f"process(es) {idle} own none: give every process a client "
            "shard (a client count the pod's device count divides)")


def pod_active() -> bool:
    """Whether this process is one of a pod of more than one process
    (:func:`distributed_init` ran)."""
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def process_index() -> int:
    """This process's index in the pod (JAX's ``process_index``; 0 alone)."""
    return dist.get_rank() if pod_active() else 0


def process_count() -> int:
    """The pod's process count (JAX's ``process_count``; 1 alone)."""
    return dist.get_world_size() if pod_active() else 1


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Join a multi-process pod: ``torch.distributed``'s gloo group, as
    JAX's ``jax.distributed.initialize``. Call it once per process before
    building an engine, then build meshes from :func:`pod_devices`. The
    parameters default to the ``BCFL_COORDINATOR`` (``host:port`` of
    process 0) / ``BCFL_NUM_PROCESSES`` / ``BCFL_PROCESS_ID`` environment
    variables; a single process (the common case) is a no-op returning
    False. A call of the group that waits on another process longer than
    :data:`POD_TIMEOUT_S` raises (a process that exits closes its connections, and
    the calls waiting on it raise at once)."""
    if num_processes is None:
        num_processes = int(os.environ.get("BCFL_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return False
    if process_id is None:
        pid = os.environ.get("BCFL_PROCESS_ID")
        if pid is None:
            # defaulting to 0 would make EVERY host register as process 0 and
            # hang the coordinator barrier with no useful error
            raise ValueError(
                "multi-process init needs a distinct process_id per host: "
                "pass process_id= or set BCFL_PROCESS_ID")
        process_id = int(pid)
    address = coordinator_address or os.environ.get("BCFL_COORDINATOR")
    if not address:
        raise ValueError(
            "multi-process init needs the coordinator's address (process "
            "0's host:port): pass coordinator_address= or set "
            "BCFL_COORDINATOR")
    dist.init_process_group(
        "gloo", init_method=address if "://" in address else f"tcp://{address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=POD_TIMEOUT_S))
    return True


def pod_devices(local: Optional[Sequence] = None) -> list:
    """Every device of the pod, hosts-major (process 0's first), each a
    :class:`PodDevice`: each process's own devices, ``local`` (default its
    visible CUDA devices), gathered from every process, so every process
    calls it at once. A single process gets its own devices as they are,
    as JAX's gives ``jax.devices()``."""
    own = ([torch.device(d) for d in local] if local is not None
           else visible_devices())
    if not pod_active():
        return own
    names: list = [None] * process_count()
    dist.all_gather_object(names, [str(d) for d in own])
    return [PodDevice(p, torch.device(n))
            for p, ns in enumerate(names) for n in ns]


def pod_client_mesh(num_clients: int, tp: int = 1,
                    local: Optional[Sequence] = None) -> ClientMesh:
    """The clients mesh spanning every process of the pod (see
    :func:`pod_devices`; ``local``: this process's devices)."""
    return client_mesh(num_clients, devices=pod_devices(local), tp=tp)
