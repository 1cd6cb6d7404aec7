"""Federated rounds over a 2-D ``clients x tp`` mesh: port of
``bcfl_tpu/parallel/fed_tp.py`` (``as_client_mesh``,
``build_fed_tp_programs``, ``build_fed_tp_round``, ``stack_adapters``).

For a model too large for one device each client spans ``tp`` devices: the
frozen base carries the megatron split
(:func:`bcfl_tpu_torch.models.tp_param_specs`, applied by
:func:`bcfl_tpu_torch.parallel.tp_linear.shard_base`: shard ``i`` on the
first row's ``i``-th device) and is shared by that row's clients, while
the per-client LoRA adapters stay whole (JAX keeps them replicated over
``tp``). Every other row of the mesh is a client shard of its own, with
its own split of the base over its own row, built by
:func:`~bcfl_tpu_torch.fed.client_step.build_programs`. As in JAX no separate round implementation exists: the
:func:`bcfl_tpu_torch.fed.client_step.build_programs` bodies run unchanged
and the split lives in the model's forward (``tp_linear.column``/``row``,
the port's counterpart of the collectives XLA inserts). The product route
is ``FedConfig(tp=...)`` -> :class:`bcfl_tpu_torch.fed.engine.FedEngine`;
these helpers serve library users composing rounds directly. Where the
device list names one card ``tp`` times the shards share it, which proves
the sharded arithmetic and gives no memory or speed gain.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch
from torch import nn

from bcfl_tpu_torch.core.mesh import CLIENT_AXIS, ClientMesh, Mesh
from bcfl_tpu_torch.parallel import tp_linear

Tree = Dict[str, torch.Tensor]


def as_client_mesh(mesh: Mesh, num_clients: Optional[int] = None
                   ) -> ClientMesh:
    """Wrap a 2-D ``(clients, tp)`` :class:`Mesh` (e.g. from
    :func:`bcfl_tpu_torch.core.mesh.fed_tp_mesh`) as a
    :class:`ClientMesh`."""
    shards = mesh.shape[CLIENT_AXIS]
    num_clients = shards if num_clients is None else num_clients
    if num_clients % shards:
        raise ValueError(
            f"num_clients {num_clients} must be a multiple of the mesh's "
            f"{shards} client shards")
    return ClientMesh(mesh=mesh, num_clients=num_clients,
                      per_device=num_clients // shards,
                      tp=mesh.shape.get("tp", 1))


def build_fed_tp_programs(model: nn.Module, mesh: Mesh,
                          num_clients: Optional[int] = None, **kw):
    """The :class:`~bcfl_tpu_torch.fed.client_step.FedPrograms` of a
    ``model`` split over the mesh's first row on a clients x tp mesh,
    every row a client shard with its own split; ``kw`` forwards to
    :func:`~bcfl_tpu_torch.fed.client_step.build_programs` (the adapter
    programs: tp splits a frozen base)."""
    from bcfl_tpu_torch.fed.client_step import build_programs

    return build_programs(model, as_client_mesh(mesh, num_clients),
                          adapters=True, **kw)


def build_fed_tp_round(model: nn.Module, mesh: Mesh,
                       frozen_specs: Optional[Dict[str, Optional[int]]] = None,
                       optimizer: str = "adamw",
                       learning_rate: float = 5e-5) -> Callable:
    """ONE clients x tp federated round (a shim over
    :func:`build_fed_tp_programs`).

    Returns ``round_fn(stacked_adapters, frozen, batches, generators,
    mask=None) -> (stacked_adapters, stats [C, 3])``: each client trains
    from its own adapters, then every participating client adopts the
    mask-weighted mean (the all-ones default is the FedAvg consensus);
    masked clients keep their own trained state.

    ``frozen`` is a state dict loaded into ``model``'s base before the
    round (None: the base the model holds), and every client shard's split
    is taken anew from it. ``frozen_specs``, when given, splits the base
    by it (now and after each load), so a base that arrives whole gets the
    megatron split rather than running dense; a base already split keeps
    its split, re-taken after a load.
    """
    devices = mesh.axis_devices("tp")
    if frozen_specs is not None:
        tp_linear.shard_base(model, frozen_specs, devices)
    build = functools.partial(build_fed_tp_programs, model, mesh,
                              optimizer=optimizer,
                              learning_rate=learning_rate, gossip_steps=0)
    progs = [build()]
    C = mesh.shape[CLIENT_AXIS]

    def round_fn(stacked, frozen, batches, generators, mask=None):
        if mask is None:
            mask = torch.ones((C,), dtype=torch.float32, device=devices[0])
        if frozen is not None:
            specs = frozen_specs or tp_linear.layout(model)
            # a split over several devices holds no dense weight to load
            # into: load whole, then split again, the other shards too
            tp_linear.unshard(model)
            with torch.no_grad():
                model.load_state_dict(frozen)
            tp_linear.shard_base(model, specs, devices)
            progs[0] = build()
        out = progs[0].gossip_round(stacked, batches, mask, generators)
        return out.global_t, out.stats

    return round_fn


def stack_adapters(mesh: Mesh, adapters: Tree, num_clients: int) -> Tree:
    """Broadcast one adapter tree to a client-stacked ``[C, ...]`` tree on
    the mesh's first device, the lead client shard's, where the round's
    stacked state lives (each shard's rows are copied to its own row as
    the round issues it)."""
    dev = mesh.flat[0]
    return {p: x.to(dev).unsqueeze(0).expand(
        (num_clients,) + tuple(x.shape)).clone() for p, x in adapters.items()}
