"""Sequence parallelism as a model capability: port of
``bcfl_tpu/parallel/sp.py`` (``SEQ_AXIS``, ``ring_override``,
``ring_config``, ``make_sp_lm_train_step``, ``init_sp_lm``).

:func:`ring_config` swaps a model's attention for exact ring attention over
a mesh's ``seq`` axis (:func:`bcfl_tpu_torch.parallel.ring_attention.
ring_attention_gspmd`): decoders ride the causal ring, encoders the
non-causal one with padding in the ``[B, S]`` key bias. The JAX package
lets XLA shard every other op along the sequence from the constraints; the
port's single controller splits only the attention into the ring's blocks
(block ``i`` on the axis's ``devices[i]``) and runs the rest of the model
on the first device. On a ``(clients, seq)`` mesh every client shard has
a ring of its own, over its own row of the mesh (:func:`ring_override`'s
``row``; :func:`ride_ring` gives a shard's copy of the model its row's
ring; :func:`hops` counts each row's ring hops). Where the list names
one card ``sp`` times, the blocks share it: the ring's arithmetic is
proved, not a memory gain.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from bcfl_tpu_torch.core.mesh import CLIENT_AXIS, Mesh
from bcfl_tpu_torch.models.bert import init_params
from bcfl_tpu_torch.parallel.ring_attention import (ring_attention_gspmd,
                                                    rotations)

SEQ_AXIS = "seq"


def _check_axis(mesh: Mesh, axis_name: str) -> None:
    if axis_name not in mesh.shape:
        raise ValueError(f"mesh has no {axis_name!r} axis: {mesh.shape}")


_HOPS: Dict[int, int] = {}


def hops(row: Optional[int] = None) -> int:
    """The ring hops (:func:`ring_attention.rotations`) of client shard
    ``row``'s rings since the last :func:`reset_hops` (``row=None``: of
    every row)."""
    if row is None:
        return sum(_HOPS.values())
    return _HOPS.get(row, 0)


def reset_hops() -> None:
    _HOPS.clear()


def _row_ring(q, k, v, key_bias, causal=False, *, devices, row):
    before = rotations()
    out = ring_attention_gspmd(q, k, v, key_bias, devices, causal)
    _HOPS[row] = _HOPS.get(row, 0) + rotations() - before
    return out


def ring_override(mesh: Mesh, axis_name: str = SEQ_AXIS, row: int = 0
                  ) -> Callable:
    """The attention-override callable: exact ring attention over
    ``mesh``'s ``axis_name`` devices in row ``row`` of its clients axis
    (client shard ``row``'s ring; its hops count under ``row`` in
    :func:`hops`). One definition: :func:`ring_config` and the engine's
    ``FedConfig(sp=...)`` path both wire exactly this."""
    _check_axis(mesh, axis_name)
    rows = mesh.shape.get(CLIENT_AXIS, 1)
    if not 0 <= row < rows:
        raise ValueError(f"row {row} is not one of the mesh's {rows} "
                         "client shards")
    devices = mesh.axis_devices(axis_name, at={CLIENT_AXIS: row})
    return functools.partial(_row_ring, devices=tuple(devices), row=row)


def ride_ring(model: nn.Module, override: Callable) -> None:
    """Point every module of ``model`` that holds a config with an
    ``attention_override`` at ``override``: a client shard's copy of a
    model gets its own row's ring (a ``deepcopy`` keeps the ring of the
    model it copied)."""
    new = {}
    for mod in model.modules():
        cfg = mod.__dict__.get("cfg")
        if getattr(cfg, "attention_override", None) is None:
            continue
        if id(cfg) not in new:
            new[id(cfg)] = dataclasses.replace(cfg,
                                               attention_override=override)
        mod.cfg = new[id(cfg)]


def ring_devices(model: nn.Module) -> Optional[Tuple[torch.device, ...]]:
    """The devices of ``model``'s ring (None: its attention is not on a
    ring built by :func:`ring_override`)."""
    override = getattr(model.cfg, "attention_override", None)
    return getattr(override, "keywords", {}).get("devices")


def ring_config(model_cfg, mesh: Mesh, axis_name: str = SEQ_AXIS):
    """A copy of ``model_cfg`` whose attention is exact ring attention
    over ``mesh``'s ``axis_name`` axis."""
    if not hasattr(model_cfg, "attention_override"):
        raise ValueError(
            f"{type(model_cfg).__name__} has no attention_override hook — "
            "sequence parallelism needs a config exposing it")
    return dataclasses.replace(
        model_cfg, attention_override=ring_override(mesh, axis_name))


def make_sp_lm_train_step(model: nn.Module, mesh: Mesh,
                          axis_name: str = SEQ_AXIS,
                          learning_rate: float = 5e-5,
                          optimizer: str = "adamw"
                          ) -> Tuple[Callable, torch.optim.Optimizer]:
    """``(step, opt)``: ``step(batch, generator=None) -> loss`` is one
    next-token optimizer step of ``model`` (built from a
    :func:`ring_config`'d config, so its attention already rides the
    ring) on ``batch['ids']/['mask']`` ``[B, S]``. The loss is the
    per-token cross entropy over the whole sequence."""
    from bcfl_tpu_torch.fed.client_step import make_loss_fn, make_optimizer

    _check_axis(mesh, axis_name)
    opt = make_optimizer(list(model.parameters()), optimizer, learning_rate)
    loss_fn = make_loss_fn(model, task="causal_lm")

    def step(batch, generator: Optional[torch.Generator] = None):
        model.train()
        loss, _, _ = loss_fn(batch, generator)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    return step, opt


def init_sp_lm(model: nn.Module, mesh: Mesh, seed: int = 0) -> nn.Module:
    """``model`` with fresh flax-style parameters from ``seed``, on the
    mesh's first device (where the single controller keeps them)."""
    model.to(mesh.flat[0])
    gen = torch.Generator(device=mesh.flat[0])
    gen.manual_seed(seed)
    init_params(model, gen)
    return model
