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
on the first device. Where the list names one card ``sp`` times, the
blocks share it: the ring's arithmetic is proved, not a memory gain.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from bcfl_tpu_torch.core.mesh import Mesh
from bcfl_tpu_torch.models.bert import init_params
from bcfl_tpu_torch.parallel.ring_attention import ring_attention_gspmd

SEQ_AXIS = "seq"


def _check_axis(mesh: Mesh, axis_name: str) -> None:
    if axis_name not in mesh.shape:
        raise ValueError(f"mesh has no {axis_name!r} axis: {mesh.shape}")


def ring_override(mesh: Mesh, axis_name: str = SEQ_AXIS) -> Callable:
    """The attention-override callable: exact ring attention over
    ``mesh``'s ``axis_name`` devices. One definition: :func:`ring_config`
    and the engine's ``FedConfig(sp=...)`` path both wire exactly this."""
    _check_axis(mesh, axis_name)
    return functools.partial(ring_attention_gspmd,
                             devices=tuple(mesh.axis_devices(axis_name)))


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
