"""Carry weights between the flax and PyTorch trees (no JAX counterpart;
its path keys are ``compression/codecs.py::_path_name``'s).

A flax leaf path such as ``encoder/layer_0/attention/query/kernel`` maps to
the state-dict key ``encoder.layer_0.attention.query.weight``. Layouts:

==========================  =======================  ======================
flax leaf                    flax shape               PyTorch parameter
==========================  =======================  ======================
q/k/v ``kernel``             [hidden, heads, hdim]    weight [heads*hdim, hidden]
q/k/v ``bias``               [heads, hdim]            bias [heads*hdim]
attention ``out/kernel``     [heads, hdim, hidden]    weight [hidden, heads*hdim]
other ``kernel``             [in, out]                weight [out, in]
``scale`` / ``embedding``    as is                    weight
==========================  =======================  ======================

The federated round and the codec see a model's trainable tree in the JAX
leaf order and shapes (:func:`trainable_tree`), so the codec's grouping by
width, its per-leaf indices and its payload keys are those of the JAX
package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

_QKV = ("query", "key", "value")
_WEIGHT_LEAF = {nn.Linear: "kernel", nn.Embedding: "embedding",
                nn.LayerNorm: "scale"}


def jax_order(paths) -> List[str]:
    """Paths in ``jax.tree_util`` flatten order (dict keys sorted level by
    level)."""
    return sorted(paths, key=lambda p: tuple(p.split("/")))


def torch_key(path: str) -> str:
    parts = path.split("/")
    leaf = "bias" if parts[-1] == "bias" else "weight"
    return ".".join(parts[:-1] + [leaf])


def _kind(path: str, ndim: int) -> str:
    parts = path.split("/")
    mod, leaf = parts[-2], parts[-1]
    if leaf == "kernel" and mod in _QKV:
        return "qkv_kernel"
    if leaf == "bias" and mod in _QKV:
        return "qkv_bias"
    if leaf == "kernel" and mod == "out" and ndim == 3:
        return "out_kernel"
    if leaf == "kernel":
        return "kernel"
    return "same"


def to_torch_layout(path: str, t: torch.Tensor) -> torch.Tensor:
    """A flax-layout leaf -> its PyTorch parameter layout."""
    kind = _kind(path, t.dim())
    if kind == "qkv_kernel":
        return t.reshape(t.shape[0], -1).t().contiguous()
    if kind == "qkv_bias":
        return t.reshape(-1)
    if kind == "out_kernel":
        return t.reshape(-1, t.shape[-1]).t().contiguous()
    if kind == "kernel":
        return t.t().contiguous()
    return t


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    path: str  # flax leaf path, "/"-joined
    key: str  # state-dict key
    shape: Tuple[int, ...]  # flax shape


def leaf_specs(model: nn.Module) -> List[LeafSpec]:
    """Every parameter of ``model`` with its flax path and shape, in JAX
    flatten order."""
    heads = model.cfg.num_heads
    modules = dict(model.named_modules())
    specs = []
    for key, p in model.named_parameters():
        mod_name, leaf = key.rsplit(".", 1)
        mod = modules[mod_name]
        jleaf = "bias" if leaf == "bias" else _WEIGHT_LEAF[type(mod)]
        path = "/".join(mod_name.split(".") + [jleaf])
        last = mod_name.split(".")[-1]
        shape = tuple(p.shape)
        if jleaf == "kernel" and last in _QKV:
            shape = (shape[1], heads, shape[0] // heads)
        elif jleaf == "bias" and last in _QKV:
            shape = (heads, shape[0] // heads)
        elif jleaf == "kernel" and last == "out":
            shape = (heads, shape[1] // heads, shape[0])
        elif jleaf == "kernel":
            shape = (shape[1], shape[0])
        specs.append(LeafSpec(path, key, shape))
    order = {p: i for i, p in enumerate(jax_order([s.path for s in specs]))}
    return sorted(specs, key=lambda s: order[s.path])


def to_jax_layout(spec: LeafSpec, t: torch.Tensor) -> torch.Tensor:
    """A PyTorch parameter (or a [C, ...]-free tensor in its layout) ->
    the flax layout of ``spec``."""
    kind = _kind(spec.path, len(spec.shape))
    if kind in ("qkv_kernel", "out_kernel", "kernel"):
        return t.t().reshape(spec.shape)
    return t.reshape(spec.shape)


def trainable_tree(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``{flax path: tensor}`` in JAX leaf order and shapes — fresh copies,
    never views of the live parameters."""
    params = dict(model.named_parameters())
    return {s.path: to_jax_layout(s, params[s.key].detach()).clone()
            for s in leaf_specs(model)}


@torch.no_grad()
def load_trainable(model: nn.Module, tree: Dict[str, torch.Tensor]) -> None:
    """Copy a JAX-layout tree (one row, no client axis) into ``model``."""
    params = dict(model.named_parameters())
    for s in leaf_specs(model):
        params[s.key].copy_(to_torch_layout(s.path, tree[s.path]))


def _flatten(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield "/".join(prefix + (str(k),)), v


def _tensor(v) -> torch.Tensor:
    """A numpy (or array-like) leaf as a tensor of the same dtype; numpy
    has no bfloat16 of its own (JAX's is ``ml_dtypes``), so a bfloat16 leaf
    crosses as its 16-bit pattern."""
    a = np.array(v)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    return torch.as_tensor(a)


def from_flax(params) -> Dict[str, torch.Tensor]:
    """flax ``params`` tree (numpy or array-like leaves) -> state dict, in
    the leaves' dtype."""
    return {torch_key(p): to_torch_layout(p, _tensor(v))
            for p, v in _flatten(params)}


def to_flax(model: nn.Module) -> dict:
    """The inverse of :func:`from_flax`: ``model``'s parameters as a nested
    flax-layout numpy tree."""
    out: dict = {}
    for path, t in trainable_tree(model).items():
        node = out
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t.cpu().numpy()
    return out
