"""LoRA adapters over a frozen base: port of ``bcfl_tpu/models/lora.py``
(``DEFAULT_TARGETS``, ``HEAD_MODULES``, ``init_lora``, ``apply_lora``,
``num_params``, ``rank_mask``, ``clip_adapters``, ``init_lora_ranks``,
``effective_rank``).

The adapter tree is one flat dict in the JAX adapter tree's leaf names and
flatten order (:func:`bcfl_tpu_torch.models.convert.adapter_order`): per
targeted kernel ``W`` (viewed 2-D as ``[fan_in, fan_out]``) an
``<target>/a`` ``[fan_in, r]`` (Gaussian / sqrt(r)) and ``<target>/b``
``[r, fan_out]`` (zeros), and per leaf of a head module
(``classifier``, ``pooler``) a ``<leaf>/full`` copy that replaces the
frozen leaf outright, so task heads train in full. The init draws come
from a ``torch.Generator`` on :data:`bcfl_tpu_torch.core.prng.LORA_LANE`,
not threefry.

The JAX package merges a whole tree, ``W + scale * (a @ b)``, before every
forward (``client_step._merge``): at llama2-7b a second 27 GB float32
tree per client. The port does the same arithmetic per targeted
``nn.Linear`` inside the forward (:func:`attach`): the product ``a @ b``
in the adapters' dtype, times ``scale``, in the ``nn.Linear`` layout (the
transpose of the flax kernel's 2-D view), added to the frozen weight in
its dtype, then the layer's own compute-dtype cast; only one layer's
merged weight is alive at a time, and gradients flow through it as in
JAX. On a tensor-parallel base each shard merges its own rows or columns
of the delta (:func:`_merger`'s ``shard``), never the dense weight.
Heterogeneous ranks (RBLA) pad every client to the fleet's maximum rank;
:func:`rank_mask` marks the real rank dims.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Sequence

import torch
from torch import nn

from bcfl_tpu_torch.models.convert import (adapter_order, leaf_specs,
                                           to_jax_layout, to_torch_layout)

Tree = Dict[str, torch.Tensor]

DEFAULT_TARGETS = ("query", "key", "value", "out", "mlp_in", "mlp_out")
# heads train in full under LoRA (HF modules_to_save): a frozen random head
# would cap what the adapters can learn; the vocab-sized lm_head gets an
# adapter instead (models/llama.py LORA_TARGETS)
HEAD_MODULES = ("classifier", "pooler")


def _fans(module: str, shape) -> tuple:
    """A kernel's 2-D view ``(fan_in, fan_out)``: q/k/v kernels are
    ``[in, heads, hdim]``, the attention output ``[heads, hdim, out]``."""
    if len(shape) == 2:
        return shape
    if module in ("out", "o_proj"):
        return shape[0] * shape[1], shape[2]
    return shape[0], shape[1] * shape[2]


def init_lora(generator: torch.Generator, model: nn.Module, rank: int,
              targets: Sequence[str] = DEFAULT_TARGETS,
              head_modules: Sequence[str] = HEAD_MODULES) -> Tree:
    """The adapter tree of ``model``'s (frozen) parameters at ``rank``: a
    Gaussian ``a`` drawn in float32 from ``generator`` (one draw per
    target, in JAX leaf order) divided by sqrt(rank), a zero ``b`` (the
    adapters start as the identity), and ``full`` copies of the head
    leaves, all in the parameters' dtype and on their device."""
    params = dict(model.named_parameters())
    out = {}
    for spec in leaf_specs(model):
        parts = spec.path.split("/")
        w = params[spec.key]
        if len(parts) >= 2 and parts[-2] in head_modules:
            out[f"{spec.path}/full"] = to_jax_layout(spec, w.detach()).clone()
            continue
        if parts[-1] != "kernel" or len(parts) < 2 or parts[-2] not in targets:
            continue
        if len(spec.shape) not in (2, 3):
            continue
        fan_in, fan_out = _fans(parts[-2], spec.shape)
        target = "/".join(parts[:-1])
        a = torch.randn((fan_in, rank), generator=generator,
                        dtype=torch.float32, device=w.device)
        out[f"{target}/a"] = (a / math.sqrt(rank)).to(w.dtype)
        out[f"{target}/b"] = torch.zeros((rank, fan_out), dtype=w.dtype,
                                         device=w.device)
    return {p: out[p] for p in adapter_order(out)}


def _delta(a: torch.Tensor, b: torch.Tensor, scale: float) -> torch.Tensor:
    """``scale * (a @ b)`` in the ``nn.Linear`` layout: the transpose of
    the flax kernel's 2-D view (a view, no copy)."""
    ab = a @ b
    return (ab if scale == 1.0 else scale * ab).t()


def apply_lora(params: Tree, adapters: Tree, scale: float = 1.0) -> Tree:
    """A flax-layout parameter tree with each targeted kernel
    ``W + scale * (a @ b)`` (reshaped to the kernel's shape) and each head
    leaf replaced by its ``full`` copy: the whole merged tree, as the JAX
    function returns it (the engine merges per layer, :func:`attach`)."""
    out = {}
    for path, leaf in params.items():
        full = adapters.get(f"{path}/full")
        target = path[:-len("/kernel")]
        if full is not None:
            out[path] = full.to(leaf.dtype)
        elif path.endswith("/kernel") and f"{target}/a" in adapters:
            ab = adapters[f"{target}/a"] @ adapters[f"{target}/b"]
            out[path] = leaf + (scale * ab).reshape(leaf.shape).to(leaf.dtype)
        else:
            out[path] = leaf
    return out


def _merger(path: str, a, b, full_w, full_b, scale: float) -> Callable:
    def merge(layer: nn.Linear, shard=None):
        """``(weight, bias)``; ``shard = (w_i, b_i, dim, lo, hi)`` merges
        one tensor-parallel shard instead (:mod:`bcfl_tpu_torch.parallel.
        tp_linear`): its delta is ``a @ b[:, lo:hi]`` (column-parallel,
        ``dim`` 0) or ``a[lo:hi] @ b`` (row-parallel), the adapters whole."""
        w, bias = layer.weight, layer.bias
        aa, bb = a, b
        if shard is not None:
            w, bias, dim, lo, hi = shard
            if full_w is not None or full_b is not None:
                raise ValueError(f"{path}: a fully trained head leaf cannot "
                                 "replace a tensor-parallel shard")
            if a is not None:
                aa, bb = (a, b[:, lo:hi]) if dim == 0 else (a[lo:hi], b)
                aa, bb = aa.to(w.device), bb.to(w.device)
        if full_w is not None:
            w = to_torch_layout(f"{path}/kernel", full_w).to(w.dtype)
        elif a is not None:
            w = w + _delta(aa, bb, scale).to(w.dtype)
        if full_b is not None:
            bias = to_torch_layout(f"{path}/bias", full_b).to(bias.dtype)
        return w, bias

    return merge


def attach(model: nn.Module, adapters: Tree, scale: float = 1.0) -> None:
    """Route every targeted ``nn.Linear`` of ``model`` through its
    adapters (:func:`bcfl_tpu_torch.parallel.tp_linear.dense` and, on a
    tensor-parallel base, :func:`~bcfl_tpu_torch.parallel.tp_linear.column`
    and :func:`~bcfl_tpu_torch.parallel.tp_linear.row` read the hook):
    ``a``/``b`` add ``scale * (a @ b)`` to the frozen weight, ``full``
    leaves replace the weight or bias. Raises if an adapter names no
    layer of the model."""
    used = set()
    for name, mod in model.named_modules():
        if not isinstance(mod, nn.Linear):
            continue
        path = name.replace(".", "/")
        keys = {sub: f"{path}/{sub}" for sub in ("a", "b")}
        keys["w"], keys["bias"] = f"{path}/kernel/full", f"{path}/bias/full"
        got = {k: adapters.get(v) for k, v in keys.items()}
        if all(v is None for v in got.values()):
            mod.__dict__.pop("lora", None)
            continue
        used.update(v for k, v in keys.items() if got[k] is not None)
        mod.lora = _merger(path, got["a"], got["b"], got["w"], got["bias"],
                           scale)
    missing = sorted(set(adapters) - used)
    if missing:
        raise ValueError(f"adapters {missing[:3]} match no layer of the model")


def detach(model: nn.Module) -> None:
    for mod in model.modules():
        mod.__dict__.pop("lora", None)


@contextlib.contextmanager
def attached(model: nn.Module, adapters: Tree, scale: float = 1.0):
    attach(model, adapters, scale)
    try:
        yield model
    finally:
        detach(model)


def num_params(tree: Tree) -> int:
    return sum(x.numel() for x in tree.values())


# ---------------------------------------------------------------------------
# Heterogeneous per-client ranks (RBLA, arXiv 2408.08699). A fleet whose
# client c trains at rank r_c is held at the fleet's maximum rank R; client
# c's rank dims >= r_c are structural zeros, described by a [C, R] mask.
# Both factors start at 0 there, so the gradients are 0 and AdamW keeps
# them exactly 0: clipping the global once at local-train entry keeps the
# padding zero on every path.
# ---------------------------------------------------------------------------


def rank_mask(ranks: Sequence[int], device=None) -> torch.Tensor:
    """``[C, max(ranks)]`` float32: ``mask[c, j] = 1`` iff ``j < ranks[c]``."""
    r = torch.tensor([int(x) for x in ranks], dtype=torch.int64,
                     device=device)
    rmax = int(max(int(x) for x in ranks))
    return (torch.arange(rmax, device=device)[None, :]
            < r[:, None]).to(torch.float32)


def clip_adapters(adapters: Tree, mask_row: torch.Tensor) -> Tree:
    """Zero one client's padding dims: ``a * row[None, :]``,
    ``b * row[:, None]``; ``full`` leaves pass through."""
    out = {}
    for p, x in adapters.items():
        last = p.rsplit("/", 1)[-1]
        if last == "a":
            x = x * mask_row[None, :].to(x.dtype)
        elif last == "b":
            x = x * mask_row[:, None].to(x.dtype)
        out[p] = x
    return out


def clip_stacked(stacked: Tree, mask: torch.Tensor) -> Tree:
    """:func:`clip_adapters` over a ``[C, ...]`` tree with a ``[C, R]``
    mask (the JAX ``vmap(clip_adapters)``)."""
    out = {}
    for p, x in stacked.items():
        last = p.rsplit("/", 1)[-1]
        if last == "a":
            x = x * mask[:, None, :].to(x.dtype)
        elif last == "b":
            x = x * mask[:, :, None].to(x.dtype)
        out[p] = x
    return out


def init_lora_ranks(generator_of: Callable[[int], torch.Generator],
                    model: nn.Module, ranks: Sequence[int],
                    targets: Sequence[str] = DEFAULT_TARGETS,
                    head_modules: Sequence[str] = HEAD_MODULES) -> Tree:
    """Stacked ``[C, ...]`` adapters for a heterogeneous fleet: client
    ``c`` initialized at its own rank from ``generator_of(c)`` (the scale
    a uniform rank-``r_c`` client gets), zero-padded to the maximum rank."""
    ranks = tuple(int(r) for r in ranks)
    rmax = max(ranks)
    rows = []
    for c, r in enumerate(ranks):
        adp = init_lora(generator_of(c), model, r, targets, head_modules)
        for p, x in adp.items():
            last = p.rsplit("/", 1)[-1]
            if last == "a":
                adp[p] = torch.nn.functional.pad(x, (0, rmax - r))
            elif last == "b":
                adp[p] = torch.nn.functional.pad(x, (0, 0, 0, rmax - r))
        rows.append(adp)
    return {p: torch.stack([row[p] for row in rows]) for p in rows[0]}


def effective_rank(adapters: Tree) -> torch.Tensor:
    """Mean Shannon effective rank over the ``a``/``b`` pairs of one
    (unstacked) adapter tree, the rank-collapse guard of arXiv 2602.13486
    without an SVD: per rank dim ``e_j = |a[:, j]|^2 |b[j, :]|^2``, and
    ``exp(entropy(e / sum e))``; 0.0 for a pair that carries no energy
    (``b`` starts at zeros). A float32 scalar tensor."""
    tiny = 1e-30
    pairs: Dict[str, Dict[str, torch.Tensor]] = {}
    for p, x in adapters.items():
        key, last = p.rsplit("/", 1)
        if last in ("a", "b"):
            pairs.setdefault(key, {})[last] = x
    effs = []
    for entry in pairs.values():
        if "a" not in entry or "b" not in entry:
            continue
        a, b = entry["a"].float(), entry["b"].float()
        e = (a * a).sum(dim=0) * (b * b).sum(dim=1)
        tot = e.sum()
        p = e / torch.clamp(tot, min=tiny)
        ent = -(p * torch.log(torch.clamp(p, min=tiny))).sum()
        effs.append(torch.where(tot > tiny, torch.exp(ent),
                                torch.zeros((), device=e.device)))
    if not effs:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack(effs).mean()
