"""The tensor-parallel forward (no JAX counterpart: in the JAX package
XLA's SPMD partitioner inserts it from the megatron ``PartitionSpec`` of
``tp_specs``; here it is written out).

:func:`shard_base` splits every column- and row-parallel ``nn.Linear`` of
a model by its spec (:func:`bcfl_tpu_torch.models.tp_param_specs`: the
torch dimension the ``tp`` axis splits) into ``tp`` shards, shard ``i`` on
``devices[i]``, in contiguous blocks, so shard ``i`` holds JAX's heads
``i*H/tp ... (i+1)*H/tp - 1``. The frozen base is stored once either
way: when every shard lies on the weight's own device (one card named
``tp`` times), each shard is a view (``narrow``) of the weight; when the
shards lie on several devices, each owns a copy of its slice on its
device and the dense weight gives up its storage for a ``meta``
placeholder of its shape (:func:`unshard` puts it back together). Load new
weights into a split model after :func:`unshard`. The split is recorded
on the layer (``layer.__dict__["tp"]``, beside the LoRA hook ``"lora"``).
A client shard of a 2-D ``(clients, tp)`` mesh gets its own split over
its own row of devices by :func:`moved`, slice by slice from the lead
shard's (``fed/client_step.py``'s ``_replica``).

The models call :func:`column` and :func:`row` for their projections:

- :func:`column` gives shard ``i``'s output columns of a column-parallel
  layer (q/k/v, the MLP's input side): ``x`` is replicated onto the
  shard's device (once for all of a block's layers, by
  :func:`replicate`), the shard's own weight rows (and bias) apply, and
  the per-shard outputs stay split into the head-sharded attention or the
  FFN;
- :func:`row` gives a row-parallel layer's output (the attention output,
  the MLP's output side) from the per-shard inputs: each shard multiplies
  its input columns, the partial products are summed on the first device
  in float32 (JAX's all-reduce) and cast to the compute dtype; the bias,
  which stays whole, is added once, after the sum.

A layer that is not split is the flax ``Dense`` of :func:`dense`. LoRA
merges per shard: the adapters stay whole (JAX keeps them replicated over
``tp``) and shard ``i`` adds ``scale * (a b)`` restricted to its own rows
(row-parallel: ``a[rows_i]``) or columns (column-parallel:
``b[:, cols_i]``), never the dense weight
(:func:`bcfl_tpu_torch.models.lora.attach`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype
          ) -> torch.Tensor:
    """flax ``Dense(dtype=...)``: input, kernel and bias (if any) cast to
    ``dtype``. A layer carrying LoRA adapters
    (:func:`bcfl_tpu_torch.models.lora.attach`) takes its merged weight
    and bias from them."""
    merge = layer.__dict__.get("lora")
    w, b = (layer.weight, layer.bias) if merge is None else merge(layer)
    return F.linear(x.to(dtype), w.to(dtype),
                    None if b is None else b.to(dtype))


@dataclasses.dataclass
class Shards:
    """One layer's split: ``dim`` 0 (column-parallel: output features) or
    1 (row-parallel: input features) of its ``[out, in]`` weight; shard
    ``i`` covers ``[lo_i, hi_i)`` of that dimension on ``devices[i]``."""

    dim: int
    devices: List[torch.device]
    bounds: List[tuple]
    weights: List[torch.Tensor]
    biases: Optional[List[torch.Tensor]]  # column-parallel biases only
    # the dense weight's device when the shards own their slices (several
    # devices), None when they are views of the weight
    home: Optional[torch.device] = None

    def part(self, layer: nn.Linear, i: int):
        """``(weight, bias)`` of shard ``i``, the layer's LoRA adapters
        merged into its own rows or columns."""
        w = self.weights[i]
        b = None if self.biases is None else self.biases[i]
        merge = layer.__dict__.get("lora")
        if merge is not None:
            lo, hi = self.bounds[i]
            w, b = merge(layer, shard=(w, b, self.dim, lo, hi))
        return w, b


def ways(layer: nn.Linear) -> int:
    """How many shards ``layer`` is split into (1: not split)."""
    sh = layer.__dict__.get("tp")
    return 1 if sh is None else len(sh.weights)


def device_of(layer: nn.Linear, i: int, default: torch.device
              ) -> torch.device:
    """The device of ``layer``'s shard ``i`` (``default`` if not split)."""
    sh = layer.__dict__.get("tp")
    return default if sh is None else sh.devices[i]


def _split(layer: nn.Linear, n: int) -> Optional[Shards]:
    sh = layer.__dict__.get("tp")
    if ways(layer) != n:
        raise ValueError(
            f"a {ways(layer)}-way split layer in a {n}-way tensor-parallel "
            "block: the megatron layout splits a block's column- and "
            "row-parallel layers together")
    return sh


class _Replicate(torch.autograd.Function):
    """``x`` on each of ``devices``; the backward sums the copies'
    gradients on ``x``'s device, in device order."""

    @staticmethod
    def forward(ctx, x, devices):
        ctx.home = x.device
        return tuple(x.view_as(x) if d == x.device else x.to(d, copy=True)
                     for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        total = None
        for g in grads:
            if g is not None:
                g = g.to(ctx.home)
                total = g if total is None else total + g
        return total, None


def replicate(x: torch.Tensor, layer: nn.Linear) -> List[torch.Tensor]:
    """``x`` for each shard of ``layer``'s split (``[x]`` when it is not
    split), to feed every column-parallel layer of a block that reads
    ``x``. Over several devices the copies are made together and their
    gradients meet on ``x``'s device in shard order: copies made layer by
    layer would add up there in whatever order the devices' backward
    threads finish, and the sum's bits would change from run to run."""
    sh = layer.__dict__.get("tp")
    if sh is None:
        return [x]
    if all(d == x.device for d in sh.devices):
        return [x] * len(sh.devices)
    return list(_Replicate.apply(x, tuple(sh.devices)))


def checkpoint(fn: Callable, x: torch.Tensor, *args):
    """``fn(x, *args)`` with its activations recomputed in the backward
    (``torch.utils.checkpoint``, the global RNG states not restored), in
    the reentrant form: the non-reentrant one recomputes from whichever
    device's backward thread first unpacks a saved activation, and over a
    split on several devices two threads can unpack the same layer's at
    once (PyTorch then stops on its recomputation count). The reentrant
    form needs an input that requires grad: a frozen ``x`` (the first
    layer's, under LoRA) is given one, its gradient dropped."""
    if not x.requires_grad:
        x = x.detach().requires_grad_()
    return torch.utils.checkpoint.checkpoint(
        fn, x, *args, use_reentrant=True, preserve_rng_state=False)


def column(x: torch.Tensor, layer: nn.Linear, i: int, n: int,
           dtype: torch.dtype) -> torch.Tensor:
    """Shard ``i`` of ``n`` of a column-parallel layer's output, on the
    shard's device (the whole output when ``n == 1``)."""
    sh = _split(layer, n)
    if sh is None:
        return dense(x, layer, dtype)
    w, b = sh.part(layer, i)
    return F.linear(x.to(sh.devices[i]).to(dtype), w.to(dtype),
                    None if b is None else b.to(dtype))


def row(parts: Sequence[torch.Tensor], layer: nn.Linear, dtype: torch.dtype
        ) -> torch.Tensor:
    """A row-parallel layer's output from its ``len(parts)`` per-shard
    inputs: the partial products summed on the first shard's device in
    float32, then the whole bias, cast to ``dtype``."""
    sh = _split(layer, len(parts))
    if sh is None:
        return dense(parts[0], layer, dtype)
    home = sh.devices[0]
    acc = None
    for i, x in enumerate(parts):
        w, _ = sh.part(layer, i)
        y = F.linear(x.to(dtype), w.to(dtype)).float().to(home)
        acc = y if acc is None else acc + y
    if layer.bias is not None:
        acc = acc + layer.bias.float().to(home)
    return acc.to(dtype)


def indexed(d) -> torch.device:
    """``d`` with its index (``cuda`` names the current card)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def shard_layer(layer: nn.Linear, dim: int, devices: Sequence,
                split_bias: bool) -> None:
    """Split ``layer``'s weight along ``dim`` (and its bias with the
    outputs when ``split_bias``) into ``len(devices)`` contiguous shards."""
    devices = [indexed(d) for d in devices]
    n = len(devices)
    size = layer.weight.shape[dim]
    if size % n:
        raise ValueError(
            f"tp={n} does not divide dimension {dim} ({size}) of a "
            "tensor-parallel weight")
    s = size // n
    bounds = [(i * s, (i + 1) * s) for i in range(n)]
    w = layer.weight.detach()
    own = any(d != w.device for d in devices)
    weights = [w.narrow(dim, lo, s).to(d, copy=own) for (lo, _), d in
               zip(bounds, devices)]
    biases = None
    if split_bias and layer.bias is not None:
        b = layer.bias.detach()
        biases = [b.narrow(0, lo, s).to(d) for (lo, _), d in
                  zip(bounds, devices)]
    if own:
        layer.weight = nn.Parameter(w.to("meta"),
                                    requires_grad=layer.weight.requires_grad)
    layer.__dict__["tp"] = Shards(dim, devices, bounds, weights, biases,
                                  home=w.device if own else None)


def moved(sh: Shards, devices: Sequence) -> Shards:
    """``sh``'s split over ``devices``: shard ``i``'s slice (and bias)
    copied from ``sh.devices[i]`` straight to ``devices[i]``, so that no
    device receives more than its own slices. The copy owns them (its
    layer's dense weight is a ``meta`` placeholder that :func:`unshard`
    puts back together on ``devices[0]``)."""
    devices = [indexed(d) for d in devices]
    if len(devices) != len(sh.weights):
        raise ValueError(f"a {len(sh.weights)}-way split moved onto "
                         f"{len(devices)} devices")
    weights = [w.to(d, copy=True) for w, d in zip(sh.weights, devices)]
    biases = (None if sh.biases is None else
              [b.to(d, copy=True) for b, d in zip(sh.biases, devices)])
    return Shards(sh.dim, devices, list(sh.bounds), weights, biases,
                  home=devices[0])


def shard_base(model: nn.Module, specs: Dict[str, Optional[int]],
               devices: Sequence) -> int:
    """Split every layer that ``specs`` (``{flax path: torch dim or
    None}``) names over ``devices``; returns how many layers were split.
    ``tp`` must divide the heads (the key/value heads too, so that q head
    ``h`` meets kv head ``h // rep`` on its shard) and the FFN width."""
    n = len(devices)
    c = model.cfg
    kv = getattr(c, "kv_heads", c.num_heads)
    if c.num_heads % n or kv % n or c.intermediate_size % n:
        raise ValueError(
            f"tp={n} must divide num_heads={c.num_heads}, kv_heads={kv} "
            f"and intermediate_size={c.intermediate_size}")
    unshard(model)
    modules = dict(model.named_modules())
    layers = {}
    for path, dim in specs.items():
        if dim is None:
            continue
        names = path.split("/")  # flax path: module path, then the leaf
        layers.setdefault(".".join(names[:-1]), {})[names[-1]] = dim
    for mod, leaves in layers.items():
        if "kernel" not in leaves:
            raise ValueError(f"{mod}: a tensor-parallel bias needs its "
                             "weight split too")
        shard_layer(modules[mod], leaves["kernel"], devices,
                    split_bias="bias" in leaves)
    return len(layers)


def unshard(model: nn.Module) -> None:
    """Drop every split: the model runs on its dense weights again (put
    back together on their device where the shards owned them)."""
    for mod in model.modules():
        sh = mod.__dict__.pop("tp", None)
        if sh is not None and sh.home is not None:
            mod.weight = nn.Parameter(
                torch.cat([w.to(sh.home) for w in sh.weights], sh.dim),
                requires_grad=mod.weight.requires_grad)


def split_layers(model: nn.Module) -> Dict[str, Shards]:
    """``{module name: its Shards}`` of every split layer."""
    return {name: mod.__dict__["tp"] for name, mod in model.named_modules()
            if "tp" in mod.__dict__}


def layout(model: nn.Module) -> Dict[str, int]:
    """The specs of ``model``'s current split (``{flax path: dim}``), to
    re-take it after new weights are loaded."""
    out = {}
    for name, sh in split_layers(model).items():
        path = name.replace(".", "/")
        out[f"{path}/kernel"] = sh.dim
        if sh.biases is not None:
            out[f"{path}/bias"] = 0
    return out
