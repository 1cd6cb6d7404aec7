"""The federated round bodies: port of ``bcfl_tpu/fed/client_step.py``
(``make_optimizer`` with optax's ``clip_by_global_norm``, ``make_loss_fn``,
``make_local_train``, and of the
GSPMD builder ``train_clients``, ``local_updates_body``,
``server_body``/``server_body_comp``, ``gossip_body``/``gossip_body_comp``,
``_mix_g``/``_mix_g_recv``, ``_compress_stage``, ``_recon``, the
split-phase codec programs ``encode_deltas``/``encode_deltas_local``/
``encode_deltas_async``/``decode_delta``, and
``broadcast``, ``adopt``, ``collapse``).

The JAX package compiles every client's local round plus the aggregation
into one XLA program over a stacked ``[C, ...]`` client axis. Here the
clients run one after another on the one device through a single scratch
``nn.Module``: each loads its starting tree (the round's global in server
mode, its own row of the stacked tree in serverless and async mode),
trains with a fresh AdamW, and its post-train tree lands in row ``c`` of
the stacked ``[C, ...]`` tree that the codec, the FedAvg mean and the ring
gossip consume, as the JAX stacked axis does. Trees are ``{flax leaf
path: tensor}`` dicts in the JAX leaf order and layout
(:func:`bcfl_tpu_torch.models.convert.trainable_tree`), so codec payloads
match the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from bcfl_tpu_torch.compression import codecs as cc
from bcfl_tpu_torch.models.convert import (leaf_specs, load_trainable,
                                           trainable_tree)
from bcfl_tpu_torch.parallel import (gossip_mix, gossip_mix_recv,
                                     masked_weighted_mean)
from bcfl_tpu_torch.parallel.collectives import _col

Tree = Dict[str, torch.Tensor]


def make_optimizer(params, name: str = "adamw", lr: float = 5e-5
                   ) -> torch.optim.Optimizer:
    """A fresh optimizer for one local round: ``adamw`` is AdamW with
    PyTorch's defaults (betas 0.9/0.999, eps 1e-8, weight decay 0.01), the
    optax ``adamw`` of the JAX package; ``sgd`` is plain SGD (no momentum,
    no weight decay), ``optax.sgd``. The moments are held in the params'
    dtype, as optax's are."""
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=0.01)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr)
    raise ValueError(f"unknown optimizer {name!r}")


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float
                         ) -> None:
    """optax's ``clip_by_global_norm``, in place: with the global norm
    ``g = sqrt(sum of every leaf's sum of squares)``, every gradient
    becomes ``(t / g) * max_norm`` where ``g >= max_norm`` and stays as it
    is otherwise (``torch.nn.utils.clip_grad_norm_`` scales by
    ``max_norm / (g + 1e-6)`` instead). As in optax, the sums, the norm and
    the scaling are in the leaves' dtype, ``max_norm`` cast to it, and the
    leaves are summed in the order given (the JAX leaf order). No host
    sync: both branches are computed and selected on the device."""
    total = 0
    for t in grads:
        total = total + (t * t).sum()
    norm = torch.sqrt(total)
    bound = torch.tensor(max_norm, dtype=norm.dtype, device=norm.device)
    keep = norm < bound
    for t in grads:
        n, b = norm.to(t.dtype), bound.to(t.dtype)
        t.copy_(torch.where(keep, t, t / n * b))


def make_loss_fn(model: nn.Module, task: str = "classification") -> Callable:
    """``loss_fn(batch, generator) -> (loss, correct, n)``: softmax cross
    entropy over the labels, averaged over the examples the example mask
    keeps. ``generator=None`` runs without dropout (evaluation)."""
    if task != "classification":
        raise ValueError(f"task={task!r} is not ported yet")

    def loss_cls(batch, generator: Optional[torch.Generator]):
        logits = model(batch["ids"], batch["mask"],
                       deterministic=generator is None, generator=generator)
        labels = batch["labels"].long()
        ex = batch["example_mask"].float()
        per_ex = F.cross_entropy(logits, labels, reduction="none")
        n = ex.sum()
        loss = (per_ex * ex).sum() / torch.clamp(n, min=1.0)
        correct = ((logits.argmax(-1) == labels).float() * ex).sum()
        return loss, correct, n

    return loss_cls


def make_local_train(model: nn.Module, loss_fn: Callable,
                     optimizer: str = "adamw", lr: float = 5e-5,
                     max_grad_norm: float = 0.0) -> Callable:
    """One client's local round:
    ``(trainable, batches, generator) -> (trainable', [loss*n, correct, n])``
    with a fresh optimizer state, one step per ``[steps, ...]`` batch;
    with ``max_grad_norm > 0`` each step's gradients are clipped first."""
    named = dict(model.named_parameters())
    leaves = [named[s.key] for s in leaf_specs(model)]  # JAX leaf order

    def local_train(trainable: Tree, batches: Tree,
                    generator: Optional[torch.Generator]):
        load_trainable(model, trainable)
        model.train()
        opt = make_optimizer(model.parameters(), optimizer, lr)
        stats = torch.zeros(3, device=batches["ids"].device)
        for s in range(batches["ids"].shape[0]):
            batch = {k: v[s] for k, v in batches.items()}
            loss, correct, n = loss_fn(batch, generator)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            if max_grad_norm > 0:
                clip_by_global_norm_([p.grad for p in leaves], max_grad_norm)
            opt.step()
            stats += torch.stack([loss.detach() * n, correct, n])
        return trainable_tree(model), stats

    return local_train


def make_eval_one(model: nn.Module, loss_fn: Callable) -> Callable:
    """``(trainable, batches) -> [loss*n, correct, n]`` summed over the
    ``[steps, ...]`` eval batches, without dropout."""

    @torch.no_grad()
    def eval_one(trainable: Tree, batches: Tree) -> torch.Tensor:
        load_trainable(model, trainable)
        model.eval()
        stats = torch.zeros(3, device=batches["ids"].device)
        for s in range(batches["ids"].shape[0]):
            loss, correct, n = loss_fn({k: v[s] for k, v in batches.items()},
                                       None)
            stats += torch.stack([loss * n, correct, n])
        return stats

    return eval_one


def _train_each(local_train: Callable, start_of: Callable, batches: Tree,
                generators: List[Optional[torch.Generator]], like: Tree):
    C = batches["ids"].shape[0]
    new_t = {p: torch.empty((C,) + tuple(x.shape), dtype=x.dtype,
                            device=x.device) for p, x in like.items()}
    stats = []
    for c in range(C):
        t, s = local_train(start_of(c), {k: v[c] for k, v in batches.items()},
                           generators[c])
        for p, x in t.items():
            new_t[p][c] = x
        stats.append(s)
    return new_t, torch.stack(stats)


def train_clients(local_train: Callable, global_t: Tree, batches: Tree,
                  generators: List[Optional[torch.Generator]]):
    """Every client trains from ``global_t`` on its own ``batches[c]``:
    ``-> (stacked [C, ...] trees, stats [C, 3])``."""
    return _train_each(local_train, lambda c: global_t, batches, generators,
                       global_t)


def local_updates(local_train: Callable, client_t: Tree, batches: Tree,
                  generators: List[Optional[torch.Generator]]):
    """Every client trains from its OWN row of the stacked ``client_t``
    (``local_updates_body``): ``-> (stacked [C, ...] trees, stats [C, 3])``."""
    like = {p: x[0] for p, x in client_t.items()}
    return _train_each(local_train,
                       lambda c: {p: x[c] for p, x in client_t.items()},
                       batches, generators, like)


def compress_stage(comp: cc.CompressionConfig, new_t: Tree, ref_t: Tree,
                   resid: Tree, uniforms: Optional[cc.Uniforms]):
    """Sender side of one wire exchange: ``(payload, decoded, resid')`` for
    ``delta = new_t - ref_t`` plus the carried error-feedback residual
    (``_compress_stage``). ``ref_t`` is the global (server mode, it
    broadcasts) or the stacked round-start tree (serverless, async)."""
    comp_in = {}
    for p in new_t:
        d = new_t[p].float() - ref_t[p].float()
        comp_in[p] = d.add_(resid[p]) if comp.error_feedback else d
    return cc.exchange(comp, comp_in, resid, uniforms, owned=True)


def recon(ref_t: Tree, dec: Tree, like_t: Tree) -> Tree:
    """Receiver-side reconstruction ``ref + decoded delta`` in the param
    dtype (``_recon``): what the aggregator consumes. Computed in
    ``dec``'s memory (``dec`` is spent afterwards); the sum is the same
    bits either way round."""
    return {p: dec[p].add_(ref_t[p].float()).to(like_t[p].dtype)
            for p in dec}


def decode_delta(comp: cc.CompressionConfig, payload: dict,
                 like_t: Tree) -> Tree:
    """The decoded stacked deltas in the param dtype (``decode_delta``):
    what the async merge averages."""
    return {p: d.to(like_t[p].dtype)
            for p, d in cc.decode_tree(comp, payload, like_t).items()}


def encode_deltas(comp: cc.CompressionConfig, new_t: Tree, ref_t: Tree,
                  resid: Tree, uniforms: Optional[cc.Uniforms]):
    """``(payload, recon, resid')``: the codec stage plus the receiver's
    reconstruction against ``ref_t`` (``encode_deltas`` for a global
    ``ref_t``, ``encode_deltas_local`` for the stacked round-start
    tree)."""
    payload, dec, resid = compress_stage(comp, new_t, ref_t, resid, uniforms)
    return payload, recon(ref_t, dec, new_t), resid


def encode_deltas_async(comp: cc.CompressionConfig, new_t: Tree, ref_t: Tree,
                        resid: Tree, uniforms: Optional[cc.Uniforms]):
    """``(payload, resid')``, recon-free (``encode_deltas_async``): the
    async merge decodes the deltas itself."""
    payload, _, resid = compress_stage(comp, new_t, ref_t, resid, uniforms)
    return payload, resid


# --------------------------------------------------- client-axis programs


def broadcast(global_t: Tree, num_clients: int) -> Tree:
    """global tree -> stacked ``[C, ...]`` per-client tree."""
    return {p: x.unsqueeze(0).expand((num_clients,) + tuple(x.shape)).clone()
            for p, x in global_t.items()}


def adopt(client_t: Tree, global_t: Tree, pull: torch.Tensor) -> Tree:
    """Pull-masked clients adopt ``global_t``, everyone else keeps their
    stacked row (``_adopt_pull``)."""
    return {p: torch.where(_col(pull, x) > 0,
                           global_t[p].to(x.dtype).expand_as(x), x)
            for p, x in client_t.items()}


def collapse(stacked: Tree, weights: torch.Tensor, fallback: Tree) -> Tree:
    """The aggregation rule over the client axis (``collapse``; the port
    has the mean only)."""
    return masked_weighted_mean(stacked, weights, fallback)


def exact_mean_spread(avg: Tree, new_t: Tree, mask: torch.Tensor) -> Tree:
    """Serverless exact-mean aggregation: every unmasked client adopts the
    (mask-weighted) average, masked clients keep their own state
    (``_exact_mean_spread``)."""
    return {p: torch.where(_col(mask, x) > 0, avg[p].expand_as(x), x)
            for p, x in new_t.items()}


def mix(new_t: Tree, mask: torch.Tensor, fallback: Tree, alpha: float,
        steps: int) -> Tree:
    """The serverless mix (``_mix_g``): ``steps == 0`` spreads the exact
    masked mean, otherwise ``steps`` rounds of ring gossip."""
    if steps == 0:
        return exact_mean_spread(collapse(new_t, mask, fallback), new_t, mask)
    return gossip_mix(new_t, mask, alpha, steps=steps)


def mix_recv(self_t: Tree, recv_t: Tree, mask: torch.Tensor, fallback: Tree,
             alpha: float, steps: int) -> Tree:
    """The transport-aware mix (``_mix_g_recv``): neighbour and aggregate
    terms from ``recv_t`` (what arrived), each sender's self-term (and a
    masked client's kept state) from its own ``self_t``."""
    if steps == 0:
        return exact_mean_spread(collapse(recv_t, mask, fallback), self_t,
                                 mask)
    return gossip_mix_recv(self_t, recv_t, mask, alpha, steps=steps)


# ------------------------------------------------------------ round bodies


@dataclasses.dataclass
class RoundOut:
    global_t: Tree  # the new global tree (serverless: the mixed stack)
    stats: torch.Tensor  # [C, 3] per-client [loss*n, correct, n]
    resid: Optional[Tree] = None  # error-feedback state (codec on)
    payload: Optional[dict] = None  # what crossed the wire (codec on)


def server_round(local_train: Callable, comp: Optional[cc.CompressionConfig],
                 global_t: Tree, batches: Tree, weights: torch.Tensor,
                 generators: List[Optional[torch.Generator]],
                 resid: Optional[Tree] = None,
                 uniforms: Optional[cc.Uniforms] = None) -> RoundOut:
    """One FedAvg round (``server_body`` / ``server_body_comp``): every
    client trains from the global; with a codec, each client's delta goes
    through ``roundtrip`` with its carried residual and the server averages
    the reconstructions ``global + decoded``, never the full-precision
    updates. An all-masked round keeps ``global_t``. ``FedEngine`` runs
    the same steps split around its ledger seam."""
    new_t, stats = train_clients(local_train, global_t, batches, generators)
    if comp is None or not comp.enabled:
        return RoundOut(masked_weighted_mean(new_t, weights, global_t), stats)
    payload, rec, resid = encode_deltas(comp, new_t, global_t, resid,
                                        uniforms)
    del new_t
    avg = masked_weighted_mean(rec, weights, global_t)
    return RoundOut(avg, stats, resid, payload)


def gossip_round(local_train: Callable, comp: Optional[cc.CompressionConfig],
                 client_t: Tree, batches: Tree, mask: torch.Tensor,
                 generators: List[Optional[torch.Generator]],
                 resid: Optional[Tree] = None,
                 uniforms: Optional[cc.Uniforms] = None,
                 alpha: float = 0.5, steps: int = 1) -> RoundOut:
    """One serverless round (``gossip_body`` / ``gossip_body_comp``): every
    client trains from its own stacked row and the peers mix. With a codec,
    each peer ships its delta against its own round-start params; the
    neighbour terms come from the lossy reconstruction, each sender's
    self-term stays its honest post-train tree. ``global_t`` of the result
    is the mixed ``[C, ...]`` stack. ``FedEngine`` runs the same steps
    split around its ledger seam."""
    new_t, stats = local_updates(local_train, client_t, batches, generators)
    if comp is None or not comp.enabled:
        return RoundOut(mix(new_t, mask, client_t, alpha, steps), stats)
    payload, rec, resid = encode_deltas(comp, new_t, client_t, resid,
                                        uniforms)
    mixed = mix_recv(new_t, rec, mask, client_t, alpha, steps)
    return RoundOut(mixed, stats, resid, payload)
