"""The federated round bodies: port of ``bcfl_tpu/fed/client_step.py``
(``make_optimizer`` with optax's ``clip_by_global_norm``, ``make_loss_fn``
with ``loss_cls`` and ``loss_lm``, ``make_local_train``, and of the
GSPMD builder ``train_clients``, ``local_updates_body``,
``server_body``/``server_body_comp``, ``gossip_body``/``gossip_body_comp``,
``_mix_g``/``_mix_g_recv``, ``_compress_stage``, ``_recon``, the
split-phase codec programs ``encode_deltas``/``encode_deltas_local``/
``encode_deltas_async``/``decode_recon``/``decode_delta``, and
``broadcast``, ``adopt``, ``collapse`` with the configured aggregator).

The JAX package compiles every client's local round plus the aggregation
into one XLA program over a stacked ``[C, ...]`` client axis, sharded over
the mesh's ``clients`` axis. Here each client shard of a 1-D mesh has its
own scratch ``nn.Module`` on its own device (:class:`Sharded`), and the
caller's thread issues every shard's clients, shard after shard, while
the cards run what they were given (:func:`run_sharded`); within a shard
the clients run one after another. Each client loads its starting tree
(the round's global in server mode, its own row of the stacked tree in
serverless and async mode), copied to its shard's device with its batch
rows, trains with a fresh AdamW, and its post-train tree lands in row
``c`` of the stacked ``[C, ...]`` tree on the lead device (the first
shard's). The codec, the FedAvg mean and the ring gossip consume that
stack on the lead device, as the JAX stacked axis is consumed, so the bits
are the one-shard run's. An exception in any shard is raised in the
caller. Trees are ``{flax leaf path: tensor}`` dicts in
the JAX leaf order and layout
(:func:`bcfl_tpu_torch.models.convert.trainable_tree`), so codec payloads
match the JAX package's.

Under LoRA the trainable tree is the adapter tree
(:mod:`bcfl_tpu_torch.models.lora`) over the frozen base the scratch
module holds: the local round attaches the client's adapters to the
module (merged per layer in the forward), and the fresh optimizer covers
the adapters and heads only. With heterogeneous ranks, ``rmask`` (the
``[C, R]`` :func:`~bcfl_tpu_torch.models.lora.rank_mask`) clips each
client's starting tree to its own rank at train entry and its delta before
the codec, as the JAX programs do.

:func:`build_programs` binds these bodies to one model and
:class:`~bcfl_tpu_torch.core.mesh.ClientMesh` (``FedPrograms``): with
``tp > 1`` the model's frozen base must already be split over the mesh's
inner devices (:func:`bcfl_tpu_torch.parallel.tp_linear.shard_base`), with
``sp > 1`` its attention must ride the ring
(:func:`bcfl_tpu_torch.parallel.sp.ring_config`); the round bodies are
the same either way, as the JAX package's GSPMD bodies are.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bcfl_tpu_torch.compression import codecs as cc
from bcfl_tpu_torch.core.mesh import ClientMesh
from bcfl_tpu_torch.models import lora
from bcfl_tpu_torch.models.convert import (leaf_specs, load_trainable,
                                           trainable_tree)
from bcfl_tpu_torch.parallel import (gossip_mix, gossip_mix_recv,
                                     masked_weighted_mean)
from bcfl_tpu_torch.parallel import tp_linear
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
    """``loss_fn(batch, generator) -> (loss, correct, n)``.
    ``classification``: softmax cross entropy over the labels, averaged
    over the examples the example mask keeps. ``causal_lm``: next-token
    cross entropy, the targets ``ids`` shifted left, each token weighted
    by the padding mask times the example mask; ``n`` counts tokens.
    ``generator=None`` runs without dropout (evaluation)."""

    def loss_lm(batch, generator: Optional[torch.Generator]):
        logits = model(batch["ids"], batch["mask"],
                       deterministic=generator is None, generator=generator)
        targets = batch["ids"][:, 1:].long()
        logits = logits[:, :-1]
        w = (batch["mask"][:, 1:].float()
             * batch["example_mask"].float()[:, None])
        per_tok = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                  targets.reshape(-1), reduction="none")
        per_tok = per_tok.view(targets.shape)
        n = w.sum()
        loss = (per_tok * w).sum() / torch.clamp(n, min=1.0)
        correct = ((logits.argmax(-1) == targets).float() * w).sum()
        return loss, correct, n

    if task == "causal_lm":
        return loss_lm
    if task != "classification":
        raise ValueError(f"unknown task {task!r}")

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


def _steps(loss_fn: Callable, opt: torch.optim.Optimizer, leaves,
           batches: Tree, generator, max_grad_norm: float) -> torch.Tensor:
    """One optimizer step per ``[steps, ...]`` batch; the summed
    ``[loss*n, correct, n]``."""
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
    return stats


def make_local_train(model: nn.Module, loss_fn: Callable,
                     optimizer: str = "adamw", lr: float = 5e-5,
                     max_grad_norm: float = 0.0,
                     adapters: bool = False) -> Callable:
    """One client's local round:
    ``(trainable, batches, generator) -> (trainable', [loss*n, correct, n])``
    with a fresh optimizer state, one step per ``[steps, ...]`` batch;
    with ``max_grad_norm > 0`` each step's gradients are clipped first.
    With ``adapters`` the trainable tree is a LoRA adapter tree over the
    frozen parameters ``model`` holds: fresh leaf copies of it are attached
    to the model and trained, the base never changes."""
    if adapters:
        def local_train_lora(trainable: Tree, batches: Tree,
                             generator: Optional[torch.Generator]):
            leaves = {p: x.detach().clone().requires_grad_(True)
                      for p, x in trainable.items()}  # JAX leaf order
            with lora.attached(model, leaves):
                model.train()
                opt = make_optimizer(list(leaves.values()), optimizer, lr)
                stats = _steps(loss_fn, opt, list(leaves.values()), batches,
                               generator, max_grad_norm)
            return {p: x.detach() for p, x in leaves.items()}, stats

        return local_train_lora

    named = dict(model.named_parameters())
    leaves = [named[s.key] for s in leaf_specs(model)]  # JAX leaf order

    def local_train(trainable: Tree, batches: Tree,
                    generator: Optional[torch.Generator]):
        load_trainable(model, trainable)
        model.train()
        opt = make_optimizer(model.parameters(), optimizer, lr)
        stats = _steps(loss_fn, opt, leaves, batches, generator,
                       max_grad_norm)
        return trainable_tree(model), stats

    return local_train


def make_eval_one(model: nn.Module, loss_fn: Callable,
                  adapters: bool = False) -> Callable:
    """``(trainable, batches) -> [loss*n, correct, n]`` summed over the
    ``[steps, ...]`` eval batches, without dropout; with ``adapters`` the
    trainable tree is a LoRA adapter tree over ``model``'s frozen base."""

    @torch.no_grad()
    def eval_one(trainable: Tree, batches: Tree) -> torch.Tensor:
        if adapters:
            lora.attach(model, trainable)
        else:
            load_trainable(model, trainable)
        model.eval()
        stats = torch.zeros(3, device=batches["ids"].device)
        try:
            for s in range(batches["ids"].shape[0]):
                loss, correct, n = loss_fn(
                    {k: v[s] for k, v in batches.items()}, None)
                stats += torch.stack([loss * n, correct, n])
        finally:
            if adapters:
                lora.detach(model)
        return stats

    return eval_one


@dataclasses.dataclass(eq=False)
class Sharded:
    """One round body per client shard: shard ``s`` runs clients
    ``[s * per_device, (s + 1) * per_device)`` on ``devices[s]`` through
    ``bodies[s]``, bound to that shard's own scratch module. Called
    directly it is shard 0's body, on the lead device (the faithful round,
    the global evaluation, the dist runtime's pieces)."""

    bodies: List[Callable]
    devices: List[torch.device]
    per_device: int

    def __call__(self, *args, **kwargs):
        return self.bodies[0](*args, **kwargs)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]


def _shards(body) -> Optional[Sharded]:
    """``body`` as a :class:`Sharded` of more than one shard, else None
    (one body: the clients run one after another, each landed at once)."""
    if isinstance(body, Sharded) and len(body.bodies) > 1:
        return body
    return None


def run_sharded(sh: Sharded, inputs: Sequence[tuple]) -> list:
    """``sh.bodies[s](*inputs[c])`` for every client ``c`` of every shard
    ``s``, all issued from the caller's thread. First every client's
    ``inputs`` (trees and tensors on the lead device; generators, made on
    the client's device, and None pass as they are) are copied to its
    shard's device, a tensor that several clients share once per device;
    then each shard's clients run one after another under its device, shard
    after shard. A copy between two cards only orders their current streams
    and nothing in a body waits on the card, so each card works through
    its shard while this thread issues the next. Returns the per-client
    outputs, on the shards' devices, in client order; the caller lands
    them on the lead device after every shard is issued (a copy between
    cards issued earlier would hold a shard back behind the lead's
    queue). An exception in a body is raised as it is, its shard named in
    a note; the shards after it do not run."""
    per, copies = sh.per_device, {}

    def to(x, dev: torch.device):
        if isinstance(x, dict):
            return {k: to(v, dev) for k, v in x.items()}
        if not isinstance(x, torch.Tensor) or x.device == dev:
            return x
        key = (id(x), dev)  # every input stays alive until the round ends
        if key not in copies:
            copies[key] = x.to(dev, non_blocking=True)
        return copies[key]

    staged = [tuple(to(a, sh.devices[c // per]) for a in args)
              for c, args in enumerate(inputs)]
    outs = []
    for s, (body, dev) in enumerate(zip(sh.bodies, sh.devices)):
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            for args in staged[s * per:(s + 1) * per]:
                try:
                    outs.append(body(*args))
                except Exception as err:
                    err.add_note(f"in client shard {s} on {dev}")
                    raise
    return outs


def _train_each(local_train: Callable, start_of: Callable, batches: Tree,
                generators: List[Optional[torch.Generator]], like: Tree,
                rmask: Optional[torch.Tensor] = None):
    C = batches["ids"].shape[0]
    new_t = {p: torch.empty((C,) + tuple(x.shape), dtype=x.dtype,
                            device=x.device) for p, x in like.items()}

    def start(c):
        if rmask is None:
            return start_of(c)
        # heterogeneous ranks: a client never sees the fleet's higher-rank
        # components
        return lora.clip_adapters(start_of(c), rmask[c])

    sh = _shards(local_train)
    if sh is None:
        stats = []
        for c in range(C):
            t, s = local_train(start(c), {k: v[c] for k, v in batches.items()},
                               generators[c])
            for p, x in t.items():
                new_t[p][c] = x
            stats.append(s)
        return new_t, torch.stack(stats)
    outs = run_sharded(sh, [(start(c), {k: v[c] for k, v in batches.items()},
                             generators[c]) for c in range(C)])
    for c, (t, _) in enumerate(outs):
        for p, x in t.items():
            new_t[p][c].copy_(x)
    return new_t, torch.stack([s.to(sh.lead) for _, s in outs])


def eval_clients(eval_one: Callable, tree_of: Callable, batches: Tree
                 ) -> torch.Tensor:
    """Each client's ``[loss*n, correct, n]`` of ``tree_of(c)`` on its own
    ``batches[c]``, ``[C, 3]`` on the lead device; the clients of a
    :class:`Sharded` ``eval_one`` on their shards' devices."""
    C = batches["ids"].shape[0]
    rows = [(tree_of(c), {k: v[c] for k, v in batches.items()})
            for c in range(C)]
    sh = _shards(eval_one)
    if sh is None:
        return torch.stack([eval_one(*r) for r in rows])
    return torch.stack([s.to(sh.lead) for s in run_sharded(sh, rows)])


def train_clients(local_train: Callable, global_t: Tree, batches: Tree,
                  generators: List[Optional[torch.Generator]],
                  rmask: Optional[torch.Tensor] = None):
    """Every client trains from ``global_t`` (clipped to its rank by
    ``rmask``) on its own ``batches[c]``:
    ``-> (stacked [C, ...] trees, stats [C, 3])``."""
    return _train_each(local_train, lambda c: global_t, batches, generators,
                       global_t, rmask)


def local_updates(local_train: Callable, client_t: Tree, batches: Tree,
                  generators: List[Optional[torch.Generator]],
                  rmask: Optional[torch.Tensor] = None):
    """Every client trains from its OWN row of the stacked ``client_t``
    (``local_updates_body``): ``-> (stacked [C, ...] trees, stats [C, 3])``."""
    like = {p: x[0] for p, x in client_t.items()}
    return _train_each(local_train,
                       lambda c: {p: x[c] for p, x in client_t.items()},
                       batches, generators, like, rmask)


def compress_stage(comp: cc.CompressionConfig, new_t: Tree, ref_t: Tree,
                   resid: Tree, uniforms: Optional[cc.Uniforms],
                   rmask: Optional[torch.Tensor] = None):
    """Sender side of one wire exchange: ``(payload, decoded, resid')`` for
    ``delta = new_t - ref_t`` plus the carried error-feedback residual
    (``_compress_stage``). ``ref_t`` is the global (server mode, it
    broadcasts) or the stacked round-start tree (serverless, async). With
    heterogeneous ranks the delta's padding dims (``-ref`` there) are
    clipped first: they are not the client's to ship."""
    comp_in = {p: new_t[p].float() - ref_t[p].float() for p in new_t}
    if rmask is not None:
        comp_in = lora.clip_stacked(comp_in, rmask)
    if comp.error_feedback:
        for p, d in comp_in.items():
            d.add_(resid[p])
    return cc.exchange(comp, comp_in, resid, uniforms, owned=True)


def recon(ref_t: Tree, dec: Tree, like_t: Tree) -> Tree:
    """Receiver-side reconstruction ``ref + decoded delta`` in the param
    dtype (``_recon``): what the aggregator consumes. Computed in
    ``dec``'s memory (``dec`` is spent afterwards); the sum is the same
    bits either way round."""
    return {p: dec[p].add_(ref_t[p].float()).to(like_t[p].dtype)
            for p in dec}


def decode_recon(comp: cc.CompressionConfig, payload: dict, ref_t: Tree,
                 like_t: Tree) -> Tree:
    """The reconstruction ``ref + decoded`` from a payload alone
    (``decode_recon``): what a receiver rebuilds from a payload that was
    corrupted in transport."""
    return recon(ref_t, cc.decode_tree(comp, payload, like_t), like_t)


def decode_delta(comp: cc.CompressionConfig, payload: dict,
                 like_t: Tree) -> Tree:
    """The decoded stacked deltas in the param dtype (``decode_delta``):
    what the async merge averages."""
    return {p: d.to(like_t[p].dtype)
            for p, d in cc.decode_tree(comp, payload, like_t).items()}


def encode_deltas(comp: cc.CompressionConfig, new_t: Tree, ref_t: Tree,
                  resid: Tree, uniforms: Optional[cc.Uniforms],
                  rmask: Optional[torch.Tensor] = None):
    """``(payload, recon, resid')``: the codec stage plus the receiver's
    reconstruction against ``ref_t`` (``encode_deltas`` for a global
    ``ref_t``, ``encode_deltas_local`` for the stacked round-start
    tree)."""
    payload, dec, resid = compress_stage(comp, new_t, ref_t, resid, uniforms,
                                         rmask)
    return payload, recon(ref_t, dec, new_t), resid


def encode_deltas_async(comp: cc.CompressionConfig, new_t: Tree, ref_t: Tree,
                        resid: Tree, uniforms: Optional[cc.Uniforms],
                        rmask: Optional[torch.Tensor] = None):
    """``(payload, resid')``, recon-free (``encode_deltas_async``): the
    async merge decodes the deltas itself."""
    payload, _, resid = compress_stage(comp, new_t, ref_t, resid, uniforms,
                                       rmask)
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


def collapse(stacked: Tree, weights: torch.Tensor, fallback: Tree,
             agg: Optional[Callable] = None) -> Tree:
    """The aggregation rule over the client axis (``collapse``): ``agg``
    (:func:`bcfl_tpu_torch.parallel.make_aggregator`), the masked weighted
    mean by default."""
    return (agg or masked_weighted_mean)(stacked, weights, fallback)


def exact_mean_spread(avg: Tree, new_t: Tree, mask: torch.Tensor) -> Tree:
    """Serverless exact-mean aggregation: every unmasked client adopts the
    (mask-weighted) average, masked clients keep their own state
    (``_exact_mean_spread``)."""
    return {p: torch.where(_col(mask, x) > 0, avg[p].expand_as(x), x)
            for p, x in new_t.items()}


def mix(new_t: Tree, mask: torch.Tensor, fallback: Tree, alpha: float,
        steps: int, agg: Optional[Callable] = None) -> Tree:
    """The serverless mix (``_mix_g``): ``steps == 0`` spreads the exact
    masked aggregate (``agg``), otherwise ``steps`` rounds of ring gossip,
    which keeps its pairwise mixing rule whatever the aggregator."""
    if steps == 0:
        return exact_mean_spread(collapse(new_t, mask, fallback, agg), new_t,
                                 mask)
    return gossip_mix(new_t, mask, alpha, steps=steps)


def mix_recv(self_t: Tree, recv_t: Tree, mask: torch.Tensor, fallback: Tree,
             alpha: float, steps: int, agg: Optional[Callable] = None) -> Tree:
    """The transport-aware mix (``_mix_g_recv``): neighbour and aggregate
    terms from ``recv_t`` (what arrived), each sender's self-term (and a
    masked client's kept state) from its own ``self_t``."""
    if steps == 0:
        return exact_mean_spread(collapse(recv_t, mask, fallback, agg),
                                 self_t, mask)
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


def _replica(model: nn.Module, device: torch.device) -> nn.Module:
    """A copy of ``model`` on ``device``, the same weights: each parameter
    and buffer is copied straight to ``device`` (never a second copy on
    the model's own card, which a 7B frozen base would not fit)."""
    memo = {}
    for t in model.parameters():
        memo[id(t)] = nn.Parameter(t.detach().to(device, copy=True),
                                   requires_grad=t.requires_grad)
    for t in model.buffers():
        memo[id(t)] = t.to(device, copy=True)
    return copy.deepcopy(model, memo).to(device)


@dataclasses.dataclass
class FedPrograms:
    """The round and evaluation bodies bound to one (model, mesh,
    optimizer): :class:`Sharded`, one body per client shard that trains on
    its own device."""

    mesh: ClientMesh
    # (trainable, batches, generator) -> (trainable, stats)
    local_train: Sharded
    eval_one: Sharded  # (trainable, batches) -> [loss*n, correct, n]
    # (client_t, batches, mask, generators, resid=None, uniforms=None)
    gossip_round: Callable


def build_programs(model: nn.Module, mesh: ClientMesh,
                   optimizer: str = "adamw", learning_rate: float = 5e-5,
                   max_grad_norm: float = 0.0, gossip_alpha: float = 0.5,
                   gossip_steps: int = 1, task: str = "classification",
                   compression: Optional[cc.CompressionConfig] = None,
                   adapters: bool = False) -> FedPrograms:
    """The :class:`FedPrograms` of ``model`` on ``mesh``. The ``impl``
    choice of the JAX ``build_programs`` (and its refusal of
    ``shard_map`` on a 2-D mesh) has no counterpart: the port has one
    implementation of every body. What it checks instead is that the
    model carries the mesh's inner axis, so that nothing runs ``tp > 1``
    dense or ``sp > 1`` without the ring.

    On a 1-D mesh of more than one client shard, shard ``s > 0`` trains
    and evaluates on its own scratch copy of ``model`` (the same weights)
    on ``mesh.client_devices[s]``, and shard 0 on ``model``, which must be
    on the first. A 2-D mesh keeps every client on ``model`` (the first
    client shard's devices), whatever its number of client shards."""
    if mesh.tp > 1:
        split = {len(sh.weights)
                 for sh in tp_linear.split_layers(model).values()}
        if split != {mesh.tp}:
            raise ValueError(
                f"a tp={mesh.tp} mesh needs the model's frozen base split "
                f"{mesh.tp} ways (tp_linear.shard_base), found "
                f"{sorted(split) or 'no split layer'}")
    if mesh.sp > 1 and model.cfg.attention_override is None:
        raise ValueError(
            f"an sp={mesh.sp} mesh needs the model's attention on the ring "
            "(sp.ring_config)")
    devices = mesh.train_devices
    models = [model] + [_replica(model, d) for d in devices[1:]]
    trains, evals = [], []
    for m in models:
        loss_fn = make_loss_fn(m, task)
        trains.append(make_local_train(m, loss_fn, optimizer, learning_rate,
                                       max_grad_norm, adapters=adapters))
        evals.append(make_eval_one(m, loss_fn, adapters=adapters))
    per = mesh.num_clients // len(devices)
    local_train = Sharded(trains, devices, per)
    comp = (compression if compression is not None and compression.enabled
            else None)
    return FedPrograms(
        mesh=mesh, local_train=local_train,
        eval_one=Sharded(evals, devices, per),
        gossip_round=functools.partial(gossip_round, local_train, comp,
                                       alpha=gossip_alpha,
                                       steps=gossip_steps))
