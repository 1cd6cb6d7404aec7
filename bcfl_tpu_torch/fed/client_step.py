"""The federated round bodies: port of ``bcfl_tpu/fed/client_step.py``
(``make_optimizer`` with optax's ``clip_by_global_norm``, ``make_loss_fn``
with ``loss_cls`` and ``loss_lm``, ``make_local_train``, and of the
GSPMD builder ``train_clients``, ``local_updates_body``,
``server_body``/``server_body_comp``, ``gossip_body``/``gossip_body_comp``,
``_mix_g``/``_mix_g_recv``, ``_compress_stage``, ``_recon``, the fused
multi-round programs ``server_rounds``/``gossip_rounds`` with their
``_transport``, ``_fp_auth`` and ``_fp_auth_payload`` stages, the
split-phase codec programs ``encode_deltas``/``encode_deltas_local``/
``encode_deltas_async``/``decode_recon``/``decode_delta``, and
``broadcast``, ``adopt``, ``collapse`` with the configured aggregator).

The JAX package compiles every client's local round plus the aggregation
into one XLA program over a stacked ``[C, ...]`` client axis, sharded over
the mesh's ``clients`` axis. Here each client shard has its own scratch
``nn.Module`` on its own device (:class:`Sharded`), on a 2-D mesh on its
own row of devices (under ``tp`` its own split of the frozen base, under
``sp`` its own ring), and the caller's thread issues every shard's
clients, shard after shard, while the cards run what they were given
(:func:`run_sharded`); within a shard
the clients run one after another. Each client loads its starting tree
(the round's global in server mode, its own row of the stacked tree in
serverless and async mode), copied to its shard's device with its batch
rows, and trains with a fresh AdamW. With a codec on a mesh of more than
one shard, the sender's side of the exchange runs on the shard's device
too, as JAX constrains ``_compress_stage``'s payload and residual to
``P('clients')`` (:class:`Sender`): the shard's post-train rows are
stacked there, their deltas encoded, and the error-feedback residual rows
stay there; only the payload rows land on the lead device (the first
shard's), in client order. Without a codec, or on one shard, every
post-train tree lands in row ``c`` of the stacked ``[C, ...]`` tree on
the lead device.

The stacked per-client state of the serverless, async and partitioned
rounds lives where JAX's ``P('clients')`` keeps it when it is a
:class:`Stacked` (a mesh of more than one shard): each shard's rows on
its own device from the broadcast to the end of the run. Its clients
train from those rows, their post-train rows stay there, each shard
decodes its own payload rows against its own round-start rows, and the
ring gossip mixes each shard's rows with two halo rows copied from its
ring neighbours' shards (:func:`gossip_mix_rows`). Only what one
reduction over the client axis reads lands on the lead device, in client
order (the consensus, the ``steps == 0`` aggregate and the robust rules,
a partition component's aggregate, the async merge, the ledger's
fingerprint of an uncompressed stack), and it is reduced there as the
one-shard run reduces it, so the bits are the one-shard run's. Given a
plain ``[C, ...]`` tree, every body runs as it did before the stack was
kept on the shards: the tree's rows are staged to the shards and the
post-train rows land. An exception in any shard is raised in the caller,
its shard named. Trees are ``{flax leaf path: tensor}`` dicts in
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
``tp > 1`` the model's frozen base must already be split over the first
row's devices (:func:`bcfl_tpu_torch.parallel.tp_linear.shard_base`),
with ``sp > 1`` its attention must ride the first row's ring
(:func:`bcfl_tpu_torch.parallel.sp.ring_override`), and every other
row's copy gets its own; the round bodies are the same either way, as
the JAX package's GSPMD bodies are.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bcfl_tpu_torch.compression import codecs as cc
from bcfl_tpu_torch.core.fence import fence
from bcfl_tpu_torch.core.mesh import ClientMesh, process_index
from bcfl_tpu_torch.ledger import fingerprint as fp_lib
from bcfl_tpu_torch.models import lora
from bcfl_tpu_torch.models.convert import (leaf_specs, load_trainable,
                                           trainable_tree)
from bcfl_tpu_torch.parallel import (gossip_mix, gossip_mix_recv,
                                     masked_weighted_mean)
from bcfl_tpu_torch.parallel import pod, sp, tp_linear
from bcfl_tpu_torch.parallel.collectives import _col, gossip_step_mix

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


def _traffic() -> Dict[str, int]:
    return {"to_shards": 0, "to_lead": 0, "shard_to_shard": 0,
            "process_sent": 0, "process_received": 0}


def _on(dev: torch.device):
    """``dev`` as the current card while work is issued for it."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _nbytes(x) -> int:
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _packed(xs: Sequence[torch.Tensor]) -> Dict[torch.dtype, torch.Tensor]:
    """``xs`` flattened into one buffer per dtype, in order: a tree moves
    between cards in a copy per dtype, not one per leaf (each copy between
    cards costs the host tens of microseconds, whatever its size)."""
    by: Dict[torch.dtype, list] = {}
    for x in xs:
        by.setdefault(x.dtype, []).append(x.reshape(-1))
    return {dt: torch.cat(v) for dt, v in by.items()}


def _unpacked(bufs: Dict[torch.dtype, torch.Tensor],
              like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Views of :func:`_packed` buffers shaped like ``like``, its order."""
    sizes: Dict[torch.dtype, list] = {}
    for x in like:
        sizes.setdefault(x.dtype, []).append(x.numel())
    pieces = {dt: iter(torch.split(bufs[dt], n)) for dt, n in sizes.items()}
    return [next(pieces[x.dtype]).view(x.shape) for x in like]


@dataclasses.dataclass(eq=False)
class Sharded:
    """One round body per client shard: shard ``s`` runs clients
    ``[s * per_device, (s + 1) * per_device)`` on ``devices[s]`` (on a
    2-D mesh the first device of row ``s``, whose other devices carry the
    shard's inner shards) through ``bodies[s]``, bound to that shard's own
    scratch module. Called
    directly it is shard 0's body, on the lead device (the faithful round,
    the global evaluation, the dist runtime's pieces).

    ``traffic`` counts the bytes between shards since it was made, as the
    round bodies move them (:meth:`stage`, :meth:`land`, :meth:`halo`):
    ``to_shards`` what the lead copies to shards 1 and up, ``to_lead``
    what lands from them on the lead, ``shard_to_shard`` the ring
    gossip's halo rows, copied from one shard straight to another. It
    counts shards, not cards: on ``[cuda:0] * 4`` no byte crosses a card,
    and the count is what would. ``process_sent`` and
    ``process_received`` count the bytes this process sent to and
    received from the other processes of a pod, whatever moved them (0
    off a pod).

    On a pod (:mod:`bcfl_tpu_torch.parallel.pod`) ``owners[s]`` is the
    process that owns shard ``s`` and ``process`` this one, and this class
    alone decides what runs where. Only an owned shard's body runs here
    (:meth:`owned_shards`); another process's shard lives on a ``meta``
    device and its rows are :meth:`standin` tensors, which hold shapes and
    no data. The lead is shard 0's process's: only there does work on the
    lead device run (:meth:`on_lead`) and the host read it back
    (:meth:`read`, its value sent to the others). A copy between two
    processes' shards is a send and a receive through the host, issued by
    both in the same order."""

    bodies: List[Callable]
    devices: List[torch.device]
    per_device: int
    traffic: Dict[str, int] = dataclasses.field(default_factory=_traffic)
    #: the process owning each shard (default: all this process's)
    owners: Optional[List[int]] = None
    #: this process
    process: int = 0

    def __call__(self, *args, **kwargs):
        return self.bodies[0](*args, **kwargs)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    def owner(self, s: int) -> int:
        """The process owning shard ``s``."""
        return self.process if self.owners is None else self.owners[s]

    def owns(self, s: int) -> bool:
        """Whether shard ``s`` is this process's (its body runs here)."""
        return self.owner(s) == self.process

    def owned_shards(self) -> List[int]:
        """The shards whose bodies run in this process, in shard order
        (every shard off a pod)."""
        return [s for s in range(len(self.devices)) if self.owns(s)]

    def owned_clients(self) -> List[int]:
        """The clients this process trains, in client order."""
        per = self.per_device
        return [c for s in self.owned_shards()
                for c in range(s * per, (s + 1) * per)]

    @property
    def spans_processes(self) -> bool:
        """Whether the shards belong to more than one process (a pod)."""
        return self.owners is not None and len(set(self.owners)) > 1

    @staticmethod
    def standin(x):
        """Meta stand-ins of a tensor, or of every tensor of a dict, list
        or tuple (anything else as it is): their shapes, dtypes and
        strides, no data. They stand for another process's rows."""
        if isinstance(x, torch.Tensor):
            return torch.empty_like(x, device="meta")
        if isinstance(x, dict):
            return {k: Sharded.standin(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(Sharded.standin(v) for v in x)
        return x

    def on_lead(self, fn: Callable, like):
        """``fn()``, work on the lead device, where this process holds it
        (every process off a pod); elsewhere stand-ins of ``like``."""
        return fn() if self.owns(0) else self.standin(like)

    def read(self, fn: Callable):
        """``fn()``, a read-back of the lead device to the host, in every
        process: on a pod it runs in the lead's process alone and its
        value is sent to the others, so every host decision is the lead's
        everywhere."""
        if not self.spans_processes:
            return fn()
        return pod.decide(fn, self.owner(0))

    def share(self, tree: Tree, device) -> Tree:
        """The lead's ``tree`` on ``device`` in every process: the lead's
        process keeps its own (as every process off a pod, where
        ``device`` is the lead), another receives a copy (counted once
        in the lead's ``process_sent``)."""
        if not self.spans_processes:
            return tree
        xs = list(tree.values())
        bufs = _packed(xs)
        got = pod.broadcast(list(bufs.values()), self.owner(0))
        self.traffic["process_sent" if self.owns(0)
                     else "process_received"] += _nbytes(got)
        if self.owns(0):
            return tree
        out = {dt: h.to(device) for dt, h in zip(bufs, got)}
        return dict(zip(tree, _unpacked(out, xs)))

    def fence(self, *trees) -> None:
        """Block the host until the work on every device of this process
        that ``trees`` lie on is done: a :class:`Stacked`'s rows on the
        owned shards, a plain tree on the lead device where this process
        holds it; a :class:`Deferred` view or None is nothing to wait
        for."""
        for t in trees:
            if isinstance(t, Stacked):
                for s in self.owned_shards():
                    fence(t.rows[s])
            elif (t is not None and not isinstance(t, Deferred)
                  and self.owns(0)):
                fence(t)

    def rows(self) -> List[tuple]:
        """``(first client, end, device)`` of every shard."""
        per = self.per_device
        return [(s * per, (s + 1) * per, d)
                for s, d in enumerate(self.devices)]

    def _send(self, bufs: List[torch.Tensor], dst: int) -> None:
        pod.send(bufs, dst)
        self.traffic["process_sent"] += _nbytes(bufs)

    def _recv(self, like: List[torch.Tensor], src: int
              ) -> List[torch.Tensor]:
        """What process ``src`` sends with :meth:`_send`, in host memory,
        shaped like ``like``."""
        got = pod.recv(like, src)
        self.traffic["process_received"] += _nbytes(got)
        return got

    def _move(self, src: int, dst: int, tree: Tree) -> Tree:
        """Shard ``src``'s tree on shard ``dst``'s device as
        :func:`_packed` buffers, uncounted in the shard tallies: a plain
        copy when one process owns both (stand-ins when another one does),
        a send or a receive when this process owns one end."""
        xs, dev = list(tree.values()), self.devices[dst]
        a, b = self.owner(src), self.owner(dst)
        if a != b and self.process == a:
            self._send(list(_packed(xs).values()), b)
            return self.standin(tree)
        if a != b and self.process == b:
            like = _packed(self.standin(xs))
            bufs = {dt: h.to(dev, non_blocking=True) for dt, h in
                    zip(like, self._recv(list(like.values()), a))}
            return dict(zip(tree, _unpacked(bufs, xs)))
        try:
            bufs = {dt: x.to(dev, non_blocking=True)
                    for dt, x in _packed(xs).items()}
        except Exception as err:
            err.add_note(f"copying client shard {src}'s rows to client "
                         f"shard {dst} on {dev}")
            raise
        return dict(zip(tree, _unpacked(bufs, xs)))

    def stage(self, s: int, x, packed: Optional[dict] = None,
              replicated: bool = False):
        """A tensor or tree on the lead device copied to shard ``s``'s
        device, counted (shard 0's passes as it is). A tree crosses as
        :func:`_packed` buffers, packed once for every shard it goes to
        when the caller passes a ``packed`` cache (keyed by the tree's id:
        the caller keeps the tree alive). On a pod, a shard of another
        process than the lead's gets it through the host, sent once per
        receiving process with a cache; ``replicated`` marks what every
        process holds itself (inputs drawn from the seed: batches), copied
        from this process's own and never sent."""
        if not s:
            return x
        self.traffic["to_shards"] += _nbytes(x)
        dev = self.devices[s]
        xs = list(x.values()) if isinstance(x, dict) else [x]

        def tree(out):
            return dict(zip(x, out)) if isinstance(x, dict) else out[0]

        packed = {} if packed is None else packed
        a, b = self.owner(0), self.owner(s)
        if not replicated and a != b and self.process in (a, b):
            # once per receiving process, however many of its shards take it
            key = ("pod", id(x), b)
            if key not in packed and self.process == a:
                self._send(list(_packed(xs).values()), b)
                packed[key] = None
            if key not in packed:
                like = _packed(self.standin(xs))
                packed[key] = dict(zip(like, self._recv(list(like.values()),
                                                        a)))
            if self.process == b:
                bufs = {dt: h.to(dev, non_blocking=True)
                        for dt, h in packed[key].items()}
                return tree(_unpacked(bufs, xs))
        if not self.owns(s):
            # another process's shard: its stand-in, laid out as the copy
            return tree([torch.empty(t.shape, dtype=t.dtype, device=dev)
                         for t in xs])
        if not isinstance(x, dict):
            return x.to(dev, non_blocking=True)
        if id(x) not in packed:
            packed[id(x)] = _packed(list(x.values()))
        bufs = {dt: h.to(dev, non_blocking=True)
                for dt, h in packed[id(x)].items()}
        return dict(zip(x, _unpacked(bufs, list(x.values()))))

    def land(self, s: int, x: torch.Tensor) -> torch.Tensor:
        """Shard ``s``'s output ``x`` on the lead device, counted; on a
        pod, through the host when shard ``s`` is another process's than
        the lead's (a stand-in where the lead is another process's)."""
        if s:
            self.traffic["to_lead"] += _nbytes(x)
        a, b = self.owner(s), self.owner(0)
        if a != b and self.process == a:
            self._send([x], b)
            return self.standin(x)
        if a != b and self.process == b:
            host = self._recv([x], a)[0]
            return torch.empty_like(x, device=self.lead).copy_(
                host, non_blocking=True)
        return x.to(self.lead)

    def land_tree(self, s: int, tree: Tree) -> Tree:
        """Shard ``s``'s tree on the lead device, crossing as
        :func:`_packed` buffers, counted (shard 0's passes as it is)."""
        if not s:
            return tree
        xs = list(tree.values())
        bufs = {dt: self.land(s, b) for dt, b in _packed(xs).items()}
        return dict(zip(tree, _unpacked(bufs, xs)))

    def halo(self, src: int, dst: int, tree: Tree) -> Tree:
        """Shard ``src``'s tree copied straight to shard ``dst``'s device,
        not through the lead, as :func:`_packed` buffers, counted in
        ``shard_to_shard``."""
        self.traffic["shard_to_shard"] += _nbytes(tree)
        return self._move(src, dst, tree)

    def rows_on_lead(self, rows: List[Tree]) -> Optional[Tree]:
        """Each shard's row tree (on its device) as one ``[C, ...]`` tree
        on the lead device, in client order, uncounted in the shard
        tallies; None in a process of a pod that does not hold the lead
        (its rows cross to the lead's process)."""
        rows = [r if self.owner(s) == self.owner(0) else self._move(s, 0, r)
                for s, r in enumerate(rows)]
        return cat_rows(rows, self.lead) if self.owns(0) else None


def _shards(body) -> Optional[Sharded]:
    """``body`` as a :class:`Sharded` of more than one shard, else None
    (one body: the clients run one after another, each landed at once)."""
    if isinstance(body, Sharded) and len(body.bodies) > 1:
        return body
    return None


def run_sharded(sh: Sharded, inputs: Sequence[tuple],
                after: Optional[Callable] = None) -> list:
    """``sh.bodies[s](*inputs[c])`` for every client ``c`` of every shard
    ``s``, all issued from the caller's thread. First every client's
    ``inputs`` (trees and tensors on the lead device; generators, made on
    the client's device, and None pass as they are) are copied to its
    shard's device, a tensor that several clients share once per device;
    then each shard's clients run one after another under its device, shard
    after shard, each shard followed by ``after(s, outputs of its
    clients)`` when given. A copy between two cards orders both cards'
    current streams, and nothing in a body waits on the card, so each card
    works through its shard while this thread issues the next; nothing is
    copied between cards once the first shard is issued. Returns the
    per-client outputs, on the shards' devices, in client order; the
    caller lands them on the lead device after every shard is issued (a
    copy between cards issued earlier would hold a shard back behind the
    lead's queue). An exception in a body or in ``after`` is raised as it
    is, its shard named in a note; the shards after it do not run. On a
    pod only this process's shards run (``after`` with them), and another
    process's clients' outputs are stand-ins shaped like this process's
    first shard's (every shard holds as many clients)."""
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
    owned = sh.owned_shards()
    mine_of: list = [None] * len(sh.bodies)
    for s in owned:
        body, dev = sh.bodies[s], sh.devices[s]
        with _on(dev):
            try:
                mine = [body(*args) for args in staged[s * per:(s + 1) * per]]
                if after is not None:
                    after(s, mine)
            except Exception as err:
                err.add_note(f"in client shard {s} on {dev}")
                raise
        mine_of[s] = mine
    return [out for mine in mine_of for out in (
        sh.standin(mine_of[owned[0]]) if mine is None else mine)]


@dataclasses.dataclass(eq=False)
class Sender:
    """The sender's side of one wire exchange on a clients mesh of more
    than one shard: :func:`train_clients` and :func:`local_updates` run
    :func:`compress_stage` on each shard's device right after its clients
    are issued, over the shard's stacked post-train rows, its rows of the
    reference (the global, or the stacked round-start tree), of ``rmask``
    and of the round's ``uniforms`` draw (:func:`cc.row_uniforms`), and
    its ``resid`` rows. The round leaves ``payload``, every client's rows
    on the lead device in client order (each row's codes are the
    one-stack encode's: K5 and K4 treat rows apart), ``resid``, each
    shard's new residual rows on its own device, and each shard's own
    payload rows, still on its device (:meth:`own`). Launches: K4 once
    and K5 once per distinct leaf width, per shard."""

    comp: cc.CompressionConfig
    #: per shard: its ``[per, ...]`` float32 residual rows, on its device
    resid: List[Tree]
    uniforms: Optional[cc.Uniforms] = None
    payload: Optional[dict] = None
    #: per shard: what :meth:`pack` made of its payload, on its device
    parts: Optional[list] = None

    @staticmethod
    def _flat(payload: dict) -> List[torch.Tensor]:
        return [x for parts in payload.values() for x in parts.values()]

    def pack(self, s: int, payload: dict):
        """Shard ``s``'s payload as it crosses to the lead: shard 0's as it
        is, another's as :func:`_packed` buffers on its own device."""
        return _packed(self._flat(payload)) if s else payload

    def gather(self, sh: Sharded, parts: list) -> None:
        """The shards' payload rows (shard 0's payload, the others'
        :meth:`pack` buffers) concatenated on the lead device in client
        order, shaped like shard 0's."""
        like = self._flat(parts[0])
        rows = [like] + [
            _unpacked({dt: sh.land(s, b) for dt, b in bufs.items()}, like)
            for s, bufs in enumerate(parts) if s]
        flat = iter([torch.cat(xs) for xs in zip(*rows)])
        self.payload = {p: {k: next(flat) for k in part}
                        for p, part in parts[0].items()}
        self.parts = parts

    def own(self, s: int) -> dict:
        """Shard ``s``'s payload rows as it encoded them, on its own
        device: the rows of :attr:`payload` it sent, the same bits."""
        if not s:
            return self.parts[0]
        flat = iter(_unpacked(self.parts[s], self._flat(self.parts[0])))
        return {p: {k: next(flat) for k in part}
                for p, part in self.parts[0].items()}


def cat_rows(rows: List[Tree], device) -> Tree:
    """Per-shard row trees as one ``[C, ...]`` tree on ``device``, in
    client order (the one shard's tree itself)."""
    if len(rows) == 1:
        return {p: x.to(device) for p, x in rows[0].items()}
    return {p: torch.cat([r[p].to(device) for r in rows])
            for p in rows[0]}


def split_rows(tree: Tree, rows: List[tuple]) -> List[Tree]:
    """A ``[C, ...]`` tree as each shard's float32 rows on its device
    (``rows``: :meth:`Sharded.rows`)."""
    return [{p: x[a:b].to(d, torch.float32) for p, x in tree.items()}
            for a, b, d in rows]


@dataclasses.dataclass(eq=False)
class Stacked:
    """The stacked ``[C, ...]`` per-client tree on a clients mesh of more
    than one shard, kept where JAX's ``P('clients')`` keeps it: ``rows[s]``
    is shard ``s``'s ``[per, ...]`` rows (clients ``[s * per, (s + 1) *
    per)``), on its device. Every round body that takes a stack takes this
    form as well as a plain ``[C, ...]`` tree; what one reduction over
    the client axis reads lands through :meth:`gather`."""

    sh: Sharded
    rows: List[Tree]

    @classmethod
    def split(cls, sh: Sharded, tree: Tree) -> "Stacked":
        """A ``[C, ...]`` tree on the lead device (a restored checkpoint's)
        as each shard's rows on its device, in its dtypes; shard 0's rows
        are copies, so the whole tree need not stay alive."""
        rows = []
        for s, (a, b, _) in enumerate(sh.rows()):
            part = {p: x[a:b] for p, x in tree.items()}
            rows.append({p: x.clone() for p, x in part.items()} if not s
                        else sh.stage(s, part))
        return cls(sh, rows)

    @classmethod
    def broadcast(cls, sh: Sharded, global_t: Tree) -> "Stacked":
        """:func:`broadcast` on the shards: the global staged once per
        shard, then expanded to the shard's rows there."""
        packed, rows = {}, []
        for s, dev in enumerate(sh.devices):
            g = sh.stage(s, global_t, packed)
            with _on(dev):
                rows.append(broadcast(g, sh.per_device))
        return cls(sh, rows)

    @property
    def num_clients(self) -> int:
        return self.sh.per_device * len(self.rows)

    def gather(self) -> Tree:
        """The ``[C, ...]`` tree on the lead device in client order, each
        shard's rows landed as :func:`_packed` buffers (counted). Each leaf
        is laid out in memory as shard 0's rows are, which is how the one
        stack of a one-shard run is: a sum over the client axis adds in an
        order that follows the layout."""
        out = {p: _rows_like(x, self.num_clients)
               for p, x in self.rows[0].items()}
        per = self.sh.per_device
        for s, r in enumerate(self.rows):
            for p, x in self.sh.land_tree(s, r).items():
                out[p][s * per:(s + 1) * per].copy_(x)
        return out

    def row(self, c: int) -> Tree:
        """Client ``c``'s row, on its shard's device."""
        s, i = divmod(c, self.sh.per_device)
        return {p: x[i] for p, x in self.rows[s].items()}

    def like(self) -> Tree:
        """``[C, ...]`` views of one row (no copy): the shapes and dtypes
        of the whole stack, for a decode or a structure digest."""
        return stacked_like({p: x[0] for p, x in self.rows[0].items()},
                            self.num_clients)


def _rows_like(x: torch.Tensor, n: int) -> torch.Tensor:
    """An empty ``[n, ...]`` tensor like the rows ``x``: the client axis
    outermost, the other dims in ``x``'s memory order."""
    inner = sorted(range(1, x.dim()), key=lambda d: -x.stride(d))
    out = torch.empty((n,) + tuple(x.shape[d] for d in inner),
                      dtype=x.dtype, device=x.device)
    return out.permute([0] + [1 + inner.index(d) for d in range(1, x.dim())])


def gathered(stacked):
    """A stack as a ``[C, ...]`` tree on the lead device: a
    :class:`Stacked`'s rows landed in client order, a plain tree (or None)
    as it is."""
    return stacked.gather() if isinstance(stacked, Stacked) else stacked


def shardwise(fn: Callable, *args) -> Stacked:
    """``fn`` on every shard of the first :class:`Stacked` of ``args``,
    issued under the shard's device, the results a new :class:`Stacked`.
    Shard ``s`` gets each :class:`Stacked` argument's rows, a tree on the
    lead device staged once per shard, a ``[C, ...]`` tensor on the lead
    device its rows ``[a:b]`` staged, and anything else as it is. A
    failure is raised with its shard named; nothing is regathered. On a
    pod ``fn`` runs on this process's shards, and another process's
    result is a stand-in of this process's first one (its arguments still
    cross)."""
    sh = next(a.sh for a in args if isinstance(a, Stacked))
    packed, out = {}, []
    for s, (a, b, dev) in enumerate(sh.rows()):
        def arg(x):
            if isinstance(x, Stacked):
                return x.rows[s]
            if isinstance(x, dict):
                return sh.stage(s, x, packed)
            if isinstance(x, torch.Tensor):
                return sh.stage(s, x[a:b])
            return x

        staged = [arg(x) for x in args]
        if not sh.owns(s):
            out.append(None)
            continue
        with _on(dev):
            try:
                out.append(fn(*staged))
            except Exception as err:
                err.add_note(f"in client shard {s} on {dev}")
                raise
    first = out[sh.owned_shards()[0]]
    return Stacked(sh, [sh.standin(first) if r is None else r for r in out])


def client_stack(local_train: Callable, global_t: Tree,
                 num_clients: int):
    """The stacked per-client state every client starts from ``global_t``
    with (:func:`broadcast`): on a mesh of more than one shard each
    shard's rows on its device (:meth:`Stacked.broadcast`)."""
    sh = _shards(local_train)
    if sh is None:
        return broadcast(global_t, num_clients)
    return Stacked.broadcast(sh, global_t)


def restack(local_train: Callable, tree: Tree):
    """A ``[C, ...]`` tree on the lead device (a restored checkpoint's) in
    the form the run keeps its stack in: on a mesh of more than one shard
    split onto the shards (:meth:`Stacked.split`), else as it is."""
    sh = _shards(local_train)
    return tree if sh is None else Stacked.split(sh, tree)


def keep_rows(out, start, keep: torch.Tensor):
    """``start``'s rows where ``keep`` is set, ``out``'s elsewhere (on a
    :class:`Stacked`, each shard's rows where they are)."""
    if isinstance(out, Stacked):
        return shardwise(keep_rows, out, start, keep)
    return {p: torch.where(_col(keep, x) > 0, start[p], x)
            for p, x in out.items()}


def _difference(sent, base) -> Tree:
    return {p: sent[p] - base[p] for p in sent}


def arrived_deltas(comp: Optional[cc.CompressionConfig], sent, base,
                   stacked) -> Tree:
    """The async merge's ``[C, ...]`` deltas on the lead device: without a
    codec each client's ``sent - base`` (a :class:`Stacked`'s taken on
    its shards, then landed), with one the arrived payload decoded into
    the stack's shapes."""
    if comp is None:
        if isinstance(sent, Stacked):
            return shardwise(_difference, sent, base).gather()
        return _difference(sent, base)
    return decode_delta(comp, sent, stacked.like()
                        if isinstance(stacked, Stacked) else stacked)


def landed(new_t, sent, transported: Callable):
    """``(new_t, sent)`` on the lead device, as the ledger's fingerprint
    reads them. Its fold gives other bits on fewer rows, so a
    :class:`Stacked` lands, and what arrived is ``transported`` (the
    transport, elementwise: the shards' bits) redone on the landed rows;
    a plain pair passes as it is."""
    if not isinstance(new_t, Stacked):
        return new_t, sent
    seen = new_t.gather()
    return seen, transported(seen)


@dataclasses.dataclass(eq=False)
class Deferred:
    """A consensus view of a :class:`Stacked` not collapsed yet: the
    aggregation rule over ``stack`` (a round's stacked state) with
    ``weights``, not all zero (the host knew), and ``like``, the last
    collapsed view, as the fallback: the rules read a fallback's values
    beside positive weights only under RBLA, which runs in server mode,
    where every view is collapsed before the next round, so ``like`` is
    the eager run's fallback there; else it gives the result the eager
    chain's memory layout. :func:`settle` lands the stack and collapses
    it when something reads the view."""

    stack: Stacked
    weights: torch.Tensor
    like: Tree


def settle(view, agg: Optional[Callable] = None) -> Tree:
    """A consensus view as a tree: a :class:`Deferred` collapsed now over
    its landed stack, any other tree as it is."""
    if not isinstance(view, Deferred):
        return view
    return collapse(view.stack, view.weights, view.like, agg)


def _last_collapsed(view) -> Tree:
    return view.like if isinstance(view, Deferred) else view


def consensus(stacked, weights, w: torch.Tensor, prev,
              agg: Optional[Callable] = None):
    """The consensus view ``collapse(stacked, w, prev)`` of a round's
    stacked state, ``weights`` being ``w`` on the host. A plain stack
    collapses now. A :class:`Stacked` is not landed for it now: with
    every weight 0 the rule returns its fallback's bits, so the view is
    ``prev``'s; else a :class:`Deferred`, collapsed when read."""
    if not isinstance(stacked, Stacked):
        return collapse(stacked, w, settle(prev, agg), agg)
    if not (np.asarray(weights) > 0).any():
        return settle(prev, agg)
    return Deferred(stacked, w, _last_collapsed(prev))


def chunk_consensus(carry, ones: torch.Tensor, prev, observed: bool,
                    agg: Optional[Callable] = None):
    """The consensus view at a fused gossip chunk's end (every weight 1):
    collapsed when the end is observed; else a plain stack's is not
    computed (nothing reads it, ``prev`` stands) and a :class:`Stacked`'s
    is deferred (an older view would keep its stack alive through the
    chunk)."""
    if observed:
        return collapse(carry, ones, settle(prev, agg), agg)
    if isinstance(carry, Stacked):
        return Deferred(carry, ones, _last_collapsed(prev))
    return prev


def stacked_like(tree: Tree, num_clients: int) -> Tree:
    """``[C, ...]`` views of an unstacked tree (no copy): the shapes and
    dtypes a receiver decodes a payload into when no stack landed."""
    return {p: x.unsqueeze(0).expand((num_clients,) + tuple(x.shape))
            for p, x in tree.items()}


def _train_each(local_train: Callable, start_of: Callable, ref_of: Callable,
                batches: Tree, generators: List[Optional[torch.Generator]],
                like: Tree, rmask: Optional[torch.Tensor] = None,
                sender: Optional[Sender] = None, state: bool = True,
                keep: bool = False):
    """Every client trains from ``start_of(ref, i)``, ``ref`` being
    ``ref_of(a, b)`` (the reference of clients ``[a, b)``) and ``i`` the
    client's row in it. On a mesh of more than one shard each shard's
    reference and ``rmask`` rows are copied to its device once, before any
    shard is issued, and its clients start from them; with ``keep`` the
    references are a :class:`Stacked`'s rows, on their shards already, and
    the post-train rows stay there too (a :class:`Stacked` is returned)."""
    C = batches["ids"].shape[0]

    def stacked():
        return {p: torch.empty((C,) + tuple(x.shape), dtype=x.dtype,
                               device=x.device) for p, x in like.items()}

    def start(ref, masks, i):
        if masks is None:
            return start_of(ref, i)
        # heterogeneous ranks: a client never sees the fleet's higher-rank
        # components
        return lora.clip_adapters(start_of(ref, i), masks[i])

    sh = _shards(local_train)
    if sh is None:
        if sender is not None:
            raise ValueError("a Sender runs on a clients mesh of more than "
                             "one shard")
        ref, new_t, stats = ref_of(0, C), stacked(), []
        for c in range(C):
            t, s = local_train(start(ref, rmask, c),
                               {k: v[c] for k, v in batches.items()},
                               generators[c])
            for p, x in t.items():
                new_t[p][c] = x
            stats.append(s)
        return new_t, torch.stack(stats)
    rows = sh.rows()
    if keep:
        refs = [ref_of(a, b) for a, b, _ in rows]
    else:
        # the global is packed once for every shard; the cache is keyed by
        # id, so every shard's tree stays alive until all are staged
        trees, packed = [ref_of(a, b) for a, b, _ in rows], {}
        refs = [sh.stage(s, t, packed) for s, t in enumerate(trees)]
    masks = [None if rmask is None else sh.stage(s, rmask[a:b])
             for s, (a, b, _) in enumerate(rows)]
    per = sh.per_device
    inputs = [(start(refs[c // per], masks[c // per], c % per),
               sh.stage(c // per, {k: v[c] for k, v in batches.items()},
                        replicated=True),
               generators[c]) for c in range(C)]
    stacks, parts, payloads = [None] * len(rows), [None] * len(rows), {}

    def after(s, mine):
        a, b, _ = rows[s]
        stacks[s] = {p: torch.stack([t[p] for t, _ in mine]) for p in like}
        if sender is not None:
            payloads[s], _, sender.resid[s] = compress_stage(
                sender.comp, stacks[s], refs[s], sender.resid[s],
                cc.row_uniforms(sender.uniforms, C, a, b), masks[s])
            parts[s] = sender.pack(s, payloads[s])

    outs = run_sharded(sh, inputs,
                       after if sender is not None or keep else None)
    first = sh.owned_shards()[0]
    for s in range(len(rows)):
        # another process's shard of a pod: stand-ins of its rows
        if stacks[s] is None and stacks[first] is not None:
            stacks[s] = sh.standin(stacks[first])
            if sender is not None:
                parts[s] = sender.pack(s, sh.standin(payloads[first]))
    stats = torch.stack([sh.land(c // per, s)
                         for c, (_, s) in enumerate(outs)])
    if keep:
        if sender is not None:
            sender.gather(sh, parts)
        return Stacked(sh, stacks), stats
    if sender is None:
        new_t = stacked()
        for c, (t, _) in enumerate(outs):
            for p, x in t.items():
                new_t[p][c].copy_(sh.land(c // per, x))
        return new_t, stats
    sender.gather(sh, parts)
    if not state:
        return None, stats
    new_t = stacked()
    for s, (a, b, _) in enumerate(rows):
        for p, x in stacks[s].items():
            new_t[p][a:b].copy_(sh.land(s, x))
    return new_t, stats


def eval_clients(eval_one: Callable, stacked, global_t: Tree,
                 batches: Tree) -> torch.Tensor:
    """Each client's ``[loss*n, correct, n]`` of its row of ``stacked``
    (of ``global_t`` when ``stacked`` is None) on its own ``batches[c]``,
    ``[C, 3]`` on the lead device; the clients of a :class:`Sharded`
    ``eval_one`` on their shards' devices. A :class:`Stacked`'s rows are
    on their shards already and nothing of them is staged."""
    C = batches["ids"].shape[0]
    kept = isinstance(stacked, Stacked)
    if kept:
        tree_of = stacked.row
    elif stacked is None:
        def tree_of(c):
            return global_t
    else:
        def tree_of(c):
            return {p: x[c] for p, x in stacked.items()}
    rows = [(tree_of(c), {k: v[c] for k, v in batches.items()})
            for c in range(C)]
    sh = _shards(eval_one)
    if sh is None:
        return torch.stack([eval_one(*r) for r in rows])
    per, staged, packed = sh.per_device, {}, {}

    def stage(c, tree):  # a tree several clients share, once a shard
        if kept:
            return tree
        key = (id(tree), c // per)  # every tree stays alive in ``rows``
        if key not in staged:
            staged[key] = sh.stage(c // per, tree, packed)
        return staged[key]

    inputs = [(stage(c, t), sh.stage(c // per, b, replicated=True))
              for c, (t, b) in enumerate(rows)]
    return torch.stack([sh.land(c // per, s)
                        for c, s in enumerate(run_sharded(sh, inputs))])


def train_clients(local_train: Callable, global_t: Tree, batches: Tree,
                  generators: List[Optional[torch.Generator]],
                  rmask: Optional[torch.Tensor] = None,
                  sender: Optional[Sender] = None):
    """Every client trains from ``global_t`` (clipped to its rank by
    ``rmask``) on its own ``batches[c]``:
    ``-> (stacked [C, ...] trees, stats [C, 3])``. With a ``sender`` each
    shard encodes its deltas against ``global_t`` on its own device, and
    no post-train tree lands (None in their place): the round keeps no
    per-client state."""
    return _train_each(local_train, lambda ref, i: ref,
                       lambda a, b: global_t, batches, generators, global_t,
                       rmask, sender, state=False)


def local_updates(local_train: Callable, client_t, batches: Tree,
                  generators: List[Optional[torch.Generator]],
                  rmask: Optional[torch.Tensor] = None,
                  sender: Optional[Sender] = None):
    """Every client trains from its OWN row of the stacked ``client_t``
    (``local_updates_body``): ``-> (stacked [C, ...] trees, stats [C, 3])``.
    With a ``sender`` each shard encodes its deltas against its rows of
    ``client_t`` on its own device. A :class:`Stacked` ``client_t`` trains
    each shard from its own rows where they are, and the post-train rows
    stay there (a :class:`Stacked`); a plain tree's rows are staged to the
    shards and the post-train trees land."""
    if isinstance(client_t, Stacked):
        per = client_t.sh.per_device
        return _train_each(
            local_train, lambda ref, i: {p: x[i] for p, x in ref.items()},
            lambda a, b: client_t.rows[a // per],
            batches, generators,
            {p: x[0] for p, x in client_t.rows[0].items()}, rmask, sender,
            keep=True)
    like = {p: x[0] for p, x in client_t.items()}
    return _train_each(local_train,
                       lambda ref, i: {p: x[i] for p, x in ref.items()},
                       lambda a, b: {p: x[a:b] for p, x in client_t.items()},
                       batches, generators, like, rmask, sender)


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


def adopt(client_t, global_t: Tree, pull: torch.Tensor):
    """Pull-masked clients adopt ``global_t``, everyone else keeps their
    stacked row (``_adopt_pull``); on a :class:`Stacked`, each shard's
    rows where they are, the global staged once per shard."""
    if isinstance(client_t, Stacked):
        return shardwise(adopt, client_t, global_t, pull)
    return {p: torch.where(_col(pull, x) > 0,
                           global_t[p].to(x.dtype).expand_as(x), x)
            for p, x in client_t.items()}


def collapse(stacked, weights: torch.Tensor, fallback: Tree,
             agg: Optional[Callable] = None,
             sh: Optional[Sharded] = None) -> Tree:
    """The aggregation rule over the client axis (``collapse``): ``agg``
    (:func:`bcfl_tpu_torch.parallel.make_aggregator`), the masked weighted
    mean by default, over the stack landed on the lead device in client
    order (:func:`gathered`): one reduction, as on one shard. On a pod
    the lead's process reduces (:meth:`Sharded.on_lead` of ``sh``, or of
    the :class:`Stacked`'s own)."""
    landed = gathered(stacked)
    reduce = functools.partial(agg or masked_weighted_mean, landed, weights,
                               fallback)
    sh = stacked.sh if isinstance(stacked, Stacked) else sh
    if sh is None:
        return reduce()
    return sh.on_lead(reduce, {p: x[0] for p, x in landed.items()})


def exact_mean_spread(avg: Tree, new_t, mask: torch.Tensor):
    """Serverless exact-mean aggregation: every unmasked client adopts the
    (mask-weighted) average, masked clients keep their own state
    (``_exact_mean_spread``)."""
    if isinstance(new_t, Stacked):
        return shardwise(exact_mean_spread, avg, new_t, mask)
    return {p: torch.where(_col(mask, x) > 0, avg[p].expand_as(x), x)
            for p, x in new_t.items()}


def _spread_rows(self_t: Stacked, recv_t, mask: torch.Tensor, fallback,
                 agg: Optional[Callable]) -> Stacked:
    """``steps == 0`` on the shards: ``recv_t`` lands for the one
    reduction, and the aggregate goes back once per shard for the spread.
    The serverless rules read their fallback (the round-start stack) only
    when every weight is 0, where the spread keeps every client's own
    rows; but it sets the aggregate's memory layout, and so the spread's,
    and a later sum over the client axis adds in an order that follows
    the layout. The stack's first row, on the lead device, stands in for
    it: the same layout. (RBLA, which reads its fallback beside positive
    weights, runs in server mode only.)"""
    if isinstance(fallback, Stacked):
        fallback = {p: x[:1] for p, x in fallback.rows[0].items()}
    return exact_mean_spread(collapse(recv_t, mask, fallback, agg), self_t,
                             mask)


def gossip_mix_rows(self_t: Stacked, recv_t: Stacked, mask: torch.Tensor,
                    alpha: float, steps: int = 1) -> Stacked:
    """:func:`~bcfl_tpu_torch.parallel.gossip_mix_recv` on the shards.
    Each step every shard gets its two ring neighbours' rows of the
    received (later: the mixed) stack, row ``a - 1`` and row ``b`` (mod
    C) for its clients ``[a, b)``, copied straight from the shards that
    hold them (:meth:`Sharded.halo`, all of a step's before any shard
    mixes), then mixes its own rows, its masks its rows of the rolled
    masks. The rule is elementwise over a row and its two neighbours, so
    the bits are the one-stack mix's."""
    sh, C = self_t.sh, self_t.num_clients
    per, rows = sh.per_device, sh.rows()
    # [C, 3]: each client's own, left and right neighbour's mask
    masks = torch.stack([mask, torch.roll(mask, 1, dims=0),
                         torch.roll(mask, -1, dims=0)], dim=1)
    ms = [sh.stage(s, masks[a:b]) for s, (a, b, _) in enumerate(rows)]

    def neighbour(c: int, s: int) -> Tree:
        src, i = divmod(c % C, per)
        return sh.halo(src, s, {p: x[i:i + 1]
                                for p, x in recv_t.rows[src].items()})

    for _ in range(steps):
        halos = [(neighbour(a - 1, s), neighbour(b, s))
                 for s, (a, b, _) in enumerate(rows)]
        out = []
        for s, (_, _, dev) in enumerate(rows):
            if not sh.owns(s):
                # another process's shard of a pod: it mixes there
                out.append(sh.standin(self_t.rows[s]))
                continue
            (left, right), m, recv = halos[s], ms[s], recv_t.rows[s]
            with _on(dev):
                try:
                    # leaf by leaf, so only one leaf's neighbour rows are
                    # alive
                    out.append({p: gossip_step_mix(
                        x, torch.cat([left[p], recv[p][:-1]]),
                        torch.cat([recv[p][1:], right[p]]),
                        _col(m[:, 1], x), _col(m[:, 2], x),
                        _col(m[:, 0], x), alpha)
                        for p, x in self_t.rows[s].items()})
                except Exception as err:
                    err.add_note(f"in client shard {s} on {dev}")
                    raise
        del halos
        self_t = recv_t = Stacked(sh, out)
    return self_t


def mix(new_t, mask: torch.Tensor, fallback, alpha: float,
        steps: int, agg: Optional[Callable] = None):
    """The serverless mix (``_mix_g``): ``steps == 0`` spreads the exact
    masked aggregate (``agg``), otherwise ``steps`` rounds of ring gossip,
    which keeps its pairwise mixing rule whatever the aggregator. A
    :class:`Stacked` mixes on its shards."""
    if isinstance(new_t, Stacked):
        return mix_recv(new_t, new_t, mask, fallback, alpha, steps, agg)
    if steps == 0:
        return exact_mean_spread(collapse(new_t, mask, fallback, agg), new_t,
                                 mask)
    return gossip_mix(new_t, mask, alpha, steps=steps)


def mix_recv(self_t, recv_t, mask: torch.Tensor, fallback,
             alpha: float, steps: int, agg: Optional[Callable] = None):
    """The transport-aware mix (``_mix_g_recv``): neighbour and aggregate
    terms from ``recv_t`` (what arrived), each sender's self-term (and a
    masked client's kept state) from its own ``self_t``. A
    :class:`Stacked` mixes on its shards (:func:`gossip_mix_rows`; at
    ``steps == 0`` the received rows land for the one reduction)."""
    if isinstance(self_t, Stacked):
        if steps == 0:
            return _spread_rows(self_t, recv_t, mask, fallback, agg)
        return gossip_mix_rows(self_t, recv_t, mask, alpha, steps=steps)
    if steps == 0:
        return exact_mean_spread(collapse(recv_t, mask, fallback, agg),
                                 self_t, mask)
    return gossip_mix_recv(self_t, recv_t, mask, alpha, steps=steps)


def decode_rows(comp: cc.CompressionConfig, sender: Sender, sent: dict,
                ref_t: Stacked, like_t: Stacked) -> Stacked:
    """The reconstruction ``ref + decoded`` on the shards: each shard
    decodes its rows of what arrived against its own round-start rows.
    On a clean wire (``sent`` is the landed payload) those are the rows
    it encoded (:meth:`Sender.own`); a transported payload's rows go back
    to their shards as :func:`_packed` buffers."""
    sh = ref_t.sh
    if sent is sender.payload:
        mine = [sender.own(s) for s in range(len(sh.devices))]
    else:
        flat = [(p, k, x) for p, parts in sent.items()
                for k, x in parts.items()]
        mine = []
        for s, (a, b, _) in enumerate(sh.rows()):
            rows = iter(sh.stage(s, {i: x[a:b] for i, (_, _, x)
                                     in enumerate(flat)}).values())
            part: dict = {}
            for p, k, _ in flat:
                part.setdefault(p, {})[k] = next(rows)
            mine.append(part)
    return shardwise(functools.partial(decode_recon, comp),
                     Stacked(sh, mine), ref_t, like_t)


def decode_arrived(comp: cc.CompressionConfig, sender: Optional[Sender],
                   sent: dict, ref_t, like_t, num_clients: int):
    """The reconstruction ``ref + decoded`` of the payload that arrived:
    on the shards for a :class:`Stacked` ``ref_t`` (:func:`decode_rows`),
    else on the lead device into ``like_t``'s shapes (``ref_t`` stacked
    when no tree landed)."""
    if isinstance(ref_t, Stacked):
        return decode_rows(comp, sender, sent, ref_t, like_t)
    like = (like_t if like_t is not None
            else stacked_like(ref_t, num_clients))
    return decode_recon(comp, sent, ref_t, like)


# ------------------------------------------------------------ round bodies


@dataclasses.dataclass
class RoundOut:
    global_t: Tree  # the new global tree (serverless: the mixed stack)
    stats: torch.Tensor  # [C, 3] per-client [loss*n, correct, n]
    resid: Optional[Tree] = None  # error-feedback state (codec on)
    payload: Optional[dict] = None  # what crossed the wire (codec on)


def _round_sender(local_train: Callable,
                  comp: Optional[cc.CompressionConfig], resid: Optional[Tree],
                  uniforms: Optional[cc.Uniforms]) -> Optional[Sender]:
    """The shards' :class:`Sender` for a ``[C, ...]`` ``resid``, or None
    (no codec, or one shard: the codec runs on the landed stack)."""
    sh = _shards(local_train)
    if sh is None or comp is None or not comp.enabled:
        return None
    return Sender(comp, split_rows(resid, sh.rows()), uniforms)


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
    the same steps split around its ledger seam. On a clients mesh of more
    than one shard each shard encodes its own rows (:class:`Sender`) and
    the server decodes the payload; ``resid`` in and out is the whole
    ``[C, ...]`` tree on the lead device."""
    sender = _round_sender(local_train, comp, resid, uniforms)
    new_t, stats = train_clients(local_train, global_t, batches, generators,
                                 sender=sender)
    if comp is None or not comp.enabled:
        return RoundOut(masked_weighted_mean(new_t, weights, global_t), stats)
    if sender is None:
        payload, rec, resid = encode_deltas(comp, new_t, global_t, resid,
                                            uniforms)
        del new_t
    else:
        payload = sender.payload
        resid = cat_rows(sender.resid, next(iter(global_t.values())).device)
        rec = decode_recon(comp, payload, global_t,
                           stacked_like(global_t, len(stats)))
    avg = masked_weighted_mean(rec, weights, global_t)
    return RoundOut(avg, stats, resid, payload)


def gossip_round(local_train: Callable, comp: Optional[cc.CompressionConfig],
                 client_t, batches: Tree, mask: torch.Tensor,
                 generators: List[Optional[torch.Generator]],
                 resid: Optional[Tree] = None,
                 uniforms: Optional[cc.Uniforms] = None,
                 alpha: float = 0.5, steps: int = 1) -> RoundOut:
    """One serverless round (``gossip_body`` / ``gossip_body_comp``): every
    client trains from its own stacked row and the peers mix. With a codec,
    each peer ships its delta against its own round-start params; the
    neighbour terms come from the lossy reconstruction, each sender's
    self-term stays its honest post-train tree. ``global_t`` of the result
    is the mixed stack, in ``client_t``'s form (a :class:`Stacked` stays on
    its shards). ``FedEngine`` runs the same steps split around its ledger
    seam. On a clients mesh of more than one shard each shard encodes its
    own rows (:class:`Sender`), as in :func:`server_round`."""
    sender = _round_sender(local_train, comp, resid, uniforms)
    new_t, stats = local_updates(local_train, client_t, batches, generators,
                                 sender=sender)
    if comp is None or not comp.enabled:
        return RoundOut(mix(new_t, mask, client_t, alpha, steps), stats)
    if sender is None:
        payload, rec, resid = encode_deltas(comp, new_t, client_t, resid,
                                            uniforms)
    else:
        payload = sender.payload
        resid = cat_rows(sender.resid, _shards(local_train).lead)
        rec = (decode_rows(comp, sender, payload, client_t, new_t)
               if isinstance(new_t, Stacked)
               else decode_recon(comp, payload, client_t, new_t))
    mixed = mix_recv(new_t, rec, mask, client_t, alpha, steps)
    return RoundOut(mixed, stats, resid, payload)


# ------------------------------------------------- fused multi-round chunks


def transport(new_t, c_row: Optional[torch.Tensor]):
    """Simulated transport of a client-stacked update tree (``_transport``):
    what reaches the aggregation is ``new_t + c_row[c]`` per client, in
    each leaf's dtype (a :class:`Stacked` on its shards). ``c_row`` None
    is a clean round: the same buffer, not an identity add (``-0.0 +
    0.0`` is ``+0.0``)."""
    if c_row is None:
        return new_t
    if isinstance(new_t, Stacked):
        return shardwise(transport, new_t, c_row)
    return {p: x + _col(c_row, x) for p, x in new_t.items()}


def _auth(fp_commit: torch.Tensor, fp_recv: torch.Tensor) -> torch.Tensor:
    """``[C]`` 1.0 where every fingerprint lane arrived with the committed
    bits, else 0.0: the comparison the host's chain makes on the digests
    of these rows (JAX compares floats, which differs only on NaN and
    signed zero lanes)."""
    same = fp_recv.view(torch.int32) == fp_commit.view(torch.int32)
    return same.all(dim=-1).to(torch.float32)


def _fp_auth(tree: Tree, sent: Tree):
    fp_commit = fp_lib.client_fingerprint(tree)
    # the committed buffer IS the one that arrived on a clean round
    fp_recv = (fp_commit if sent is tree
               else fp_lib.client_fingerprint(sent))
    return sent, fp_commit, fp_recv, _auth(fp_commit, fp_recv)


def fp_auth(new_t, c_row: Optional[torch.Tensor]):
    """``(sent, fp_commit, fp_recv, auth)`` (``_fp_auth``): each client's
    update fingerprinted before and after :func:`transport`, compared on
    the device; ``auth`` ``[C]`` gates the round's aggregation. A
    :class:`Stacked` is fingerprinted landed (:func:`landed`)."""
    sent = transport(new_t, c_row)
    _, *fps = _fp_auth(*landed(new_t, sent,
                               lambda t: transport(t, c_row)))
    return (sent, *fps)


def fp_auth_payload(payload: dict, c_row: Optional[torch.Tensor]):
    """The codec's twin of :func:`fp_auth` (``_fp_auth_payload``): the
    fingerprints are of the PAYLOAD, the bytes on the wire, and transport
    corrupts its float parts (:func:`cc.corrupt_payload`)."""
    sent = payload if c_row is None else cc.corrupt_payload(payload, c_row)
    return _fp_auth(payload, sent)


@dataclasses.dataclass
class RoundIn:
    """One round of a fused chunk, made by the caller when the chunk
    reaches it (a chunk never holds several rounds of batches):
    ``weights`` the server's ``[C]`` aggregation weights or the gossip
    mask, on the lead device; ``corrupt`` the round's ``[C]`` transport
    scales there (None: a clean round; read only with fingerprints)."""

    batches: Tree
    weights: torch.Tensor
    generators: List[Optional[torch.Generator]]
    uniforms: Optional[cc.Uniforms] = None
    corrupt: Optional[torch.Tensor] = None


@dataclasses.dataclass
class ChunkOut:
    """A fused chunk's result, all on the device: nothing was read back."""

    carry: Tree  # the global tree (server) or the stacked tree (gossip)
    # each shard's error-feedback rows: the caller's list, updated in place
    resid: Optional[List[Tree]]
    stats: torch.Tensor  # [k, C, 3] per-client [loss*n, correct, n]
    # with fingerprints: [k, C, K] before and after transport, [k, C] auth
    fp_commit: Optional[torch.Tensor] = None
    fp_recv: Optional[torch.Tensor] = None
    auth: Optional[torch.Tensor] = None


def _chunk_sender(local_train: Callable,
                  comp: Optional[cc.CompressionConfig],
                  resid: Optional[List[Tree]],
                  uniforms: Optional[cc.Uniforms]) -> Optional[Sender]:
    if comp is None or _shards(local_train) is None:
        return None
    return Sender(comp, list(resid), uniforms)


def _chunk_wire(local_train: Callable, comp: Optional[cc.CompressionConfig],
                new_t: Optional[Tree], ref_t: Tree, resid, rin: RoundIn,
                rmask, sender: Optional[Sender], with_fp: bool,
                check: Optional[Callable]):
    """One fused round's wire, the engine's per-round exchange in the
    same ops: ``(the tree the aggregation consumes, fps)``, ``fps``
    ``(fp_commit, fp_recv, auth)`` or None. Under a codec the shards'
    payload (or the one shard's encode) goes through ``check`` and the
    transport, a transported payload is decoded where it arrived, and the
    new residual rows replace ``resid``'s in place."""
    fps = None
    if comp is None:
        if with_fp:
            new_t, *fps = fp_auth(new_t, rin.corrupt)
        return new_t, fps
    if sender is None:
        rows = (local_train.rows() if isinstance(local_train, Sharded)
                else [(0, len(rin.generators), rin.weights.device)])
        payload, rec, r = encode_deltas(
            comp, new_t, ref_t, cat_rows(resid, rin.weights.device),
            rin.uniforms, rmask)
        # in place: no reference to the old rows outlives the round
        resid[:] = split_rows(r, rows)
    else:
        payload, rec = sender.payload, None
        resid[:] = sender.resid
    if check is not None:
        check(payload)
    sent = payload
    if with_fp:
        sent, *fps = fp_auth_payload(payload, rin.corrupt)
    if rec is None or sent is not payload:
        # a corrupted wire yields a corrupted reconstruction, which auth
        # has already excluded
        rec = decode_arrived(comp, sender, sent, ref_t, new_t,
                             len(rin.generators))
    return rec, fps


def _chunk_out(carry: Tree, resid, stats: list, fps: list) -> ChunkOut:
    out = ChunkOut(carry, resid, torch.stack(stats))
    if fps and fps[0] is not None:
        out.fp_commit, out.fp_recv, out.auth = (
            torch.stack(xs) for xs in zip(*fps))
    return out


def server_rounds(local_train: Callable,
                  comp: Optional[cc.CompressionConfig], global_t: Tree,
                  rounds, resid: Optional[List[Tree]] = None,
                  agg: Optional[Callable] = None,
                  rmask: Optional[torch.Tensor] = None,
                  with_fp: bool = False,
                  check: Optional[Callable] = None) -> ChunkOut:
    """The fused server program (``_make_server_rounds``): one FedAvg
    round per :class:`RoundIn` of ``rounds`` (any iterable, drawn one
    round at a time), every round's work issued before anything is read
    back. Each round: the clients train from the global, with a codec
    their deltas are encoded (on a mesh of several shards, on each
    shard's card; ``resid``, the list of each shard's rows there, is
    updated in place round by round), with ``with_fp``
    every update is fingerprinted before and after :func:`transport` and
    the aggregate's weights are gated by the device's ``auth``, and
    ``agg`` (default the masked weighted mean) aggregates what arrived.
    ``check`` sees every round's payload. The rounds are the engine's
    per-round rounds op for op, so the chunk's bits are theirs."""
    stats, fps = [], []
    for rin in rounds:
        sender = _chunk_sender(local_train, comp, resid, rin.uniforms)
        new_t, st = train_clients(local_train, global_t, rin.batches,
                                  rin.generators, rmask, sender)
        arrived, fp = _chunk_wire(local_train, comp, new_t, global_t, resid,
                                  rin, rmask, sender, with_fp, check)
        del new_t
        w = rin.weights if fp is None else rin.weights * fp[2]
        global_t = collapse(arrived, w, global_t, agg)
        del arrived
        stats.append(st)
        fps.append(fp)
    return _chunk_out(global_t, resid, stats, fps)


def gossip_rounds(local_train: Callable,
                  comp: Optional[cc.CompressionConfig], client_t: Tree,
                  rounds, resid: Optional[List[Tree]] = None,
                  agg: Optional[Callable] = None,
                  rmask: Optional[torch.Tensor] = None,
                  with_fp: bool = False, check: Optional[Callable] = None,
                  alpha: float = 0.5, steps: int = 1) -> ChunkOut:
    """The fused gossip program (``_make_gossip_rounds``): one serverless
    round per :class:`RoundIn`, ``weights`` its mask. Each client trains
    from its own row of the stacked tree, ships its update (the encoded
    delta against its round-start row under a codec) through the same wire
    as :func:`server_rounds`, and the peers mix what arrived, gated by
    ``auth`` (``mix_recv``; :func:`mix` when the wire is the identity,
    the same bits). Returns the stacked tree after the chunk as
    ``carry``."""
    stats, fps = [], []
    for rin in rounds:
        sender = _chunk_sender(local_train, comp, resid, rin.uniforms)
        new_t, st = local_updates(local_train, client_t, rin.batches,
                                  rin.generators, rmask, sender)
        arrived, fp = _chunk_wire(local_train, comp, new_t, client_t, resid,
                                  rin, rmask, sender, with_fp, check)
        m = rin.weights if fp is None else rin.weights * fp[2]
        if arrived is new_t:
            client_t = mix(new_t, m, client_t, alpha, steps, agg)
        else:
            client_t = mix_recv(new_t, arrived, m, client_t, alpha, steps,
                                agg)
        del new_t, arrived
        stats.append(st)
        fps.append(fp)
    return _chunk_out(client_t, resid, stats, fps)


def _replica(model: nn.Module, devices: Sequence[torch.device],
             share: bool) -> nn.Module:
    """A copy of ``model``, the same weights, for a client shard whose
    (inner) devices are ``devices``: its parameters and buffers on
    ``devices[0]``, and under ``tp`` its own split of every split layer
    over ``devices``, shard ``i`` copied from the lead's shard ``i``
    straight to ``devices[i]`` (:func:`tp_linear.moved`; the dense weight
    a ``meta`` placeholder). No device ever receives a whole split weight,
    nor a second copy of anything on the model's own card, which a 7B base
    would not fit. With ``share`` (the caller's promise that the
    parameters are never written, a frozen LoRA base, and that
    ``devices`` are the lead shard's own) the copy holds the lead's
    parameters, buffers and splits themselves: only the modules, their
    configs and their LoRA hooks are its own."""
    dev, memo = devices[0], {}
    for name, sh in tp_linear.split_layers(model).items():
        if share:
            memo[id(sh)] = sh
            continue
        memo[id(sh)] = tp_linear.moved(sh, devices)
        w = model.get_submodule(name).weight
        memo[id(w)] = nn.Parameter(torch.empty_like(w, device="meta"),
                                   requires_grad=w.requires_grad)
    for t in model.parameters():
        if id(t) not in memo:
            memo[id(t)] = t if share else nn.Parameter(
                t.detach().to(dev, copy=True), requires_grad=t.requires_grad)
    for t in model.buffers():
        memo[id(t)] = t if share else t.to(dev, copy=True)
    return copy.deepcopy(model, memo)


def _check_inner(model: nn.Module, mesh: ClientMesh, shard: int) -> None:
    """Refuse a client shard's model that does not carry the mesh's inner
    axis on the shard's own row: nothing runs ``tp > 1`` dense, ``sp > 1``
    without the ring, or on another shard's devices."""
    row = [tp_linear.indexed(d) for d in mesh.row_devices(shard)]
    if mesh.tp > 1:
        splits = tp_linear.split_layers(model).values()
        ways = {len(sh.weights) for sh in splits}
        if ways != {mesh.tp}:
            raise ValueError(
                f"a tp={mesh.tp} mesh needs the model's frozen base split "
                f"{mesh.tp} ways (tp_linear.shard_base), found "
                f"{sorted(ways) or 'no split layer'}")
        if any(sh.devices != row for sh in splits):
            raise ValueError(f"client shard {shard}'s frozen base is not "
                             f"split over its own row {row}")
    if mesh.sp > 1:
        if model.cfg.attention_override is None:
            raise ValueError(
                f"an sp={mesh.sp} mesh needs the model's attention on the "
                "ring (sp.ring_config)")
        ring = sp.ring_devices(model)
        if ring is not None and [tp_linear.indexed(d) for d in ring] != row:
            raise ValueError(f"client shard {shard}'s ring runs over "
                             f"{list(ring)}, not its own row {row}")


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
    # the fused chunks: (carry, rounds, resid=None, agg=None, rmask=None,
    # with_fp=False, check=None) -> ChunkOut
    server_rounds: Callable
    gossip_rounds: Callable


def build_programs(model: nn.Module, mesh: ClientMesh,
                   optimizer: str = "adamw", learning_rate: float = 5e-5,
                   max_grad_norm: float = 0.0, gossip_alpha: float = 0.5,
                   gossip_steps: int = 1, task: str = "classification",
                   compression: Optional[cc.CompressionConfig] = None,
                   adapters: bool = False) -> FedPrograms:
    """The :class:`FedPrograms` of ``model`` on ``mesh``. The ``impl``
    choice of the JAX ``build_programs`` (and its refusal of
    ``shard_map`` on a 2-D mesh) has no counterpart: the port has one
    implementation of every body. What it checks instead is that every
    client shard's model carries the mesh's inner axis on the shard's own
    row, so that nothing runs ``tp > 1`` dense, ``sp > 1`` without the
    ring, or one shard on another's devices.

    Client shard 0 trains and evaluates on ``model``, which must be on
    ``mesh.client_devices[0]`` (under ``tp`` split over
    ``mesh.row_devices(0)``, under ``sp`` on that row's ring); on a pod,
    this process's first shard does, and another process's shard gets a
    ``meta`` copy that never runs. Each other
    shard ``s`` (1-D or 2-D) does so on its own scratch copy of ``model``
    (:func:`_replica`, the same weights) on ``mesh.client_devices[s]``:
    under ``tp`` split over ``mesh.row_devices(s)``, under ``sp`` with
    its attention on its own row's ring (``sp.ride_ring``), as JAX's
    GSPMD program gives each row of the grid its own clients. Under LoRA a
    copy on exactly the lead shard's devices (``[cuda:0] * 4``, the CPU)
    shares the lead's frozen base, never written; on other devices it owns
    its slices."""
    devices = mesh.train_devices
    home = mesh.home_shard
    lead = [tp_linear.indexed(d) for d in mesh.row_devices(home)]
    models = []
    for s in range(len(devices)):
        if s == home:
            models.append(model)
            continue
        row = mesh.row_devices(s)
        rep = _replica(model, row, share=adapters and [
            tp_linear.indexed(d) for d in row] == lead)
        if mesh.sp > 1:
            sp.ride_ring(rep, sp.ring_override(mesh.mesh, sp.SEQ_AXIS, s))
        models.append(rep)
    for s, m in enumerate(models):
        _check_inner(m, mesh, s)
    trains, evals = [], []
    for m in models:
        loss_fn = make_loss_fn(m, task)
        trains.append(make_local_train(m, loss_fn, optimizer, learning_rate,
                                       max_grad_norm, adapters=adapters))
        evals.append(make_eval_one(m, loss_fn, adapters=adapters))
    per = mesh.num_clients // len(devices)
    traffic = _traffic()  # the round's and the evaluation's, together
    owners, me = mesh.shard_processes, process_index()
    local_train = Sharded(trains, devices, per, traffic, owners, me)
    comp = (compression if compression is not None and compression.enabled
            else None)
    return FedPrograms(
        mesh=mesh, local_train=local_train,
        eval_one=Sharded(evals, devices, per, traffic, owners, me),
        gossip_round=functools.partial(gossip_round, local_train, comp,
                                       alpha=gossip_alpha,
                                       steps=gossip_steps),
        server_rounds=functools.partial(server_rounds, local_train, comp),
        gossip_rounds=functools.partial(gossip_rounds, local_train, comp,
                                        alpha=gossip_alpha,
                                        steps=gossip_steps))
