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
shard's), in client order, plus the post-train rows where they are the
round's carried state (serverless, async, partitioned). Without a codec,
or on one shard, every post-train tree lands in row ``c`` of the stacked
``[C, ...]`` tree on the lead device. The receiver's side (transport,
ledger, decode, the FedAvg mean, the ring gossip, the async merge)
consumes the stack on the lead device, as the JAX stacked axis is
consumed, so the bits are the one-shard run's. An exception in any shard
is raised in the caller. Trees are ``{flax leaf path: tensor}`` dicts in
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
from bcfl_tpu_torch.parallel import sp, tp_linear
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


def _traffic() -> Dict[str, int]:
    return {"to_shards": 0, "to_lead": 0}


def _nbytes(x) -> int:
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
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

    ``traffic`` counts the bytes between the lead shard and the others
    since it was made, as the round bodies move them (:meth:`stage`,
    :meth:`land`): ``to_shards`` what the lead copies to shards 1 and up,
    ``to_lead`` what lands from them on the lead. It counts shards, not
    cards: on ``[cuda:0] * 4`` no byte crosses a card, and the count is
    what would."""

    bodies: List[Callable]
    devices: List[torch.device]
    per_device: int
    traffic: Dict[str, int] = dataclasses.field(default_factory=_traffic)

    def __call__(self, *args, **kwargs):
        return self.bodies[0](*args, **kwargs)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    def rows(self) -> List[tuple]:
        """``(first client, end, device)`` of every shard."""
        per = self.per_device
        return [(s * per, (s + 1) * per, d)
                for s, d in enumerate(self.devices)]

    def stage(self, s: int, x, packed: Optional[dict] = None):
        """A tensor or tree on the lead device copied to shard ``s``'s
        device, counted (shard 0's passes as it is). A tree crosses as
        :func:`_packed` buffers, packed once for every shard it goes to
        when the caller passes a ``packed`` cache (keyed by the tree's id:
        the caller keeps the tree alive)."""
        if not s:
            return x
        self.traffic["to_shards"] += _nbytes(x)
        dev = self.devices[s]
        if not isinstance(x, dict):
            return x.to(dev, non_blocking=True)
        packed = {} if packed is None else packed
        if id(x) not in packed:
            packed[id(x)] = _packed(list(x.values()))
        bufs = {dt: b.to(dev, non_blocking=True)
                for dt, b in packed[id(x)].items()}
        return dict(zip(x, _unpacked(bufs, list(x.values()))))

    def land(self, s: int, x: torch.Tensor) -> torch.Tensor:
        """Shard ``s``'s output ``x`` on the lead device, counted."""
        if s:
            self.traffic["to_lead"] += _nbytes(x)
        return x.to(self.lead)


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
    is, its shard named in a note; the shards after it do not run."""
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
            try:
                mine = [body(*args) for args in staged[s * per:(s + 1) * per]]
                if after is not None:
                    after(s, mine)
            except Exception as err:
                err.add_note(f"in client shard {s} on {dev}")
                raise
        outs += mine
    return outs


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
    one-stack encode's: K5 and K4 treat rows apart), and ``resid``, each
    shard's new residual rows on its own device. Launches: K4 once and
    K5 once per distinct leaf width, per shard."""

    comp: cc.CompressionConfig
    #: per shard: its ``[per, ...]`` float32 residual rows, on its device
    resid: List[Tree]
    uniforms: Optional[cc.Uniforms] = None
    payload: Optional[dict] = None

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


def stacked_like(tree: Tree, num_clients: int) -> Tree:
    """``[C, ...]`` views of an unstacked tree (no copy): the shapes and
    dtypes a receiver decodes a payload into when no stack landed."""
    return {p: x.unsqueeze(0).expand((num_clients,) + tuple(x.shape))
            for p, x in tree.items()}


def _train_each(local_train: Callable, start_of: Callable, ref_of: Callable,
                batches: Tree, generators: List[Optional[torch.Generator]],
                like: Tree, rmask: Optional[torch.Tensor] = None,
                sender: Optional[Sender] = None, state: bool = True):
    """Every client trains from ``start_of(ref, i)``, ``ref`` being
    ``ref_of(a, b)`` (the reference of clients ``[a, b)``) and ``i`` the
    client's row in it. On a mesh of more than one shard each shard's
    reference and ``rmask`` rows are copied to its device once, before any
    shard is issued, and its clients start from them."""
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
    # the global is packed once for every shard; the cache is keyed by
    # id, so every shard's tree stays alive until all are staged
    trees, packed = [ref_of(a, b) for a, b, _ in rows], {}
    refs = [sh.stage(s, t, packed) for s, t in enumerate(trees)]
    masks = [None if rmask is None else sh.stage(s, rmask[a:b])
             for s, (a, b, _) in enumerate(rows)]
    per = sh.per_device
    inputs = [(start(refs[c // per], masks[c // per], c % per),
               sh.stage(c // per, {k: v[c] for k, v in batches.items()}),
               generators[c]) for c in range(C)]
    stacks, parts = [], []

    def send(s, mine):
        a, b, _ = rows[s]
        stacks.append({p: torch.stack([t[p] for t, _ in mine])
                       for p in like})
        payload, _, sender.resid[s] = compress_stage(
            sender.comp, stacks[s], refs[s], sender.resid[s],
            cc.row_uniforms(sender.uniforms, C, a, b), masks[s])
        parts.append(sender.pack(s, payload))

    outs = run_sharded(sh, inputs, None if sender is None else send)
    stats = torch.stack([sh.land(c // per, s)
                         for c, (_, s) in enumerate(outs)])
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
    per, staged, packed = sh.per_device, {}, {}

    def stage(c, tree):  # a tree several clients share, once a shard
        key = (id(tree), c // per)  # every tree stays alive in ``rows``
        if key not in staged:
            staged[key] = sh.stage(c // per, tree, packed)
        return staged[key]

    inputs = [(stage(c, t), sh.stage(c // per, b))
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


def local_updates(local_train: Callable, client_t: Tree, batches: Tree,
                  generators: List[Optional[torch.Generator]],
                  rmask: Optional[torch.Tensor] = None,
                  sender: Optional[Sender] = None):
    """Every client trains from its OWN row of the stacked ``client_t``
    (``local_updates_body``): ``-> (stacked [C, ...] trees, stats [C, 3])``.
    With a ``sender`` each shard encodes its deltas against its rows of
    ``client_t`` on its own device; the post-train trees still land, the
    round's carried state."""
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
    split around its ledger seam. On a clients mesh of more than one shard
    each shard encodes its own rows (:class:`Sender`), as in
    :func:`server_round`."""
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
        resid = cat_rows(sender.resid, next(iter(new_t.values())).device)
        rec = decode_recon(comp, payload, client_t, new_t)
    mixed = mix_recv(new_t, rec, mask, client_t, alpha, steps)
    return RoundOut(mixed, stats, resid, payload)


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
    ``mesh.row_devices(0)``, under ``sp`` on that row's ring). Each other
    shard ``s`` (1-D or 2-D) does so on its own scratch copy of ``model``
    (:func:`_replica`, the same weights) on ``mesh.client_devices[s]``:
    under ``tp`` split over ``mesh.row_devices(s)``, under ``sp`` with
    its attention on its own row's ring (``sp.ride_ring``), as JAX's
    GSPMD program gives each row of the grid its own clients. Under LoRA a
    copy on exactly the lead shard's devices (``[cuda:0] * 4``, the CPU)
    shares the lead's frozen base, never written; on other devices it owns
    its slices."""
    devices = mesh.train_devices
    lead = [tp_linear.indexed(d) for d in mesh.row_devices(0)]
    models = [model]
    for s in range(1, len(devices)):
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
    local_train = Sharded(trains, devices, per, traffic)
    comp = (compression if compression is not None and compression.enabled
            else None)
    return FedPrograms(
        mesh=mesh, local_train=local_train,
        eval_one=Sharded(evals, devices, per, traffic),
        gossip_round=functools.partial(gossip_round, local_train, comp,
                                       alpha=gossip_alpha,
                                       steps=gossip_steps))
