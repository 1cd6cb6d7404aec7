"""One federated server round: port of ``bcfl_tpu/fed/client_step.py``
(``make_optimizer``, ``make_loss_fn``, ``make_local_train``,
``train_clients``, ``server_body``/``server_body_comp``, ``_compress_stage``
and ``_recon`` of the GSPMD builder).

The JAX package compiles every client's local round plus the aggregation
into one XLA program over a stacked ``[C, ...]`` client axis. Here the
clients run one after another on the one device through a single scratch
``nn.Module``: each loads the round's global tree, trains with a fresh
AdamW, and its post-train tree lands in row ``c`` of the stacked ``[C,
...]`` tree that the codec and the FedAvg mean consume, as the JAX stacked
axis does. Trees are ``{flax leaf path: tensor}`` dicts in the JAX leaf
order and layout (:func:`bcfl_tpu_torch.models.convert.trainable_tree`),
so codec payloads match the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from bcfl_tpu_torch.compression import codecs as cc
from bcfl_tpu_torch.models.convert import load_trainable, trainable_tree
from bcfl_tpu_torch.parallel import masked_weighted_mean

Tree = Dict[str, torch.Tensor]


def make_optimizer(params, name: str = "adamw", lr: float = 5e-5
                   ) -> torch.optim.Optimizer:
    """A fresh optimizer for one local round: AdamW with PyTorch's
    defaults (betas 0.9/0.999, eps 1e-8, weight decay 0.01), the optax
    ``adamw`` of the JAX package."""
    if name != "adamw":
        raise ValueError(f"optimizer={name!r} is not ported yet")
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.01)


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
                     optimizer: str = "adamw", lr: float = 5e-5) -> Callable:
    """One client's local round:
    ``(trainable, batches, generator) -> (trainable', [loss*n, correct, n])``
    with a fresh optimizer state, one step per ``[steps, ...]`` batch."""

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


def train_clients(local_train: Callable, global_t: Tree, batches: Tree,
                  generators: List[Optional[torch.Generator]]):
    """Every client trains from ``global_t`` on its own ``batches[c]``:
    ``-> (stacked [C, ...] trees, stats [C, 3])``."""
    C = batches["ids"].shape[0]
    new_t = {p: torch.empty((C,) + tuple(x.shape), dtype=x.dtype,
                            device=x.device) for p, x in global_t.items()}
    stats = []
    for c in range(C):
        t, s = local_train(global_t, {k: v[c] for k, v in batches.items()},
                           generators[c])
        for p, x in t.items():
            new_t[p][c] = x
        stats.append(s)
    return new_t, torch.stack(stats)


def compress_stage(comp: cc.CompressionConfig, new_t: Tree, ref_t: Tree,
                   resid: Tree, uniforms: Optional[cc.Uniforms]):
    """Sender side of one wire exchange: ``(payload, decoded, resid')`` for
    ``delta = new_t - ref_t`` plus the carried error-feedback residual
    (``_compress_stage``)."""
    delta = {p: new_t[p].float() - ref_t[p].float() for p in new_t}
    return cc.roundtrip(comp, delta, resid, uniforms)


def recon(ref_t: Tree, dec: Tree, like_t: Tree) -> Tree:
    """Receiver-side reconstruction ``ref + decoded delta`` in the param
    dtype (``_recon``): what the aggregator consumes."""
    return {p: (ref_t[p].float() + dec[p]).to(like_t[p].dtype) for p in dec}


@dataclasses.dataclass
class RoundOut:
    global_t: Tree  # the new global tree
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
    updates. An all-masked round keeps ``global_t``."""
    new_t, stats = train_clients(local_train, global_t, batches, generators)
    if comp is None or not comp.enabled:
        return RoundOut(masked_weighted_mean(new_t, weights, global_t), stats)
    payload, dec, resid = compress_stage(comp, new_t, global_t, resid,
                                         uniforms)
    avg = masked_weighted_mean(recon(global_t, dec, new_t), weights, global_t)
    return RoundOut(avg, stats, resid, payload)
