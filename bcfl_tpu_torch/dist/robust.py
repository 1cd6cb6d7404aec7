"""Byzantine-robust aggregation over the FedBuff ARRIVAL set: port of
``bcfl_tpu/dist/robust.py``.

The local engine's robust rules act over a fixed stacked client axis
(:mod:`bcfl_tpu_torch.parallel.collectives`); the dist leader's population is
the buffered arrival set instead, one vote per sending PEER, its size set
by arrival order and quorum. The semantics are JAX's:

- each peer speaks with ONE vote: its buffered updates are first
  weight-combined into one delta (:func:`combine_votes`), so ``k`` is the
  number of distinct senders and one sender's message rate never inflates
  its vote count;
- ``weights`` act as a participation mask: a positive weight is a full
  vote, zero is excluded (the applied step still shrinks with staleness
  through the runtime's ``_async_merge_scale`` rescale);
- a merge with fewer arrivals than the config-time precondition still
  aggregates, the trim clamped, and the runtime records it
  ``robust_degraded``;
- every call also returns per-arrival outlier flags: an active arrival
  whose squared distance to the robust aggregate exceeds ``OUTLIER_MULT``
  times the median arrival distance (judged only for k >= 3). They are the
  reputation tracker's outlier evidence, the one lane that sees poison
  under matching digests.

Like JAX's, the rules work in float64 over the trees in sorted-key order,
and the aggregate takes the votes' dtype. They run leaf by leaf on the
device the votes sit on (the leader's card in a peer), so the card never
holds more than one leaf's ``[k, n]`` float64 stack and its sort. Krum's
pairwise distances are summed from differences, ``|a - b|^2``, as the
port's local rules take them; JAX forms ``|a|^2 + |b|^2 - 2 a.b``, which
cancels for large, nearly equal votes.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

# an arrival whose squared distance to the robust aggregate exceeds this
# multiple of the median arrival distance is flagged as an outlier
# (evidence, not exclusion: exclusion is the rule's own job)
OUTLIER_MULT = 4.0

RULES = ("trimmed_mean", "median", "krum")

# minimum distinct peer votes for an order statistic to exclude anything:
# the trimmed_mean/median config-time precondition AND the runtime's
# robust_degraded threshold (one source, so the two cannot drift)
MIN_ORDER_VOTES = 3


def _leaves(tree, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, torch.Tensor]]:
    """``(key path, leaf)`` of a (nested dict) tree in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _at(tree, path: Tuple):
    for k in path:
        tree = tree[k]
    return tree


def _build(tree, leaf_fn, prefix: Tuple = ()):
    """A tree of ``tree``'s structure (sorted keys) with each leaf
    ``leaf_fn(path)``."""
    if isinstance(tree, dict):
        return {k: _build(tree[k], leaf_fn, prefix + (k,))
                for k in sorted(tree)}
    return leaf_fn(prefix)


def _stack64(trees, path: Tuple) -> torch.Tensor:
    """``[k, n]`` float64 stack of one leaf across ``trees``."""
    return torch.stack([_at(t, path).reshape(-1).to(torch.float64)
                        for t in trees])


def trim_count(k: int, trim: float) -> int:
    """ceil(trim * k) clamped so at least one vote survives (the local
    rules' ``_trim_count``)."""
    t = int(math.ceil(trim * k))
    return max(0, min(t, (k - 1) // 2))


def krum_min_buffer(buffer: int, trim: float) -> int:
    """The classical Krum precondition ``k >= 2f + 3`` for a buffer of
    ``k`` arrivals under an assumed Byzantine fraction ``trim``: the
    config-time validation quotes it."""
    return 2 * int(math.ceil(trim * buffer)) + 3


def combine_votes(deltas: List, weights: List[float]):
    """Weighted mean of ONE peer's buffered update deltas: the peer's
    single vote, in the deltas' dtype (float64 math; equal weights when
    they sum to 0)."""
    if not deltas:
        raise ValueError("combine_votes needs at least one delta")
    w = np.asarray(weights, np.float64)
    total = float(w.sum())
    w = (w / total) if total > 0 else np.full_like(w, 1.0 / len(deltas))

    def leaf(path):
        ref = _at(deltas[0], path)
        X = _stack64(deltas, path)
        wt = torch.as_tensor(w, dtype=torch.float64, device=X.device)
        return (wt[:, None] * X).sum(0).reshape(ref.shape).to(ref.dtype)

    return _build(deltas[0], leaf)


def robust_merge(deltas: List, weights: List[float], rule: str,
                 trim: float = 0.2) -> Tuple[Dict, List[bool], Dict]:
    """Aggregate the arrival set with a robust rule.

    ``deltas`` are the votes (trees of tensors, one structure),
    ``weights`` their total merge weights (the participation mask:
    zero-weight arrivals are excluded and never flagged). Returns
    ``(aggregate, outlier_flags, info)``; ``info`` records the realized
    parameters with JAX's keys (``rule``, ``k``, ``trim_t``,
    ``krum_selected`` as a POSITION in ``deltas``, ``krum_scores``,
    ``distances`` aligned with ``deltas``, ``empty``). The aggregate is
    None when every arrival was excluded."""
    if rule not in RULES:
        raise ValueError(f"unknown robust rule {rule!r} (one of {RULES})")
    if not deltas:
        raise ValueError("robust_merge needs at least one arrival")
    w = np.asarray(weights, np.float64)
    idx = [int(i) for i in np.nonzero(w > 0)[0]]
    k = len(idx)
    info: Dict = {"rule": rule, "k": k}
    if k == 0:
        # every arrival eliminated (auth/trust): the caller keeps the
        # params, like the all-masked degraded round
        return None, [False] * len(deltas), dict(info, empty=True)
    active = [deltas[i] for i in idx]
    paths = [p for p, _ in _leaves(deltas[0])]
    sel = None
    dev = _at(deltas[0], paths[0]).device
    if rule == "krum":
        # pairwise squared distances summed leaf by leaf on the votes'
        # device, read back once
        Dt = torch.zeros((k, k), dtype=torch.float64, device=dev)
        for path in paths:
            A = _stack64(active, path)
            for i in range(k):
                Dt[i, i + 1:] += ((A[i + 1:] - A[i]) ** 2).sum(1)
            del A
        D = Dt.cpu().numpy()
        D = D + D.T
        np.fill_diagonal(D, np.inf)
        f = trim_count(k, trim)
        m = max(k - f - 2, 1)
        scores = np.sort(D, axis=1)[:, :m].sum(axis=1)
        sel = int(np.argmin(scores))
        info["krum_selected"] = idx[sel]
        info["krum_scores"] = [float(s) for s in scores]
    elif rule == "trimmed_mean":
        info["trim_t"] = trim_count(k, trim)
    d2t = torch.zeros((k,), dtype=torch.float64, device=dev)
    out = {}
    for path in paths:
        A = _stack64(active, path)
        if rule == "trimmed_mean":
            t = info["trim_t"]
            agg = torch.sort(A, dim=0).values[t:k - t].mean(0)
        elif rule == "median":
            S = torch.sort(A, dim=0).values
            agg = (S[k // 2] if k % 2
                   else (S[k // 2 - 1] + S[k // 2]) / 2.0)
            del S
        else:
            agg = A[sel]
        if k >= 3:
            d2t += ((A - agg[None, :]) ** 2).sum(1)
        ref = _at(deltas[0], path)
        out[path] = agg.reshape(ref.shape).to(ref.dtype)
        del A, agg
    # outlier evidence: each active arrival's distance to the aggregate,
    # judged against the cohort's own scale (the median distance). k < 3
    # has no cohort to stand out from; zero-weight arrivals were excluded
    # (auth/trust, already recorded evidence), so they are not flagged
    flags = [False] * len(deltas)
    if k >= 3:
        d2 = d2t.cpu().numpy()
        med = float(np.median(d2))
        floor = 1e-12
        dist_full: List = [None] * len(deltas)
        for j, i in enumerate(idx):
            dist_full[i] = float(d2[j])
            if d2[j] > OUTLIER_MULT * max(med, floor):
                flags[i] = True
        info["distances"] = dist_full
    return _build(deltas[0], lambda p: out[p]), flags, info
