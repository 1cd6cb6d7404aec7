"""Client-axis aggregation and gossip: port of ``bcfl_tpu/parallel/gspmd.py``
(``masked_weighted_mean``, ``hierarchical_weighted_mean`` (cohort mode),
``rank_aware_weighted_mean`` (RBLA), the robust rules ``masked_trimmed_mean``,
``masked_median``, ``masked_krum`` and ``make_aggregator``, ``ring_shift``,
``gossip_mix``, ``gossip_mix_recv``, ``mix_with_matrix``) and of
``parallel/collectives.py::gossip_step_mix``, the mixing rule.

The port runs every client on one device, so the JAX package's two forms
(the ``psum``/``ppermute`` of ``parallel/collectives.py`` and the
global-array form of ``parallel/gspmd.py``) collapse into the global-array
one: each function works on the leading ``[C]`` axis of every stacked
leaf of a ``{path: tensor}`` tree.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]
EPS = 1e-12


def _col(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A ``[C]`` vector shaped to broadcast against ``[C, ...]`` ``x``, in
    ``x``'s dtype."""
    return v.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)


def masked_weighted_mean(tree: Tree, weights: torch.Tensor,
                         fallback: Optional[Tree] = None) -> Tree:
    """Weighted mean over the client axis; a round whose weights sum to at
    most ``EPS`` (every client masked) returns ``fallback`` instead (the
    unweighted mean when no fallback is given)."""
    den = weights.sum()
    empty = den <= EPS
    out = {}
    for p, x in tree.items():
        mean = (_col(weights, x) * x).sum(dim=0) / torch.clamp(
            den, min=EPS).to(x.dtype)
        fb = x.mean(dim=0) if fallback is None else fallback[p]
        out[p] = torch.where(empty, fb.to(mean.dtype), mean)
    return out


def hierarchical_weighted_mean(tree: Tree, weights: torch.Tensor,
                               groups: int,
                               fallback: Optional[Tree] = None) -> Tree:
    """Two-level masked weighted mean (cohort mode): the ``[C]`` axis
    splits into ``[groups, C / groups]``, each group (one device's slice of
    the cohort in JAX) is summed first, then the partial sums. The math of
    :func:`masked_weighted_mean` up to the summation order; ``groups <= 1``
    or a ``C`` it does not divide is that function exactly."""
    C = int(weights.shape[0])
    if groups <= 1 or C % groups:
        return masked_weighted_mean(tree, weights, fallback=fallback)
    per = C // groups
    den = weights.sum()
    empty = den <= EPS
    out = {}
    for p, x in tree.items():
        part = (_col(weights, x) * x).reshape(
            (groups, per) + tuple(x.shape[1:])).sum(dim=1)
        mean = part.sum(dim=0) / torch.clamp(den, min=EPS).to(x.dtype)
        fb = x.mean(dim=0) if fallback is None else fallback[p]
        out[p] = torch.where(empty, fb.to(mean.dtype), mean)
    return out


def rank_aware_weighted_mean(tree: Tree, weights: torch.Tensor,
                             rank_mask: torch.Tensor,
                             fallback: Optional[Tree] = None) -> Tree:
    """RBLA weighted mean (arXiv 2408.08699) over a heterogeneous-rank
    stacked adapter tree: every client is zero-padded to the fleet's
    maximum rank R and ``rank_mask`` ``[C, R]`` marks its real rank dims.
    Per rank dim, ``a`` leaves (``[C, fan_in, R]``) and ``b`` leaves
    (``[C, R, fan_out]``) average over the clients that hold the dim,
    normalized by their weights; a dim no participating client holds keeps
    ``fallback``. ``full`` head leaves take the plain weighted mean; an
    all-masked round returns ``fallback``."""
    den_all = weights.sum()
    empty = den_all <= EPS
    R = int(rank_mask.shape[1])
    out = {}
    for p, x in tree.items():
        last = p.rsplit("/", 1)[-1]
        fb = x.mean(dim=0) if fallback is None else fallback[p]
        if last in ("a", "b") and x.dim() == 3 and x.shape[
                -1 if last == "a" else 1] == R:
            w = (weights[:, None] * rank_mask).to(x.dtype)  # [C, R]
            den = w.sum(dim=0)  # [R]
            if last == "a":
                num = torch.einsum("cj,cfj->fj", w, x)
                den_b = den[None, :]
            else:
                num = torch.einsum("cj,cjf->jf", w, x)
                den_b = den[:, None]
            mean = num / torch.clamp(den_b, min=EPS)
            mean = torch.where(den_b > EPS, mean, fb.to(mean.dtype))
        else:
            mean = (_col(weights, x) * x).sum(dim=0) / torch.clamp(
                den_all, min=EPS).to(x.dtype)
        out[p] = torch.where(empty, fb.to(mean.dtype), mean)
    return out


# ---------------------------------------------------------------------------
# Byzantine-robust aggregation rules (``gspmd.py:155-316``). Plain PyTorch
# over the stacked client axis, as the JAX rules are plain ``jnp`` outside
# any Pallas kernel. They are mask-aware through order statistics, not
# weighting: ``weights > 0`` marks a client as participating and the
# magnitudes are ignored. An all-masked round returns ``fallback``, as
# masked_weighted_mean does. The participation count is read to the host
# once per call; every sort runs per leaf, over slabs of columns, so the
# sort's temporaries stay small beside a [C, 30522 x 768] leaf.
# ---------------------------------------------------------------------------

# sort sentinel for non-participating clients: large but finite, so a
# ``sentinel * 0`` term of a masked sum is 0.0 rather than inf * 0 = NaN
_SENTINEL = 1e30
# elements of one sorted slab ([C, columns]) of a leaf
_SORT_SLAB = 1 << 24


def _participation(weights: torch.Tensor):
    """``(active [C] float32, k, empty)``: the participating clients
    (positive weight), their count as a host int, and ``k <= 0``."""
    active = (weights > 0).to(torch.float32)
    k = int(active.sum().item())
    return active, k, k <= 0


def _sort_active_first(x: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Sort the client axis ascending in float32 with non-participants
    pushed to the tail: slots ``[0, k)`` hold the participating values in
    order (NaN sorts after every number, as in ``jnp.sort``)."""
    a = active.reshape((-1,) + (1,) * (x.dim() - 1))
    keyed = torch.where(a > 0, x.to(torch.float32),
                        torch.tensor(_SENTINEL, dtype=torch.float32,
                                     device=x.device))
    return torch.sort(keyed, dim=0).values


def _trim_count(k: int, trim: float) -> int:
    """``ceil(trim * k)`` in float32 (JAX's arithmetic), clamped so at
    least one client survives trimming (``2t <= k - 1``)."""
    t = int(np.ceil(np.float32(trim) * np.float32(k)))
    return int(np.clip(t, 0, max((k - 1) // 2, 0)))


def _by_slab(x: torch.Tensor, leaf_fn) -> torch.Tensor:
    """``leaf_fn`` over column slabs of the ``[C, ...]`` leaf ``x``,
    concatenated back to the leaf's unstacked shape: the per-coordinate
    rules are column-independent, so a slab sees the same values."""
    C = x.shape[0]
    flat = x.reshape(C, -1)
    cols = max(_SORT_SLAB // max(C, 1), 1)
    out = torch.cat([leaf_fn(flat[:, j:j + cols])
                     for j in range(0, flat.shape[1], cols)])
    return out.reshape(x.shape[1:])


def _fallback(x: torch.Tensor, fb: Optional[torch.Tensor]) -> torch.Tensor:
    return (x.mean(dim=0) if fb is None else fb).to(x.dtype)


def masked_trimmed_mean(tree: Tree, weights: torch.Tensor, trim: float = 0.2,
                        fallback: Optional[Tree] = None) -> Tree:
    """Coordinate-wise trimmed mean over the participating clients: per
    coordinate, drop the ``t = ceil(trim * k)`` smallest and largest values
    and mean the middle ``k - 2t`` (summed in float32, cast back to the
    leaf's dtype)."""
    active, k, empty = _participation(weights)
    if empty:
        return {p: _fallback(x, None if fallback is None else fallback[p])
                for p, x in tree.items()}
    t = _trim_count(k, trim)
    cnt = torch.tensor(float(max(k - 2 * t, 1)), dtype=torch.float32,
                       device=weights.device)
    C = weights.shape[0]
    pos = torch.arange(C, device=weights.device).reshape(-1, 1)
    sel = ((pos >= t) & (pos < k - t)).to(torch.float32)

    def mean(cols):
        kept = _sort_active_first(cols, active) * sel
        # summed row after row, XLA's order for a reduction over the
        # leading axis (torch's own ``sum`` order varies with the shape)
        acc = kept[0]
        for row in kept[1:]:
            acc = acc + row
        return acc / cnt

    return {p: _by_slab(x, mean).to(x.dtype) for p, x in tree.items()}


def masked_median(tree: Tree, weights: torch.Tensor,
                  fallback: Optional[Tree] = None) -> Tree:
    """Coordinate-wise median over the participating clients (the mean of
    the two middle order statistics for even ``k``), in float32, cast back
    to the leaf's dtype."""
    active, k, empty = _participation(weights)
    if empty:
        return {p: _fallback(x, None if fallback is None else fallback[p])
                for p, x in tree.items()}
    c = weights.shape[0] - 1
    lo, hi = min(max((k - 1) // 2, 0), c), min(max(k // 2, 0), c)

    def med(cols):
        xs = _sort_active_first(cols, active)
        return (xs[lo] + xs[hi]) * 0.5

    return {p: _by_slab(x, med).to(x.dtype) for p, x in tree.items()}


def masked_krum(tree: Tree, weights: torch.Tensor, trim: float = 0.2,
                fallback: Optional[Tree] = None) -> Tree:
    """Krum (Blanchard et al., NeurIPS 2017) over the participating
    clients: each is scored by the summed squared distance to its
    ``m = k - f - 2`` nearest participating neighbours (``f = ceil(trim *
    k)``, ``m >= 1``) and the lowest-scoring client's update is adopted
    whole. The ``[C, C]`` matrix of squared distances is summed over the
    leaves in float32, as in the JAX package; each leaf's distances are
    taken from the differences of the updates (``torch.cdist`` without
    its matmul form), not as ``|a|^2 + |b|^2 - 2 a.b``: that form cancels
    at the parameters' own magnitude, which leaves clients one local round
    apart to float32 rounding (and the card and the CPU then select
    different clients)."""
    active, k, empty = _participation(weights)
    if empty:
        return {p: _fallback(x, None if fallback is None else fallback[p])
                for p, x in tree.items()}
    f = _trim_count(k, trim)
    m = max(k - f - 2, 1)
    C = weights.shape[0]
    dev = weights.device
    D = torch.zeros((C, C), dtype=torch.float32, device=dev)
    for x in tree.values():
        xf = x.reshape(C, -1).to(torch.float32)
        d = torch.cdist(xf, xf, compute_mode="donot_use_mm_for_euclid_dist")
        D = D + d * d
    pair = active[:, None] * active[None, :]
    sentinel = torch.tensor(_SENTINEL, dtype=torch.float32, device=dev)
    D = torch.where(pair > 0, torch.clamp(D, min=0.0), sentinel)
    D.fill_diagonal_(_SENTINEL)  # no self-distance
    Ds = torch.sort(D, dim=1).values
    pos = torch.arange(C, device=dev)[None, :]
    score = torch.where(pos < m, Ds, torch.zeros((), device=dev)).sum(dim=1)
    score = torch.where(active > 0, score,
                        torch.tensor(float("inf"), device=dev))
    sel = int(torch.argmin(score).item())
    return {p: x[sel].clone() for p, x in tree.items()}


AGGREGATORS = ("mean", "trimmed_mean", "median", "krum")


def make_aggregator(name: str, trim: float = 0.2,
                    hierarchical_groups: int = 0,
                    rank_mask: Optional[torch.Tensor] = None):
    """``(tree, weights, fallback) -> tree`` for the configured rule:
    ``mean`` is the weighted FedAvg mean, the robust rules treat
    ``weights`` as a participation mask. ``hierarchical_groups > 1`` makes
    ``mean`` the two-level :func:`hierarchical_weighted_mean` (cohort mode;
    the robust rules ignore it: their order statistics are global).
    ``rank_mask`` ``[C, R]`` (heterogeneous LoRA ranks) makes ``mean`` the
    RBLA :func:`rank_aware_weighted_mean` and rejects any other rule."""
    if rank_mask is not None:
        if name != "mean":
            raise ValueError(
                f"rank-aware aggregation (heterogeneous LoRA ranks) is "
                f"defined for the mean only, got aggregator {name!r}")
        return lambda t, w, fb: rank_aware_weighted_mean(
            t, w, rank_mask, fallback=fb)
    if name == "mean":
        if hierarchical_groups > 1:
            return lambda t, w, fb: hierarchical_weighted_mean(
                t, w, hierarchical_groups, fallback=fb)
        return lambda t, w, fb: masked_weighted_mean(t, w, fallback=fb)
    if name == "trimmed_mean":
        return lambda t, w, fb: masked_trimmed_mean(t, w, trim, fallback=fb)
    if name == "median":
        return lambda t, w, fb: masked_median(t, w, fallback=fb)
    if name == "krum":
        return lambda t, w, fb: masked_krum(t, w, trim, fallback=fb)
    raise ValueError(f"unknown aggregator {name!r} (one of {AGGREGATORS})")


def ring_shift(tree: Tree, direction: int = +1) -> Tree:
    """Each client's ring neighbour over the client order: ``direction=+1``
    means client ``i`` receives ``(i+1) mod C``'s value (a roll by -1)."""
    if direction not in (+1, -1):
        raise ValueError("direction must be +1 or -1")
    return {p: torch.roll(x, -direction, dims=0) for p, x in tree.items()}


def gossip_step_mix(x, xl, xr, ml, mr, me, alpha: float):
    """One client's masked ring-gossip update (masks already shaped to
    broadcast against ``x``): THE mixing rule."""
    mixed = x + (alpha / 2) * ml * (xl - x) + (alpha / 2) * mr * (xr - x)
    return me * mixed + (1 - me) * x


def gossip_mix(tree: Tree, mask: torch.Tensor, alpha: float,
               steps: int = 1) -> Tree:
    """Symmetric masked ring gossip: each client averages toward its two
    ring neighbours,

        x_i <- x_i + (alpha/2) m_{i-1} (x_{i-1} - x_i)
                   + (alpha/2) m_{i+1} (x_{i+1} - x_i),

    and a masked client is frozen. The self == received case of
    :func:`gossip_mix_recv`."""
    return gossip_mix_recv(tree, tree, mask, alpha, steps=steps)


def gossip_mix_recv(self_tree: Tree, recv_tree: Tree, mask: torch.Tensor,
                    alpha: float, steps: int = 1) -> Tree:
    """``gossip_mix`` with distinct SELF and RECEIVED trees: each client's
    self-term comes from ``self_tree`` (its own honest state) and the
    neighbour terms are ring-shifted from ``recv_tree`` (what crossed the
    wire: a codec's lossy reconstruction). Only the first step models
    transport; later steps exchange the post-mix state."""
    m_left = torch.roll(mask, 1, dims=0)  # value of client i-1, at slot i
    m_right = torch.roll(mask, -1, dims=0)
    for _ in range(steps):
        # leaf by leaf, so only one leaf's neighbour copies are alive
        self_tree = {
            p: gossip_step_mix(x, torch.roll(recv_tree[p], 1, dims=0),
                               torch.roll(recv_tree[p], -1, dims=0),
                               _col(m_left, x), _col(m_right, x),
                               _col(mask, x), alpha)
            for p, x in self_tree.items()}
        recv_tree = self_tree
    return self_tree


def mix_with_matrix(tree: Tree, W: torch.Tensor) -> Tree:
    """Arbitrary-topology mixing ``x_i <- sum_j W[i, j] x_j`` (for example
    the Metropolis matrix of
    :func:`bcfl_tpu_torch.topology.metropolis_mixing_matrix`)."""
    return {p: torch.einsum("ij,j...->i...", W.to(x.dtype), x)
            for p, x in tree.items()}
