"""Client-axis aggregation and gossip: port of ``bcfl_tpu/parallel/gspmd.py``
(``masked_weighted_mean``, ``ring_shift``, ``gossip_mix``,
``gossip_mix_recv``, ``mix_with_matrix``) and of
``parallel/collectives.py::gossip_step_mix``, the mixing rule.

The port runs every client on one device, so the JAX package's two forms
(the ``psum``/``ppermute`` of ``parallel/collectives.py`` and the
global-array form of ``parallel/gspmd.py``) collapse into the global-array
one: each function works on the leading ``[C]`` axis of every stacked
leaf of a ``{path: tensor}`` tree.
"""

from __future__ import annotations

from typing import Dict, Optional

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
