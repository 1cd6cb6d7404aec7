"""Client-axis aggregation: port of ``bcfl_tpu/parallel/gspmd.py``
(``masked_weighted_mean``, the FedAvg rule).

The port runs every client on one device, so the JAX package's two forms
(the ``psum`` of ``parallel/collectives.py`` and the global-array form of
``parallel/gspmd.py``) collapse into this one: a weighted sum over the
leading ``[C]`` axis of each stacked leaf.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

Tree = Dict[str, torch.Tensor]
EPS = 1e-12


def masked_weighted_mean(tree: Tree, weights: torch.Tensor,
                         fallback: Optional[Tree] = None) -> Tree:
    """Weighted mean over the client axis; a round whose weights sum to at
    most ``EPS`` (every client masked) returns ``fallback`` instead (the
    unweighted mean when no fallback is given)."""
    den = weights.sum()
    empty = den <= EPS
    out = {}
    for p, x in tree.items():
        w = weights.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
        mean = (w * x).sum(dim=0) / torch.clamp(den, min=EPS).to(x.dtype)
        fb = x.mean(dim=0) if fallback is None else fallback[p]
        out[p] = torch.where(empty, fb.to(mean.dtype), mean)
    return out
