"""Cohort mode: port of ``bcfl_tpu/fed/cohort.py`` (``ClientSampler``,
``EFRegistry``, ``cohort_view``).

A registry of ``registry_size`` clients exists only as host state (data
partition, PRNG streams, fault schedules, reputation arrays and
error-feedback residuals, all keyed by registry id); each round a seeded
:class:`ClientSampler` draws ``sample_clients`` of them onto the stacked
client axis. The sampler is numpy in both packages, so its draws are the
JAX package's bit for bit; the residual store holds CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

# the sampler's stream lane: (seed, lane, round) keeps the cohort draw
# apart from the fault plan's (faults.seed, lane, round) draws
_SAMPLER_LANE = 77_003


@dataclasses.dataclass(frozen=True)
class ClientSampler:
    """Seeded per-round cohort draw over a client registry:
    ``cohort_ids(rnd)`` is a pure function of ``(seed, rnd)``, uniform
    without replacement, sorted ascending."""

    seed: int
    registry_size: int
    cohort: int

    def __post_init__(self):
        if not 1 <= self.cohort <= self.registry_size:
            raise ValueError(
                f"cohort {self.cohort} must be in [1, registry_size="
                f"{self.registry_size}]")

    def cohort_ids(self, round_idx: int) -> np.ndarray:
        """``[cohort]`` int64 registry ids sampled for ``round_idx``."""
        rng = np.random.default_rng((self.seed, _SAMPLER_LANE, round_idx))
        ids = rng.choice(self.registry_size, size=self.cohort, replace=False)
        return np.sort(ids).astype(np.int64)


class EFRegistry:
    """Host store of each registry client's error-feedback residual.

    The codec carries a stacked ``[cohort, ...]`` float32 residual; with
    sampling on, its rows belong to other clients every round, so the
    engine gathers the cohort's rows from here before the round and
    scatters the updated rows back after it. A client never sampled reads
    as zeros (a fresh residual)."""

    def __init__(self, template_tree: Dict[str, torch.Tensor]):
        # one client's zero row, shaped like one row of the residual
        self._zero = {p: torch.zeros(tuple(x.shape), dtype=torch.float32)
                      for p, x in template_tree.items()}
        self._store: Dict[int, Dict[str, torch.Tensor]] = {}

    def __len__(self) -> int:
        return len(self._store)

    def gather(self, ids, device=None) -> Dict[str, torch.Tensor]:
        """Stacked ``[len(ids), ...]`` tree of the ids' residuals, on
        ``device`` (the host when None)."""
        rows = [self._store.get(int(i), self._zero) for i in ids]
        return {p: torch.stack([r[p] for r in rows]).to(device)
                for p in self._zero}

    def scatter(self, ids, stacked: Dict[str, torch.Tensor]) -> None:
        """Write the round's updated rows back by registry id, copied to
        the host (a row must not keep the whole stacked buffer alive)."""
        host = {p: x.detach().to("cpu", torch.float32)
                for p, x in stacked.items()}
        for pos, i in enumerate(ids):
            self._store[int(i)] = {p: x[pos].clone() for p, x in host.items()}

    def checkpoint_state(self) -> Dict[str, object]:
        """``ef_ids`` (``[K]`` int64) and ``ef_registry`` (stacked tree)
        for the engine checkpoint; empty before the first scatter."""
        if not self._store:
            return {}
        ids = np.asarray(sorted(self._store), np.int64)
        return {"ef_ids": ids, "ef_registry": self.gather(ids)}

    def restore(self, state: Dict) -> None:
        self._store.clear()
        ids = state.get("ef_ids")
        if ids is None:
            return
        self.scatter(np.asarray(ids, np.int64).reshape(-1),
                     state["ef_registry"])


def cohort_view(arr: Optional[np.ndarray],
                ids: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """A registry-sized host array cut to the round's cohort rows (the
    array itself when sampling is off, ``ids is None``, or it is None)."""
    if arr is None or ids is None:
        return arr
    return np.asarray(arr)[ids]
