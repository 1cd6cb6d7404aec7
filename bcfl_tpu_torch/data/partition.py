"""Client data partitioners: port of ``bcfl_tpu/data/partition.py``.

- IID: ``n`` random indices per client, drawn without replacement,
  optionally afresh each round;
- Non-IID contiguous, trailing test: client ``k`` trains on
  ``[stride*k, stride*k + train_span)`` and tests on the slice after it;
- Non-IID contiguous, fixed test: the same train slices and a shared
  ``[0, test_span)`` test slice.

Slices are clipped to each split's length, with wraparound for a client
whose slice lies wholly past the end (as in the JAX package).

The IID draw uses ``numpy.random.Generator`` seeded per
``(seed, round, client)``; the JAX package draws with ``jax.random``
(threefry), so the two packages pick different IID indices for the same
seed. The contiguous schedules are identical. Parity tests hand the JAX
partitioner's indices (or batches built from them) to both packages.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from bcfl_tpu_torch.config import PartitionConfig

#: stream lane for partition draws (the JAX engine folds 1 into its root key)
PARTITION_LANE = 1


def iid_indices(rng: np.random.Generator, n_total: int,
                n_samples: int) -> np.ndarray:
    """Random sample without replacement, deterministic under ``rng``."""
    n_samples = min(n_samples, n_total)
    return rng.permutation(n_total)[:n_samples]


def _clip_or_wrap(lo: int, span: int, n_total: int) -> np.ndarray:
    idx = np.arange(lo, min(lo + span, n_total))
    if idx.size == 0 and n_total > 0:
        lo = lo % n_total
        idx = np.arange(lo, min(lo + span, n_total))
    return idx


def contiguous_indices(client: int, stride: int, train_span: int,
                       test_span: int, n_train: int, n_test: int,
                       test_mode: str = "trailing"
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """The Non-IID slice arithmetic, clipped to each split's length."""
    train = _clip_or_wrap(stride * client, train_span, n_train)
    if test_mode == "trailing":
        test = _clip_or_wrap(stride * client + train_span, test_span, n_test)
    else:  # fixed shared test slice
        test = np.arange(0, min(test_span, n_test))
    return train, test


class Partitioner:
    """Per-(client, round) index selection driven by :class:`PartitionConfig`."""

    def __init__(self, cfg: PartitionConfig, n_train: int, n_test: int,
                 seed: int):
        self.cfg = cfg
        self.n_train = n_train
        self.n_test = n_test
        self.seed = seed

    def train_test_indices(self, client: int, round_idx: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
        c = self.cfg
        if c.kind == "iid":
            r = round_idx if c.resample_each_round else 0
            rng = np.random.default_rng([self.seed, PARTITION_LANE, r, client])
            n_test = (c.iid_samples if c.iid_test_samples is None
                      else c.iid_test_samples)
            return (iid_indices(rng, self.n_train, c.iid_samples),
                    iid_indices(rng, self.n_test, n_test))
        return contiguous_indices(client, c.stride, c.train_span,
                                  c.test_span, self.n_train, self.n_test,
                                  c.test_mode)
