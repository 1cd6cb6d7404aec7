"""Tokenize-once cache and fixed-shape federated batch stacks: port of
``bcfl_tpu/data/pipeline.py`` (numpy only; the engine moves the stacks to
the device).

The corpus is tokenized once into ``[N, seq_len]`` int32 arrays; a round's
training input is one ``[num_clients, steps, batch, seq_len]`` stack with
``steps`` fixed across clients. A client with fewer examples wraps around,
and the per-example mask keeps its loss and metrics honest.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from bcfl_tpu_torch.data.datasets import TextDataset


@dataclasses.dataclass
class TokenCache:
    """One-shot tokenization of a :class:`TextDataset`."""

    train_ids: np.ndarray  # [N_train, L] int32
    train_mask: np.ndarray
    train_labels: np.ndarray  # [N_train] int32
    test_ids: np.ndarray
    test_mask: np.ndarray
    test_labels: np.ndarray
    num_labels: int

    @classmethod
    def build(cls, ds: TextDataset, tokenizer, seq_len: int) -> "TokenCache":
        tr_ids, tr_mask = tokenizer.encode_batch(ds.train_texts, seq_len)
        te_ids, te_mask = tokenizer.encode_batch(ds.test_texts, seq_len)
        return cls(tr_ids, tr_mask, ds.train_labels, te_ids, te_mask,
                   ds.test_labels, ds.num_labels)


def _gather_batches(ids, mask, labels, idx: np.ndarray, batch: int,
                    steps: int):
    """[steps*batch] indices (wrapping) -> ids/mask/labels/example-mask."""
    need = steps * batch
    if idx.size == 0:
        idx = np.zeros((1,), dtype=np.int64)
        valid = np.zeros((need,), dtype=np.float32)
    else:
        valid = (np.arange(need) < idx.size).astype(np.float32)
    take = idx[np.arange(need) % idx.size]
    shape = (steps, batch)
    return (ids[take].reshape(shape + ids.shape[1:]),
            mask[take].reshape(shape + mask.shape[1:]),
            labels[take].reshape(shape),
            valid.reshape(shape))


def client_batches(cache: TokenCache, part, num_clients,
                   round_idx: int, batch_size: int,
                   max_batches: Optional[int] = None, split: str = "train"
                   ) -> Tuple[dict, np.ndarray]:
    """The round's stacked per-client batches.

    ``part`` is anything with ``train_test_indices(client, round)`` (a
    :class:`~bcfl_tpu_torch.data.partition.Partitioner`). ``num_clients``
    is a count (clients ``0..n-1``) or a vector of client ids: cohort mode
    passes the round's sampled registry ids, so each slot holds that
    client's own partition. Returns
    ``(batch_tree, num_examples)``: ``batch_tree`` leaves are
    ``[num_clients, steps, batch, ...]`` numpy arrays (``ids``, ``mask``,
    ``labels``, ``example_mask``) and ``num_examples[c]`` is client ``c``'s
    true example count, the FedAvg weight."""
    if split == "train":
        ids, mask, labels = (cache.train_ids, cache.train_mask,
                             cache.train_labels)
    else:
        ids, mask, labels = cache.test_ids, cache.test_mask, cache.test_labels
    client_ids = (range(num_clients)
                  if isinstance(num_clients, (int, np.integer))
                  else np.asarray(num_clients).tolist())
    per_client_idx = []
    for c in client_ids:
        tr, te = part.train_test_indices(int(c), round_idx)
        per_client_idx.append(tr if split == "train" else te)

    sizes = [max(i.size, 1) for i in per_client_idx]
    steps = int(np.ceil(max(sizes) / batch_size))
    if max_batches is not None:
        steps = min(steps, max_batches)
    steps = max(steps, 1)

    parts = [_gather_batches(ids, mask, labels, idx, batch_size, steps)
             for idx in per_client_idx]
    n_examples = np.asarray([i.size for i in per_client_idx], np.float32)
    tree = {name: np.stack([p[j] for p in parts])
            for j, name in enumerate(("ids", "mask", "labels",
                                      "example_mask"))}
    return tree, n_examples


def central_eval_batches(cache: TokenCache, batch_size: int,
                         max_batches: Optional[int] = None) -> dict:
    """Whole-test-set batches for the global model's evaluation."""
    n = cache.test_ids.shape[0]
    steps = int(np.ceil(n / batch_size))
    if max_batches is not None:
        steps = min(steps, max_batches)
    ids, mask, labels, emask = _gather_batches(
        cache.test_ids, cache.test_mask, cache.test_labels, np.arange(n),
        batch_size, steps)
    return {"ids": ids, "mask": mask, "labels": labels, "example_mask": emask}
