"""Synthetic data augmentation: port of ``bcfl_tpu/data/augment.py``.

Seeded, numpy-only augmentation of a
:class:`~bcfl_tpu_torch.data.datasets.TextDataset`'s train split (the
reference ships CTGAN / GaussianCopula / random-shuffle CSVs of the
self-driving sentiment set, made offline with SDV):

- ``shuffle``: label-preserving word-order shuffles;
- ``markov``: per-class bigram Markov chains sampled into new documents;
- ``copula``: Gaussian-copula sampling over per-document token counts of
  the class's top tokens, decoded back to bag-of-words text.

The generator calls are the JAX package's one for one, so the same seed
gives the same texts. The normal CDF and its inverse come from
``scipy.special``, as in JAX (whose pure-numpy fallback for a missing
scipy is not ported).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List

import numpy as np

from bcfl_tpu_torch.data.datasets import TextDataset

METHODS = ("shuffle", "markov", "copula")


def _split_words(text: str) -> List[str]:
    return text.split()


def shuffle_texts(texts: List[str], rng: np.random.Generator) -> List[str]:
    out = []
    for t in texts:
        w = _split_words(t)
        rng.shuffle(w)
        out.append(" ".join(w))
    return out


def _markov_tables(texts: List[str]):
    """Bigram transition table + start distribution for one class."""
    starts: Dict[str, int] = defaultdict(int)
    trans: Dict[str, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
    lengths = []
    for t in texts:
        w = _split_words(t)
        if not w:
            continue
        lengths.append(len(w))
        starts[w[0]] += 1
        for a, b in zip(w, w[1:]):
            trans[a][b] += 1
    return starts, trans, lengths or [8]


def _sample_markov(starts, trans, lengths, rng: np.random.Generator) -> str:
    skeys = list(starts)
    sp = np.array([starts[k] for k in skeys], np.float64)
    word = skeys[rng.choice(len(skeys), p=sp / sp.sum())]
    n = int(rng.choice(lengths))
    out = [word]
    for _ in range(n - 1):
        nxt = trans.get(word)
        if not nxt:
            break
        keys = list(nxt)
        p = np.array([nxt[k] for k in keys], np.float64)
        word = keys[rng.choice(len(keys), p=p / p.sum())]
        out.append(word)
    return " ".join(out)


def _copula_sample(texts: List[str], n: int, rng: np.random.Generator,
                   vocab_cap: int = 256) -> List[str]:
    """Gaussian copula over token-count feature vectors: estimate the
    empirical marginals + correlation of per-document counts for the class's
    top-``vocab_cap`` tokens, draw correlated normals, map back through the
    marginal quantiles, and emit each token ``count`` times (order by
    frequency — bag-of-words synthesis, like the reference's tabular SDV
    usage applied to text)."""
    vocab: Dict[str, int] = defaultdict(int)
    for t in texts:
        for w in _split_words(t):
            vocab[w] += 1
    top = sorted(vocab, key=vocab.get, reverse=True)[:vocab_cap]
    if not top:
        return [""] * n
    idx = {w: i for i, w in enumerate(top)}
    X = np.zeros((len(texts), len(top)), np.float64)
    for r, t in enumerate(texts):
        for w in _split_words(t):
            if w in idx:
                X[r, idx[w]] += 1
    # gaussianize the rank (copula) marginals, estimate correlation
    U = (np.argsort(np.argsort(X, axis=0), axis=0) + 0.5) / len(texts)
    Zn = _norm_ppf(np.clip(U, 1e-4, 1 - 1e-4))
    C = np.corrcoef(Zn, rowvar=False)
    C = np.atleast_2d(np.nan_to_num(C, nan=0.0))
    np.fill_diagonal(C, 1.0)
    # nearest PSD: clip eigenvalues before the Cholesky
    vals, vecs = np.linalg.eigh(C)
    C = (vecs * np.maximum(vals, 1e-6)) @ vecs.T
    L = np.linalg.cholesky(C + 1e-9 * np.eye(len(top)))
    draws = rng.standard_normal((n, len(top))) @ L.T
    # map correlated normals back through the empirical marginal quantiles
    Xs = np.sort(X, axis=0)
    u = _norm_cdf(draws)
    pos = np.clip((u * (len(texts) - 1)).astype(int), 0, len(texts) - 1)
    counts = Xs[pos, np.arange(len(top))[None, :]]
    out = []
    for r in range(n):
        words = []
        for j, w in enumerate(top):
            words.extend([w] * int(round(counts[r, j])))
        rng.shuffle(words)
        out.append(" ".join(words) if words else top[0])
    return out


def _norm_cdf(x: np.ndarray) -> np.ndarray:
    from scipy.special import ndtr

    return ndtr(x)


def _norm_ppf(u: np.ndarray) -> np.ndarray:
    from scipy.special import ndtri

    return ndtri(u)


def augment_dataset(
    ds: TextDataset,
    method: str = "shuffle",
    factor: float = 0.5,
    seed: int = 42,
) -> TextDataset:
    """Return ``ds`` with ``factor * n_train`` synthetic rows appended to the
    train split (class-balanced over the original label distribution)."""
    if method not in METHODS:
        raise ValueError(f"unknown augmentation {method!r}; have {METHODS}")
    rng = np.random.default_rng(seed)
    n_new = int(ds.n_train * factor)
    by_class: Dict[int, List[str]] = defaultdict(list)
    for t, y in zip(ds.train_texts, ds.train_labels):
        by_class[int(y)].append(t)
    labels = list(by_class)
    probs = np.array([len(by_class[c]) for c in labels], np.float64)
    probs = probs / probs.sum()

    new_texts: List[str] = []
    new_labels: List[int] = []
    draw = rng.choice(len(labels), size=n_new, p=probs)
    per_class = defaultdict(int)
    for d in draw:
        per_class[labels[d]] += 1

    for c, cnt in per_class.items():
        src = by_class[c]
        if method == "shuffle":
            picks = rng.choice(len(src), size=cnt)
            new_texts.extend(shuffle_texts([src[i] for i in picks], rng))
        elif method == "markov":
            starts, trans, lengths = _markov_tables(src)
            if not starts:
                continue
            new_texts.extend(
                _sample_markov(starts, trans, lengths, rng) for _ in range(cnt))
        else:  # copula
            new_texts.extend(_copula_sample(src, cnt, rng))
        new_labels.extend([c] * cnt)

    return dataclasses.replace(
        ds,
        name=f"{ds.name}+{method}",
        train_texts=list(ds.train_texts) + new_texts,
        train_labels=np.concatenate(
            [ds.train_labels,
             np.asarray(new_labels, ds.train_labels.dtype)]),
    )
