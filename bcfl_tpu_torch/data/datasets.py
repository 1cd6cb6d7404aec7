"""Dataset registry: port of ``bcfl_tpu/data/datasets.py`` (``synthetic``,
``csv:`` and ``medical_transcriptions``; the hub datasets are not ported
yet).

- ``synthetic``: the class-correlated unigram corpus, drawn with the same
  ``numpy`` generator calls as the JAX package, so the texts are identical;
- ``csv:<train.csv>`` (deterministic holdout) or
  ``csv:<train.csv>::<test.csv>``, columns from the config's
  ``text_col``/``label_col``;
- ``medical_transcriptions``: ``train_file_mt.csv`` / ``test_file_mt.csv``
  (``description`` -> ``medical_specialty``) under ``data_dir`` — by
  default ``$BCFL_DATASET_DIR`` or ``./Dataset`` (the reference
  repository's folder); without them, a deterministic synthetic stand-in
  with 40 labels.

CSV files are read with the standard library (no pandas); a label column
is typed as pandas would type it (int, integral float, else strings) so the
label mapping matches the JAX loader's.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class TextDataset:
    name: str
    train_texts: List[str]
    train_labels: np.ndarray  # int32 [N]
    test_texts: List[str]
    test_labels: np.ndarray
    num_labels: int

    @property
    def n_train(self) -> int:
        return len(self.train_texts)

    @property
    def n_test(self) -> int:
        return len(self.test_texts)


_REGISTRY: Dict[str, Callable[..., TextDataset]] = {}


def register_dataset(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def load_dataset(name: str, **kw) -> TextDataset:
    if name.startswith("csv:"):
        return _load_csv_spec(name[4:], **kw)
    if name in _REGISTRY:
        kw.pop("text_col", None)
        kw.pop("label_col", None)
        return _REGISTRY[name](**kw)
    raise ValueError(f"dataset={name!r} is not ported yet (ported: "
                     f"{sorted(_REGISTRY)} and csv:<path>)")


def _map_labels(raw, lut: Optional[Dict[str, int]] = None) -> tuple:
    """Raw label column -> (int32 array, num_labels, lut), as the JAX
    ``_map_labels``: ints pass through, integral floats become ints, strings
    map by sorted unique value."""
    arr = np.asarray(raw)
    if arr.dtype.kind in "iu":
        labels = arr.astype(np.int32)
        return labels, int(labels.max()) + 1, None
    if arr.dtype.kind == "f":
        if np.isnan(arr).any():
            raise ValueError("label column contains NaN/missing values")
        if not (arr == np.round(arr)).all():
            raise ValueError(
                "label column is float with non-integral values; map your "
                "labels to ints or strings explicitly")
        labels = arr.astype(np.int32)
        return labels, int(labels.max()) + 1, None
    if arr.dtype.kind not in "OUS":
        raise ValueError(f"unsupported label dtype {arr.dtype}")
    if lut is None:
        values = sorted({str(v) for v in arr})
        lut = {v: i for i, v in enumerate(values)}
    try:
        mapped = [lut[str(v)] for v in arr]
    except KeyError as e:
        raise ValueError(f"label {e.args[0]!r} not in mapping {sorted(lut)}")
    return np.asarray(mapped, np.int32), len(lut), lut


def _holdout_split(texts, labels, test_frac: float, seed: int):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(texts))
    n_test = max(int(len(texts) * test_frac), 1)
    te, tr = idx[:n_test], idx[n_test:]
    return ([texts[i] for i in tr], labels[tr],
            [texts[i] for i in te], labels[te])


def _typed_column(cells: List[str]) -> list:
    """Type a CSV column the way pandas infers it: all ints -> ints, all
    numbers (empty = NaN) -> floats, otherwise strings."""
    try:
        return [int(c) for c in cells]
    except ValueError:
        pass
    try:
        return [float(c) if c.strip() else float("nan") for c in cells]
    except ValueError:
        return list(cells)


def _read_raw_csv(path: str, text_col: str, label_col: str):
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.DictReader(f)
        cols = reader.fieldnames or []
        for col in (text_col, label_col):
            if col not in cols:
                raise ValueError(
                    f"{path}: column {col!r} not found; have {cols}")
        rows = list(reader)
    # pandas reads an empty text cell as NaN and .astype(str) makes it "nan"
    texts = [r[text_col] if r[text_col] != "" else "nan" for r in rows]
    return texts, _typed_column([r[label_col] for r in rows])


def _load_csv_spec(spec: str, text_col: str = "text", label_col: str = "label",
                   num_labels: int = 0, test_frac: float = 0.2,
                   seed: int = 42, **_) -> TextDataset:
    parts = spec.split("::")
    tr_t, tr_raw = _read_raw_csv(parts[0], text_col, label_col)
    if len(parts) > 1:
        te_t, te_raw = _read_raw_csv(parts[1], text_col, label_col)
        labels, n, _ = _map_labels(_typed_column(
            [str(v) for v in list(tr_raw) + list(te_raw)]))
        tr_y, te_y = labels[:len(tr_t)], labels[len(tr_t):]
    else:
        labels, n, _ = _map_labels(tr_raw)
        tr_t, tr_y, te_t, te_y = _holdout_split(tr_t, labels, test_frac, seed)
    name = "csv:" + os.path.basename(parts[0])
    return TextDataset(name, tr_t, tr_y, te_t, te_y, max(n, num_labels))


# ------------------------------------------------------------ synthetic corpus

_WORDS = [
    "alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf", "hotel",
    "india", "juliet", "kilo", "lima", "mike", "november", "oscar", "papa",
    "quebec", "romeo", "sierra", "tango", "uniform", "victor", "whiskey",
    "xray", "yankee", "zulu", "amber", "birch", "cedar", "dune", "ember",
    "fjord", "grove", "harbor", "isle", "jade", "krill", "lagoon", "mesa",
    "nectar", "onyx", "prairie", "quartz", "reef", "summit", "tundra",
    "umbra", "vale", "willow", "zenith",
]


def _synthetic_split(rng: np.random.Generator, n: int, num_labels: int,
                     doc_len: int):
    texts, labels = [], np.empty((n,), dtype=np.int32)
    n_words = len(_WORDS)
    for i in range(n):
        y = int(rng.integers(num_labels))
        labels[i] = y
        band = [_WORDS[(y * 7 + j) % n_words]
                for j in rng.integers(0, 12, size=doc_len).tolist()]
        noise = [_WORDS[int(k)]
                 for k in rng.integers(0, n_words, size=doc_len).tolist()]
        pick = rng.random(doc_len) < 0.6
        texts.append(" ".join(b if p else m
                              for b, m, p in zip(band, noise, pick)))
    return texts, labels


@register_dataset("synthetic")
def _synthetic(num_labels: int = 2, n_train: int = 4096, n_test: int = 1024,
               doc_len: int = 32, seed: int = 42, name: str = "synthetic",
               **_) -> TextDataset:
    rng = np.random.default_rng(seed)
    tr_t, tr_y = _synthetic_split(rng, n_train, num_labels, doc_len)
    te_t, te_y = _synthetic_split(rng, n_test, num_labels, doc_len)
    return TextDataset(name, tr_t, tr_y, te_t, te_y, num_labels)


def default_data_dir() -> str:
    return os.environ.get("BCFL_DATASET_DIR", "Dataset")


@register_dataset("medical_transcriptions")
def _medical(data_dir: Optional[str] = None, num_labels: int = 40,
             **_) -> TextDataset:
    data_dir = default_data_dir() if data_dir is None else data_dir
    tr = os.path.join(data_dir, "train_file_mt.csv")
    te = os.path.join(data_dir, "test_file_mt.csv")
    if not (os.path.exists(tr) and os.path.exists(te)):
        return _synthetic(num_labels=num_labels, name="medical_transcriptions")
    tr_t, tr_raw = _read_raw_csv(tr, "description", "medical_specialty")
    te_t, te_raw = _read_raw_csv(te, "description", "medical_specialty")
    labels, n, _ = _map_labels(list(tr_raw) + list(te_raw))
    tr_y, te_y = labels[:len(tr_t)], labels[len(tr_t):]
    return TextDataset("medical_transcriptions", tr_t, tr_y, te_t, te_y,
                       max(n, num_labels))
