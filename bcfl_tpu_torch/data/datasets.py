"""Dataset registry: port of ``bcfl_tpu/data/datasets.py``.

- ``synthetic``: the class-correlated unigram corpus, drawn with the same
  ``numpy`` generator calls as the JAX package, so the texts are identical;
- ``csv:<train.csv>`` (deterministic holdout) or
  ``csv:<train.csv>::<test.csv>``, columns from the config's
  ``text_col``/``label_col``;
- ``medical_transcriptions``: ``train_file_mt.csv`` / ``test_file_mt.csv``
  (``description`` -> ``medical_specialty``) under ``data_dir`` — by
  default ``$BCFL_DATASET_DIR`` or ``./Dataset`` (the reference
  repository's folder); without them, a deterministic synthetic stand-in
  with 40 labels;
- ``self_driving_sentiment`` (``Text`` -> ``Sentiment``) under the same
  ``data_dir``, with the ``+ctgan``/``+copula``/``+shuffle`` variants that
  append the reference's augmentation CSVs to the train split; without the
  base file, a synthetic stand-in named ``...:synthetic-standin``;
- ``imdb``, ``cancer``, ``covid`` and any other name: the HF hub through
  ``datasets.load_dataset`` (imported when called); offline, or where the
  library is absent, a warning and a deterministic synthetic stand-in with
  the same label space, named ``<alias>:synthetic-standin``.

``name+variant`` selects a loader's augmentation variant.

CSV files are read with the standard library (no pandas), by pandas'
default ``read_csv`` rules (:func:`_read_raw_csv`), so the texts and the
label mapping are the JAX loader's.
"""

from __future__ import annotations

import csv
import dataclasses
import inspect
import os
import re
import warnings
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
    # "name+variant" selects a loader's augmentation variant (e.g.
    # "self_driving_sentiment+ctgan"); only loaders that declare an
    # ``augmented`` parameter accept one
    base, plus, variant = name.partition("+")
    if plus and not variant:
        raise ValueError(f"dataset name {name!r} has a trailing '+' with no "
                         "variant")
    if base in _REGISTRY:
        # registry datasets own their column mappings; the config's
        # text_col/label_col apply to csv: and hub datasets only
        kw.pop("text_col", None)
        kw.pop("label_col", None)
        if variant:
            if "augmented" in kw:
                raise ValueError(
                    f"dataset {name!r} has a +variant suffix AND an explicit "
                    f"augmented={kw['augmented']!r} kwarg; pass one or the "
                    "other")
            params = inspect.signature(_REGISTRY[base]).parameters
            if "augmented" not in params:
                raise ValueError(
                    f"dataset {base!r} has no augmentation variants "
                    f"(got {name!r})")
            kw["augmented"] = variant
        return _REGISTRY[base](**kw)
    return _load_hf(name, **kw)


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


#: pandas' default missing-value tokens (``read_csv``'s ``na_values``)
NA_TOKENS = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))
_SPACE = " \t\n\r\f\v"  # what pandas' number parser skips around a number
_INT = re.compile(r"[+-]?[0-9]+")
_FLOAT = re.compile(r"[+-]?(?:(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:e[+-]?[0-9]+)?"
                    r"|inf(?:inity)?)", re.IGNORECASE)
_BOOL = {"true": True, "false": False}  # case-insensitive, as pandas


def _typed_column(cells: List[Optional[str]]) -> list:
    """Type a CSV column the way ``pd.read_csv`` infers it and return its
    ``tolist()``: a missing cell (``None``, or one of :data:`NA_TOKENS`)
    is ``nan``; all integers -> ints (floats when any cell is missing);
    all numbers -> floats (``inf``/``infinity`` of any case included);
    all ``true``/``false`` of any case -> bools (``nan`` where missing);
    anything else stays strings (``nan`` where missing)."""
    na = [c is None or c in NA_TOKENS for c in cells]
    raw = [c for c, m in zip(cells, na) if not m]
    nums = [c.strip(_SPACE) for c in raw]
    missing = any(na)

    def fill(values):
        it = iter(values)
        return [float("nan") if m else next(it) for m in na]

    if all(_INT.fullmatch(c) for c in nums):
        return fill(float(int(c)) if missing else int(c) for c in nums)
    if all(_FLOAT.fullmatch(c) for c in nums):
        return fill(float(c) for c in nums)
    if raw and all(c.lower() in _BOOL for c in raw):
        return fill(_BOOL[c.lower()] for c in raw)
    return fill(raw)


def _read_raw_csv(path: str, text_col: str, label_col: str):
    """``pd.read_csv(path)`` then ``df[text_col].astype(str).tolist()`` and
    ``df[label_col].tolist()``, by pandas' default rules: its missing-value
    tokens and its int / float / bool / string inference per column
    (:func:`_typed_column`). Quoting is the ``csv`` module's; blank lines
    are skipped and a short row's missing cells are missing values, as in
    pandas."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        reader = csv.DictReader(f)
        cols = reader.fieldnames or []
        for col in (text_col, label_col):
            if col not in cols:
                raise ValueError(
                    f"{path}: column {col!r} not found; have {cols}")
        rows = list(reader)
    # .astype(str): repr of a float, "nan" for a missing cell (pandas 2's
    # rule; pandas 3 keeps a float NaN, which the tokenizer cannot lower)
    texts = [str(v) for v in _typed_column([r[text_col] for r in rows])]
    return texts, _typed_column([r[label_col] for r in rows])


def _load_csv_spec(spec: str, text_col: str = "text", label_col: str = "label",
                   num_labels: int = 0, test_frac: float = 0.2,
                   seed: int = 42, **_) -> TextDataset:
    parts = spec.split("::")
    tr_t, tr_raw = _read_raw_csv(parts[0], text_col, label_col)
    if len(parts) > 1:
        te_t, te_raw = _read_raw_csv(parts[1], text_col, label_col)
        labels, n, _ = _map_labels(list(tr_raw) + list(te_raw))
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


@register_dataset("imdb")
def _imdb(num_labels: int = 2, **kw) -> TextDataset:
    """HF-hub ``imdb`` (the reference's ``server_IID_IMDB.py:66``)."""
    return _load_hf_or_synthetic("imdb", text_col="text", label_col="label",
                                 num_labels=num_labels, **kw)


@register_dataset("cancer")
def _cancer(num_labels: int = 41, **kw) -> TextDataset:
    """``bhargavi909/cancer_classification``, ``input`` -> ``label``."""
    return _load_hf_or_synthetic(
        "bhargavi909/cancer_classification", text_col="input",
        label_col="label", num_labels=num_labels, alias="cancer", **kw)


@register_dataset("covid")
def _covid(num_labels: int = 41, **kw) -> TextDataset:
    """``bhargavi909/covid_final``, ``text`` -> ``sentiment``."""
    return _load_hf_or_synthetic(
        "bhargavi909/covid_final", text_col="text", label_col="sentiment",
        num_labels=num_labels, alias="covid", **kw)


#: the reference's augmentation CSVs, under ``data_dir``
_SELF_DRIVING_AUGMENTED = {
    "ctgan": "Augmeted_datasets/CTGAN_self_driving_vehicles.csv",
    "copula": "Augmeted_datasets/output_Gaussiancopula_self_driving.csv",
    "shuffle": "Augmeted_datasets/output_file_path_random_counts.csv",
}


@register_dataset("self_driving_sentiment")
def _self_driving(data_dir: Optional[str] = None, num_labels: int = 3,
                  augmented: Optional[str] = None, test_frac: float = 0.2,
                  seed: int = 42, **_) -> TextDataset:
    """``sentiment_analysis_self_driving_vehicles.csv`` (``Text`` ->
    ``Sentiment``). ``augmented`` (``ctgan``/``copula``/``shuffle``)
    APPENDS that augmentation file to the train split, mapped with the base
    file's classes; the holdout test split always comes from the real
    rows."""
    if augmented is not None and augmented not in _SELF_DRIVING_AUGMENTED:
        raise ValueError(f"unknown augmentation {augmented!r}; have "
                         f"{sorted(_SELF_DRIVING_AUGMENTED)}")
    data_dir = default_data_dir() if data_dir is None else data_dir
    variant = f"+{augmented}" if augmented else ""
    base = os.path.join(data_dir,
                        "sentiment_analysis_self_driving_vehicles.csv")
    if not os.path.exists(base):
        warnings.warn(
            f"{base} not found; using a deterministic synthetic stand-in",
            stacklevel=2)
        return _synthetic(
            num_labels=num_labels, seed=seed,
            name=f"self_driving_sentiment{variant}:synthetic-standin")
    texts, raw = _read_raw_csv(base, "Text", "Sentiment")
    labels, n, lut = _map_labels(raw)
    tr_t, tr_y, te_t, te_y = _holdout_split(texts, labels, test_frac, seed)
    if augmented is not None:
        aug_t, aug_raw = _read_raw_csv(
            os.path.join(data_dir, _SELF_DRIVING_AUGMENTED[augmented]),
            "Text", "Sentiment")
        aug_y, _, _ = _map_labels(aug_raw, lut)
        tr_t = tr_t + aug_t
        tr_y = np.concatenate([tr_y, aug_y]).astype(np.int32)
    return TextDataset(f"self_driving_sentiment{variant}",
                       tr_t, tr_y, te_t, te_y, max(n, num_labels))


def _load_hf(name: str, text_col: str = "text", label_col: str = "label",
             num_labels: int = 2, alias: Optional[str] = None,
             seed: int = 42) -> TextDataset:
    """``datasets.load_dataset(name)`` (a hub name or a local directory of
    data files): the ``train`` split and ``test`` (or ``train`` again),
    the columns resolved against what exists (``text``/``sentence``,
    ``label``/``labels``), one label mapping over both splits."""
    import datasets as hf_datasets

    ds = hf_datasets.load_dataset(name)
    train, test = ds["train"], ds.get("test", ds["train"])

    def resolve(col, alts):
        if col in train.column_names:
            return col
        for a in alts:
            if a in train.column_names:
                return a
        raise ValueError(
            f"{name}: column {col!r} not found; have {train.column_names}")

    text_col = resolve(text_col, ("text", "sentence"))
    label_col = resolve(label_col, ("label", "labels"))
    tr_y, _, lut = _map_labels(train[label_col])
    te_y, _, _ = _map_labels(test[label_col], lut)
    n = int(max(tr_y.max(), te_y.max())) + 1
    return TextDataset(alias or name, list(train[text_col]), tr_y,
                       list(test[text_col]), te_y, max(n, num_labels))


def _load_hf_or_synthetic(name: str, *, text_col: str, label_col: str,
                          num_labels: int, alias: Optional[str] = None,
                          seed: int = 42, **_) -> TextDataset:
    try:
        return _load_hf(name, text_col=text_col, label_col=label_col,
                        num_labels=num_labels, alias=alias, seed=seed)
    except Exception as e:  # noqa: BLE001 — offline, or no datasets library
        # the name carries the stand-in marker, so a run never reports a
        # hub dataset's accuracy on filler text
        warnings.warn(
            f"could not load HF dataset {name!r} ({type(e).__name__}: {e}); "
            "using a deterministic synthetic stand-in with the same label "
            "space", stacklevel=2)
        return _synthetic(num_labels=num_labels, seed=seed,
                          name=f"{alias or name}:synthetic-standin")
