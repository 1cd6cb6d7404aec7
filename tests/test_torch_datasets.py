"""PyTorch port (``bcfl_tpu_torch``): the dataset registry and the
augmentation module against the JAX package, on the CPU, exactly.

- the CSV reader follows ``pd.read_csv`` + ``.astype(str)`` (JAX's
  ``_read_raw_csv``) without pandas: pandas' missing-value tokens, its
  int / float / bool / string inference, ``repr`` of a float; a missing
  text cell reads ``"nan"`` where JAX under pandas 3 keeps a float NaN
  (the port keeps pandas 2's rule, ROADMAP.md §3), so JAX's NaN is
  compared as ``"nan"``;
- a numeric label column with a missing cell raises in both packages; a
  string label column maps the missing cell to the class ``"nan"`` in
  both (``np.asarray`` of a string list with a float NaN);
- the hub datasets (``imdb``, ``cancer``, ``covid``) offline (the
  libraries' offline mode on, and no request possible: ``load_dataset`` of
  a hub name raises as offline): the stand-in's name, texts and labels,
  and every preset's dataset;
- ``_load_hf`` on a local directory of CSVs this test writes;
- ``self_driving_sentiment`` and its ``+ctgan``/``+copula``/``+shuffle``
  variants on CSVs this test writes, and the ``name+variant`` errors;
- ``augment_dataset``: every method, two seeds, the same texts and labels.
"""

import csv
import math
import os
import warnings

import numpy as np
import pytest

from bcfl_tpu.data import augment as jaug
from bcfl_tpu.data import datasets as jds
from bcfl_tpu_torch.data import augment as taug
from bcfl_tpu_torch.data import datasets as tds


@pytest.fixture(autouse=True)
def _offline(monkeypatch):
    """No hub, whatever imported ``datasets`` first in this process (its
    offline flag is read at import): offline mode on in the libraries'
    constants, and ``datasets.load_dataset`` of anything but a local
    directory raises before any request, as it does offline, so both
    packages' hub loaders take their stand-ins."""
    import datasets
    import huggingface_hub.constants as hub_constants

    monkeypatch.setenv("HF_DATASETS_OFFLINE", "1")
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(datasets.config, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(datasets.config, "HF_DATASETS_OFFLINE", True)
    monkeypatch.setattr(hub_constants, "HF_HUB_OFFLINE", True)
    real = datasets.load_dataset

    def local_only(path, *args, **kwargs):
        if not os.path.isdir(path):
            raise ConnectionError(f"offline: {path!r} is not a local "
                                  "directory")
        return real(path, *args, **kwargs)

    monkeypatch.setattr(datasets, "load_dataset", local_only)
    warnings.simplefilter("ignore")


def _write(path, header, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)
    return str(path)


def _jax_texts(texts):
    """JAX's texts under pandas 3 keep a missing cell as a float NaN; the
    port reads it as pandas 2 did, ``"nan"``."""
    return [("nan" if isinstance(t, float) and math.isnan(t) else t)
            for t in texts]


def _same_cells(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, float) and math.isnan(w):
            assert isinstance(g, float) and math.isnan(g), (g, w)
        else:
            assert g == w and type(g) is type(w), (g, w)


def _same_dataset(t, j):
    assert t.name == j.name
    assert t.train_texts == _jax_texts(j.train_texts)
    assert t.test_texts == _jax_texts(j.test_texts)
    np.testing.assert_array_equal(t.train_labels, j.train_labels)
    np.testing.assert_array_equal(t.test_labels, j.test_labels)
    assert t.train_labels.dtype == j.train_labels.dtype
    assert t.num_labels == j.num_labels


# ------------------------------------------------------------- CSV reader

# one kind of column each, read both as the text and as the label column
COLUMNS = {
    "na-tokens": ["NA", "null", "None", "N/A", "True", "#N/A", "n/a",
                  "plain"],
    "numeric": ["1.50", "7", "", "2", "0.1", "1e20", "-0.0", ".5"],
    "all-na-tokens": sorted(tds.NA_TOKENS),
    "ints": ["1", "+5", "-5", "007", " 7", "7 ", "\t3", "-0"],
    "ints-missing": ["1", "NaN", "9007199254740993", "2"],
    "big-ints": ["9223372036854775808", "1"],
    "huge-ints": ["18446744073709551616", "1"],
    "floats-inf": ["1e3", "inf", "-Infinity", "+inf", "1.", "1e-400",
                   "1e400", "nan"],
    "not-numbers": ["1", "NAN", "0x10", "1_000", "1,5", "1.5e", "  ", "e5"],
    "bools": ["True", "false", "TRUE", "tRue"],
    "bools-missing": ["True", "NA", "False"],
    "bools-and-ints": ["True", "1"],
    "all-missing": ["", "NA", "null"],
    "strings": ["a note, with a comma", 'say "hi"', " padded ", "", "x"],
}


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_csv_reader_matches_pandas_rules(tmp_path, name):
    cells = COLUMNS[name]
    path = _write(tmp_path / "f.csv", ["text", "label"],
                  [(c, c) for c in cells])
    t_texts, t_raw = tds._read_raw_csv(path, "text", "label")
    j_texts, j_raw = jds._read_raw_csv(path, "text", "label")
    assert t_texts == _jax_texts(j_texts)
    _same_cells(t_raw, j_raw)


def test_csv_reader_na_tokens_and_numbers(tmp_path):
    """pandas' NA tokens and numeric inference, spelled out, with a
    missing numeric cell read as ``"nan"``."""
    path = _write(tmp_path / "f.csv", ["text", "num"],
                  zip(COLUMNS["na-tokens"], COLUMNS["numeric"]))
    texts, _ = tds._read_raw_csv(path, "text", "num")
    assert texts == ["nan"] * 4 + ["True", "nan", "nan", "plain"]
    nums, _ = tds._read_raw_csv(path, "num", "text")
    assert nums == ["1.5", "7.0", "nan", "2.0", "0.1", "1e+20", "-0.0",
                    "0.5"]


def test_csv_labels_missing_cell(tmp_path):
    """A numeric label column with a missing cell raises as JAX's does; a
    string one maps the missing cell to the class ``"nan"``, as JAX's."""
    num = _write(tmp_path / "num.csv", ["text", "label"],
                 [("a", "1"), ("b", ""), ("c", "2"), ("d", "1")])
    errs = []
    for mod in (tds, jds):
        with pytest.raises(ValueError) as e:
            mod.load_dataset(f"csv:{num}")
        errs.append(str(e.value))
    assert errs[0] == errs[1] and "NaN" in errs[0]
    txt = _write(tmp_path / "txt.csv", ["text", "label"],
                 [("a", "cardio"), ("b", "NA"), ("c", "neuro"),
                  ("NA", "cardio"), ("e", "neuro")])
    spec = f"csv:{txt}::{txt}"
    _same_dataset(tds.load_dataset(spec), jds.load_dataset(spec))
    assert tds.load_dataset(spec).num_labels == 3


# ------------------------------------------------------------ hub datasets


@pytest.mark.parametrize("name", ["imdb", "cancer", "covid"])
def test_hub_standins_match_jax(name):
    t, j = tds.load_dataset(name), jds.load_dataset(name)
    assert t.name == f"{name}:synthetic-standin"
    _same_dataset(t, j)


def _presets():
    from bcfl_tpu_torch.entrypoints.presets import list_presets

    return list_presets()


@pytest.mark.parametrize("preset", _presets())
def test_every_preset_dataset_loads_as_in_jax(preset, tmp_path):
    from bcfl_tpu.entrypoints.presets import get_preset as jget
    from bcfl_tpu_torch.entrypoints.presets import get_preset as tget

    cfg, jcfg = tget(preset), jget(preset)
    assert (cfg.dataset, cfg.num_labels, cfg.text_col, cfg.label_col) == (
        jcfg.dataset, jcfg.num_labels, jcfg.text_col, jcfg.label_col)
    # data_dir: the medical CSVs are not here, so both take the stand-in
    kw = dict(num_labels=cfg.num_labels, text_col=cfg.text_col,
              label_col=cfg.label_col, data_dir=str(tmp_path / "absent"))
    _same_dataset(tds.load_dataset(cfg.dataset, **kw),
                  jds.load_dataset(jcfg.dataset, **kw))


def test_load_hf_reads_a_local_directory(tmp_path, monkeypatch):
    import datasets

    monkeypatch.setattr(datasets.config, "HF_DATASETS_CACHE",
                        str(tmp_path / "cache"))
    d = tmp_path / "hub"
    d.mkdir()
    rng = np.random.default_rng(0)
    words = ["alpha", "beta", "gamma", "delta", "NA"]
    for split, n in (("train", 9), ("test", 4)):
        _write(d / f"{split}.csv", ["sentence", "labels", "other"],
               [(" ".join(rng.choice(words, 3)), ["neg", "pos", "mid"][i % 3],
                 i) for i in range(n)])
    for kw in ({}, {"alias": "mine", "num_labels": 5},
               {"text_col": "sentence", "label_col": "labels"}):
        _same_dataset(tds._load_hf(str(d), **kw), jds._load_hf(str(d), **kw))
    # neither the named column nor an alternative: the same error
    d2 = tmp_path / "hub2"
    d2.mkdir()
    _write(d2 / "train.csv", ["body", "y"], [("x y", 0), ("z", 1)])
    errs = []
    for mod in (tds, jds):
        with pytest.raises(ValueError) as e:
            mod._load_hf(str(d2))
        errs.append(str(e.value))
    assert errs[0] == errs[1] and "not found" in errs[0]


# ------------------------------------------------------------ self-driving


def _self_driving_dir(tmp_path):
    rng = np.random.default_rng(3)
    words = ["car", "road", "safe", "scary", "fast", "brake", "lane"]
    classes = ["Negative", "Neutral", "Positive"]

    def rows(n):
        return [(" ".join(rng.choice(words, int(rng.integers(2, 8)))),
                 classes[int(rng.integers(3))]) for _ in range(n)]

    _write(tmp_path / "sentiment_analysis_self_driving_vehicles.csv",
           ["Text", "Sentiment"], rows(40))
    aug = tmp_path / "Augmeted_datasets"
    aug.mkdir()
    for i, f in enumerate(("CTGAN_self_driving_vehicles.csv",
                           "output_Gaussiancopula_self_driving.csv",
                           "output_file_path_random_counts.csv")):
        _write(aug / f, ["Text", "Sentiment"], rows(10 + 3 * i))
    return str(tmp_path)


@pytest.mark.parametrize("variant", ["", "+ctgan", "+copula", "+shuffle"])
def test_self_driving_variants_match_jax(tmp_path, variant):
    d = _self_driving_dir(tmp_path)
    name = f"self_driving_sentiment{variant}"
    t, j = (tds.load_dataset(name, data_dir=d),
            jds.load_dataset(name, data_dir=d))
    assert t.name == name
    _same_dataset(t, j)
    # without the files: the stand-in, named so
    t, j = (tds.load_dataset(name, data_dir=str(tmp_path / "absent")),
            jds.load_dataset(name, data_dir=str(tmp_path / "absent")))
    assert t.name == f"{name}:synthetic-standin"
    _same_dataset(t, j)


@pytest.mark.parametrize("name,kw", [
    ("self_driving_sentiment+gan", {}),
    ("self_driving_sentiment+", {}),
    ("synthetic+ctgan", {}),
    ("self_driving_sentiment+ctgan", {"augmented": "copula"}),
])
def test_variant_errors_match_jax(tmp_path, name, kw):
    kw = dict(kw, data_dir=_self_driving_dir(tmp_path))
    if name.startswith("synthetic"):
        kw.pop("data_dir")
    errs = []
    for mod in (tds, jds):
        with pytest.raises(ValueError) as e:
            mod.load_dataset(name, **kw)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


# ------------------------------------------------------------ augmentation


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("method", ["shuffle", "markov", "copula"])
def test_augment_dataset_matches_jax(method, seed):
    kw = dict(num_labels=3, n_train=60, n_test=10, doc_len=12, seed=seed)
    t = taug.augment_dataset(tds.load_dataset("synthetic", **kw), method,
                             factor=0.5, seed=seed)
    j = jaug.augment_dataset(jds.load_dataset("synthetic", **kw), method,
                             factor=0.5, seed=seed)
    assert t.n_train > 60 and t.name == f"synthetic+{method}"
    _same_dataset(t, j)
    with pytest.raises(ValueError, match="unknown augmentation"):
        taug.augment_dataset(t, "gan")
