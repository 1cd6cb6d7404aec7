"""The port's native C++ cores (``bcfl_tpu_torch/native``) against hashlib,
the Python tokenizer and the JAX package's own cores.

The port builds its copies of ``sha256.cc`` and ``tokenizer.cc`` with g++
into ``build/bcfl_tpu_torch/native/`` (never the package directory, and
never the JAX package's shipped libraries); digests and token ids must be
bit for bit those of hashlib, the Python loop and ``bcfl_tpu``'s native
functions, with the core on or off.
"""

import ctypes
import hashlib
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from bcfl_tpu.data.tokenizer import HashTokenizer as JHash
from bcfl_tpu.ledger import ledger as jledger
from bcfl_tpu_torch import native
from bcfl_tpu_torch.data import tokenizer as ttok
from bcfl_tpu_torch.ledger import ledger as tledger
from bcfl_tpu_torch.native import build

REPO = Path(__file__).resolve().parents[1]

CORPUS = [
    "",
    " ",
    "the quick brown fox",
    "The QUICK Brown FOX!!",
    "don't stop-me now; it's 2024...",
    "tabs\tnewlines\nand\r\nmore",
    "unicode éÉ ß İ straße ẞ",
    "cjk 世界 and emoji \U0001f600\U0001f680",
    "unicode spaces a b c　d",
    "x" * 5000,
    ("word " * 600).strip(),
]


def test_cores_build_from_the_ports_sources_into_build_dir():
    st = native.status()
    assert st == {"ledger": "native", "tokenizer": "native"}
    for src, lib in (("sha256.cc", native.load_ledger_lib()),
                     ("tokenizer.cc", native.load_tokenizer_lib())):
        path = Path(lib._name).resolve()
        assert path.parent == build.BUILD_DIR.resolve()
        assert path.parent == REPO / "build" / "bcfl_tpu_torch" / "native"
        # named by a hash of the port's own source: an edit rebuilds
        assert path == build._lib_path(build.SRC_DIR / src).resolve()
        assert "bcfl_tpu/native" not in str(path)


def test_concurrent_builds_each_load_a_whole_library(tmp_path, monkeypatch):
    """Workers and peer processes race to build: each writes its own
    temporary file and renames it into place."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    src = build.SRC_DIR / "sha256.cc"
    out = build._lib_path(src)
    errors = []
    threads = [threading.Thread(target=lambda: errors.append(
        build._compile(src, out))) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == [None] * 4
    assert [p.name for p in tmp_path.iterdir()] == [out.name]
    lib = ctypes.CDLL(str(out))
    build._configure_ledger(lib)
    buf = ctypes.create_string_buffer(32)
    lib.bcfl_chain_extend(b"\x00" * 32, b"abc", 3, buf)
    assert buf.raw == hashlib.sha256(b"\x00" * 32 + b"abc").digest()


def test_missing_toolchain_takes_the_python_path(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    assert build._compile(build.SRC_DIR / "sha256.cc",
                          Path("/nonexistent/x.so")) == "no g++ on PATH"


@pytest.mark.parametrize("n", [0, 1, 55, 56, 64, 1000])
def test_chain_extend_equals_hashlib_and_jax(n):
    rng = np.random.default_rng(n)
    prev = rng.bytes(32)
    payload = rng.bytes(n)
    want = hashlib.sha256(prev + payload).digest()
    assert tledger.chain_extend(prev, payload, use_native=True) == want
    assert tledger.chain_extend(prev, payload, use_native=False) == want
    assert jledger.chain_extend(prev, payload, use_native=True) == want


def _trees(seed):
    rng = np.random.default_rng(seed)
    j = {"emb": rng.normal(size=(7, 3)).astype(np.float32),
         "layer_0": {"kernel": rng.normal(size=(3, 4)).astype(np.float32),
                     "bias": rng.integers(-5, 5, 4).astype(np.int32)},
         "codes": rng.integers(-127, 128, (2, 9)).astype(np.int8)}
    t = {"emb": torch.from_numpy(j["emb"]),
         "layer_0": {"kernel": torch.from_numpy(j["layer_0"]["kernel"]),
                     "bias": torch.from_numpy(j["layer_0"]["bias"])},
         "codes": torch.from_numpy(j["codes"])}
    return j, t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_params_digest_native_equals_hashlib_and_jax(seed):
    j, t = _trees(seed)
    want = jledger.params_digest(j, use_native=False)
    assert jledger.params_digest(j, use_native=True) == want
    assert tledger.params_digest(t, use_native=True) == want
    assert tledger.params_digest(t, use_native=False) == want


@pytest.mark.parametrize("use_native", [True, False])
def test_chain_verify_and_segments_match_jax(use_native):
    rng = np.random.default_rng(3)
    tl, jl = tledger.Ledger(use_native), jledger.Ledger(use_native)
    for i in range(9):
        d = rng.bytes(32)
        tl.append_digest(i // 3, i % 3, d, 100 + i)
        jl.append_digest(i // 3, i % 3, d, 100 + i)
    assert tl.heads == jl.heads
    assert tl.verify_chain() == jl.verify_chain() == -1
    assert tl.segment(4) == jl.segment(4)
    assert tl.head_at(4) == jl.head_at(4)
    assert tledger.Ledger.verify_segment(tl.head_at(4), tl.segment(4),
                                         use_native) == -1
    # a replica catches up from a segment, verifying each link
    rep = tledger.Ledger(use_native)
    assert rep.append_rows(tl.segment(0)[:4]) == -1
    assert rep.append_rows(tl.segment(4)) == -1
    assert rep.heads == tl.heads
    # a tampered row fails at its index, in both packages
    bad = tl.segment(4)
    bad[2] = dict(bad[2], digest="00" * 32)
    assert (tledger.Ledger.verify_segment(tl.head_at(4), bad, use_native)
            == jledger.Ledger.verify_segment(jl.head_at(4), bad, use_native)
            == 2)
    rep2 = tledger.Ledger(use_native)
    assert rep2.append_rows(tl.segment(0)[:4] + bad) == 6
    assert len(rep2) == 6
    # a tampered head breaks verify_chain at its index
    tl.heads[5] = b"\x01" * 32
    jl.heads[5] = b"\x01" * 32
    assert tl.verify_chain() == jl.verify_chain() == 5


def _python_batch(tok, texts, seq_len):
    ids = np.empty((len(texts), seq_len), np.int32)
    mask = np.empty((len(texts), seq_len), np.int32)
    for i, t in enumerate(texts):
        ids[i], mask[i] = tok.encode(t, seq_len)
    return ids, mask


@pytest.mark.parametrize("seq_len", [1, 3, 16, 128])
@pytest.mark.parametrize("vocab", [5, 8192, 28996])
def test_native_ids_equal_python_and_jax(seq_len, vocab):
    tok = ttok.HashTokenizer(vocab)
    got = tok._encode_batch_native(CORPUS, seq_len)
    assert got is not None
    want = _python_batch(tok, CORPUS, seq_len)
    jax_native = JHash(vocab)._encode_batch_native(CORPUS, seq_len)
    for a, b, c in zip(got, want, jax_native):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    ids, mask = tok.encode_batch(CORPUS, seq_len)
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_array_equal(mask, want[1])


def test_tokenizer_without_the_core_gives_the_same_ids(monkeypatch):
    tok = ttok.HashTokenizer(8192)
    with_core = tok.encode_batch(CORPUS, 32)
    monkeypatch.setattr(ttok, "load_tokenizer_lib", lambda: None)
    without = tok.encode_batch(CORPUS, 32)
    for a, b in zip(with_core, without):
        np.testing.assert_array_equal(a, b)


def test_lone_surrogate_takes_the_python_loop():
    """A lone surrogate cannot cross as UTF-8: the core declines and the
    Python loop runs (which tokenizes it when the word lies past the
    seq_len - 2 cap), as in JAX."""
    tok = ttok.HashTokenizer(512)
    texts = ["a b c d e f \udcff", "plain"]
    assert tok._encode_batch_native(texts, 4) is None
    ids, mask = tok.encode_batch(texts, 4)
    want = _python_batch(tok, texts, 4)
    jids, jmask = JHash(512).encode_batch(texts, 4)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_array_equal(mask, want[1])
