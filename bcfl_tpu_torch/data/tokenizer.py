"""Tokenizers: port of ``bcfl_tpu/data/tokenizer.py``.

- :class:`HashTokenizer`: token id = crc32(word) % (vocab - 4) + 4 over
  lower-cased words; every text becomes a fixed ``[seq_len]`` row
  ``[CLS] words... [SEP]`` padded with 0, plus its 0/1 mask. Identical ids
  to the JAX package's tokenizer. :meth:`HashTokenizer.encode_batch` runs
  the C++ core (``native/tokenizer.cc``, built with g++ at first use) and
  falls back to the Python loop without a toolchain; both give the same
  ids.
- :class:`HFTokenizerAdapter`: a HF tokenizer (needs ``transformers``)
  behind the same fixed-shape interface, for checkpoint-faithful runs from
  a pretrained vocabulary already on disk.
"""

from __future__ import annotations

import ctypes
import re
import zlib
from typing import Sequence, Tuple

import numpy as np

from bcfl_tpu_torch.native.build import load_tokenizer_lib

PAD_ID = 0
UNK_ID = 1
CLS_ID = 2
SEP_ID = 3
N_SPECIAL = 4

_WORD_RE = re.compile(r"[a-z0-9']+|[^\sa-z0-9']")


class HashTokenizer:
    def __init__(self, vocab_size: int = 8192):
        if vocab_size <= N_SPECIAL:
            raise ValueError("vocab_size too small")
        self.vocab_size = vocab_size

    def _word_id(self, w: str) -> int:
        return (zlib.crc32(w.encode("utf-8")) % (self.vocab_size - N_SPECIAL)
                + N_SPECIAL)

    def encode(self, text: str, seq_len: int) -> Tuple[np.ndarray, np.ndarray]:
        words = _WORD_RE.findall(text.lower())
        ids = ([CLS_ID] + [self._word_id(w)
                           for w in words[: max(seq_len - 2, 0)]]
               + [SEP_ID])[:seq_len]
        n = len(ids)
        out = np.full((seq_len,), PAD_ID, dtype=np.int32)
        out[:n] = ids
        mask = np.zeros((seq_len,), dtype=np.int32)
        mask[:n] = 1
        return out, mask

    def encode_batch(self, texts: Sequence[str], seq_len: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        native = self._encode_batch_native(texts, seq_len)
        if native is not None:
            return native
        ids = np.empty((len(texts), seq_len), dtype=np.int32)
        mask = np.empty((len(texts), seq_len), dtype=np.int32)
        for i, t in enumerate(texts):
            ids[i], mask[i] = self.encode(t, seq_len)
        return ids, mask

    def _encode_batch_native(self, texts: Sequence[str], seq_len: int):
        """The C++ batch encoder, equal to :meth:`encode` id for id.
        Lower-casing stays here (Python's full Unicode case rules); the
        core gets the lowered UTF-8 bytes. None without a toolchain, or
        for a text that cannot cross as UTF-8 (lone surrogates), where the
        Python loop runs instead."""
        lib = load_tokenizer_lib()
        if lib is None or seq_len <= 0 or len(texts) == 0:
            return None
        try:
            blobs = [t.lower().encode("utf-8") for t in texts]
        except UnicodeEncodeError:
            return None
        offsets = np.zeros((len(blobs) + 1,), dtype=np.int64)
        np.cumsum([len(b) for b in blobs], out=offsets[1:])
        n = len(blobs)
        ids = np.empty((n, seq_len), dtype=np.int32)
        mask = np.empty((n, seq_len), dtype=np.int32)
        lib.bcfl_hash_tokenize(
            b"".join(blobs),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, seq_len, self.vocab_size,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return ids, mask


class HFTokenizerAdapter:
    """A HF tokenizer (``AutoTokenizer.from_pretrained``: a hub name or a
    directory holding its files) behind the fixed-shape interface:
    truncated and padded to ``seq_len``."""

    def __init__(self, name: str):
        from transformers import AutoTokenizer  # optional dependency

        self._tok = AutoTokenizer.from_pretrained(name)
        # len() counts added and special tokens, .vocab_size does not, and
        # ids can exceed it: size the embedding by len()
        self.vocab_size = len(self._tok)

    def encode_batch(self, texts: Sequence[str], seq_len: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        enc = self._tok(list(texts), truncation=True, max_length=seq_len,
                        padding="max_length", return_tensors="np")
        return (enc["input_ids"].astype(np.int32),
                enc["attention_mask"].astype(np.int32))


def get_tokenizer(name: str, vocab_size: int = 8192):
    """``"hash"`` -> :class:`HashTokenizer`; anything else names a HF
    tokenizer (:class:`HFTokenizerAdapter`)."""
    if name == "hash":
        return HashTokenizer(vocab_size)
    return HFTokenizerAdapter(name)
