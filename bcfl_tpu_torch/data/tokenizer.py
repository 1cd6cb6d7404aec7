"""Hash tokenizer: port of ``bcfl_tpu/data/tokenizer.py`` (the Python
``HashTokenizer``; the native C++ batch encoder is not ported yet).

Token id = crc32(word) % (vocab - 4) + 4 over lower-cased words; every text
becomes a fixed ``[seq_len]`` row ``[CLS] words... [SEP]`` padded with 0,
plus its 0/1 mask. Identical ids to the JAX package's tokenizer.
"""

from __future__ import annotations

import re
import zlib
from typing import Sequence, Tuple

import numpy as np

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
        ids = np.empty((len(texts), seq_len), dtype=np.int32)
        mask = np.empty((len(texts), seq_len), dtype=np.int32)
        for i, t in enumerate(texts):
            ids[i], mask[i] = self.encode(t, seq_len)
        return ids, mask


def get_tokenizer(name: str, vocab_size: int = 8192) -> HashTokenizer:
    if name == "hash":
        return HashTokenizer(vocab_size)
    raise ValueError(f"tokenizer={name!r} is not ported yet (HF tokenizers)")
