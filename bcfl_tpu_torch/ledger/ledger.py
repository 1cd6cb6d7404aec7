"""Hash-chained weight ledger: port of ``bcfl_tpu/ledger/ledger.py`` (the
local engine's part: chain, digests, authentication, accounting, JSON).

- every accepted client update appends a :class:`LedgerEntry`
  ``{round, client, params_digest, payload_bytes}``; the entry hash extends
  a SHA-256 chain ``head_i = H(head_{i-1} || entry_i)`` (genesis = 32 zero
  bytes);
- verification walks the chain and recomputes every link, locating a
  tampered entry by index;
- authentication: before aggregation the engine recomputes each client's
  digest and compares it to the committed entry; a mismatch zeroes that
  client's participation mask;
- accounting: entries are ~100 bytes against multi-100 MB trees
  (:meth:`Ledger.payload_accounting`).

Hashing is ``hashlib``. The JAX package takes the same route when its C++
core is not built, and the digests are identical either way; the port's
native core is the tokenizer-and-native item of ROADMAP.md, so
``use_native`` is accepted and has no effect yet. The fork/merge/segment
and state-commitment API of the JAX ledger serves its multi-process
runtime and waits for that port.

Trees are ``{path: tensor}`` dicts (values may be nested dicts, as codec
payloads are) with ``/``-joined keys; :func:`flat_leaves` walks them in
the JAX flatten order, so digests equal the JAX package's for the same
leaves.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

GENESIS = b"\x00" * 32


def chain_extend(prev: bytes, payload: bytes, use_native: bool = True) -> bytes:
    """One chain link: ``H(prev || payload)``."""
    return hashlib.sha256(prev + payload).digest()


def _sha256_chunks(chunks: List[bytes], use_native: bool = True) -> bytes:
    """SHA-256 over concatenated chunks."""
    h = hashlib.sha256()
    for c in chunks:
        h.update(c)
    return h.digest()


def _jax_key(k: str) -> Tuple[str, ...]:
    return tuple(str(k).split("/"))


def flat_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """``(name, leaf)`` in ``jax.tree_util`` flatten order: dict keys
    sorted level by level, a ``/``-joined key standing for its nested
    path, names joined with ``/``."""
    for k in sorted(tree, key=_jax_key):
        v = tree[k]
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from flat_leaves(v, name)
        else:
            yield name, v


def dtype_str(dtype) -> str:
    """numpy's ``dtype.str`` of a leaf, as JAX writes it (bfloat16 is the
    2-byte void ``<V2``)."""
    if dtype == torch.bfloat16:
        return "<V2"
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype.str
    return np.dtype(dtype).str


def _host_bytes(leaf) -> Tuple[str, Tuple[int, ...], bytes]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        dt = dtype_str(t.dtype)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return dt, tuple(leaf.shape), t.numpy().tobytes()
    arr = np.ascontiguousarray(np.asarray(leaf))
    return arr.dtype.str, tuple(arr.shape), arr.tobytes()


def params_digest(tree, use_native: bool = True) -> bytes:
    """Canonical SHA-256 of a tree (leaf names + dtypes + shapes + raw
    bytes, in JAX flatten order): what a client announces to the ledger.
    Needs the whole tree on the host; the engine commits a device-side
    fingerprint instead (:mod:`bcfl_tpu_torch.ledger.fingerprint`)."""
    chunks: List[bytes] = []
    for name, leaf in flat_leaves(tree):
        dt, shape, body = _host_bytes(leaf)
        chunks.append(f"{name}:{dt}:{shape}".encode())
        chunks.append(body)
    return _sha256_chunks(chunks, use_native)


@dataclasses.dataclass(frozen=True)
class LedgerEntry:
    round: int
    client: int
    params_digest: bytes  # 32 bytes
    payload_bytes: int  # size of the update this entry stands in for

    def serialize(self) -> bytes:
        return struct.pack("<qq32sq", self.round, self.client,
                           self.params_digest, self.payload_bytes)

    @property
    def size_bytes(self) -> int:
        return len(self.serialize()) + 32  # + chain head stored alongside


class Ledger:
    """Append-only hash chain over accepted client updates."""

    def __init__(self, use_native: bool = True):
        self.use_native = use_native
        self.entries: List[LedgerEntry] = []
        self.heads: List[bytes] = []

    @property
    def head(self) -> bytes:
        return self.heads[-1] if self.heads else GENESIS

    def __len__(self) -> int:
        return len(self.entries)

    def append(self, round_idx: int, client: int, tree,
               payload_bytes: Optional[int] = None) -> LedgerEntry:
        """Digest ``tree`` (the client's update) and chain an entry for
        it."""
        digest = params_digest(tree, self.use_native)
        if payload_bytes is None:
            payload_bytes = int(sum(len(_host_bytes(x)[2])
                                    for _, x in flat_leaves(tree)))
        return self.append_digest(round_idx, client, digest, payload_bytes)

    def append_digest(self, round_idx: int, client: int, digest: bytes,
                      payload_bytes: int) -> LedgerEntry:
        """Chain an entry for an already-computed 32-byte digest (the
        fingerprint path: the tree never reaches the host)."""
        entry = LedgerEntry(round_idx, client, digest, payload_bytes)
        self.heads.append(chain_extend(self.head, entry.serialize(),
                                       self.use_native))
        self.entries.append(entry)
        return entry

    def verify_chain(self) -> int:
        """-1 if every link checks out, else the index of the first bad
        link."""
        prev = GENESIS
        for i, e in enumerate(self.entries):
            h = hashlib.sha256(prev + e.serialize()).digest()
            if h != self.heads[i]:
                return i
            prev = h
        return -1

    def authenticate(self, round_idx: int, client: int, tree) -> bool:
        """Does ``tree`` match what ``client`` committed for
        ``round_idx``?"""
        return self.authenticate_digest(
            round_idx, client, params_digest(tree, self.use_native))

    def authenticate_digest(self, round_idx: int, client: int,
                            digest: bytes) -> bool:
        """Digest-level authenticate (the fingerprint path's twin)."""
        for e in reversed(self.entries):
            if e.round == round_idx and e.client == client:
                return e.params_digest == digest
        return False

    def payload_accounting(self) -> Dict[str, float]:
        """Ledger-vs-full-weights communication sizes (GB)."""
        full = sum(e.payload_bytes for e in self.entries)
        ledger = sum(e.size_bytes for e in self.entries)
        return {
            "full_weights_gb": full / 1e9,
            "ledger_gb": ledger / 1e9,
            "reduction": 1.0 - (ledger / full if full else 0.0),
        }

    def to_json(self) -> str:
        return json.dumps([
            {"round": e.round, "client": e.client,
             "digest": e.params_digest.hex(), "payload_bytes": e.payload_bytes,
             "head": self.heads[i].hex()}
            for i, e in enumerate(self.entries)
        ])

    @classmethod
    def from_json(cls, s: str, use_native: bool = True) -> "Ledger":
        led = cls(use_native)
        for row in json.loads(s):
            led.entries.append(LedgerEntry(
                row["round"], row["client"], bytes.fromhex(row["digest"]),
                row["payload_bytes"]))
            led.heads.append(bytes.fromhex(row["head"]))
        return led
