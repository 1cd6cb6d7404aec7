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
  (:meth:`Ledger.payload_accounting`);
- fork and heal: a partition leaves each component extending its own copy
  of the chain from a common prefix. The heal locates the fork point
  (:meth:`Ledger.fork_point`), verifies the other side's divergent
  segment link by link (:meth:`Ledger.verify_segment`) and re-chains the
  deterministic union of both segments (:meth:`Ledger.merge_rows`,
  :meth:`Ledger.adopt_merge`), so every peer holds the same merged chain;
- state commitments: a peer serving its full state to a repairing peer
  first appends a reserved row binding the state's digest at its version
  (:meth:`Ledger.commit_state`); the receiver checks the transferred tree
  against it (:meth:`Ledger.find_state_commitment`).

Hashing runs in the C++ core (:mod:`bcfl_tpu_torch.native`, built with g++
at first use) when ``use_native`` is set and a toolchain exists, and in
``hashlib`` otherwise; the digests are identical either way. The
multi-process runtime's replicas use :meth:`Ledger.head_at`,
:meth:`Ledger.segment`, :meth:`Ledger.append_rows` and
:meth:`Ledger.verify_segment`. Rows, heads and merged segments are the
JAX package's byte for byte: they cross the wire between peers.

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

import ctypes

import numpy as np
import torch

from bcfl_tpu_torch.native.build import load_ledger_lib

GENESIS = b"\x00" * 32

# reserved row client ids for state commitments: real clients are >= 0 and
# reputation rows sit at -1000 - peer, so rows at or below this base never
# collide with either. Peer p's commitments use SYNC_CLIENT_BASE - p; the
# row's digest slot holds the params digest of the full state p serves.
SYNC_CLIENT_BASE = -2000


def sync_row_client(peer: int) -> int:
    return SYNC_CLIENT_BASE - int(peer)


def chain_extend(prev: bytes, payload: bytes, use_native: bool = True) -> bytes:
    """One chain link: ``H(prev || payload)`` (C++ core when built)."""
    lib = load_ledger_lib() if use_native else None
    if lib is not None:
        out = ctypes.create_string_buffer(32)
        lib.bcfl_chain_extend(prev, payload, len(payload), out)
        return out.raw
    return hashlib.sha256(prev + payload).digest()


def _sha256_chunks(chunks: List[bytes], use_native: bool = True) -> bytes:
    """SHA-256 over concatenated chunks (C++ core when built)."""
    lib = load_ledger_lib() if use_native else None
    if lib is not None:
        n = len(chunks)
        bufs = (ctypes.c_char_p * n)(*chunks)
        lens = (ctypes.c_uint64 * n)(*[len(c) for c in chunks])
        out = ctypes.create_string_buffer(32)
        lib.bcfl_sha256_multi(bufs, lens, n, out)
        return out.raw
    h = hashlib.sha256()
    for c in chunks:
        h.update(c)
    return h.digest()


def _row_entry(row: Dict) -> "LedgerEntry":
    return LedgerEntry(int(row["round"]), int(row["client"]),
                       bytes.fromhex(row["digest"]),
                       int(row["payload_bytes"]))


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
        link (in the C++ core when built)."""
        payloads = [e.serialize() for e in self.entries]
        lib = load_ledger_lib() if self.use_native else None
        if lib is not None and payloads:
            n = len(payloads)
            bufs = (ctypes.c_char_p * n)(*payloads)
            lens = (ctypes.c_uint64 * n)(*[len(p) for p in payloads])
            return int(lib.bcfl_chain_verify(bufs, lens,
                                             b"".join(self.heads), n))
        prev = GENESIS
        for i, p in enumerate(payloads):
            h = hashlib.sha256(prev + p).digest()
            if h != self.heads[i]:
                return i
            prev = h
        return -1

    # ------------------------------------------------------ replica sync
    # A follower keeps a replica of its leader's chain: each broadcast
    # carries the suffix since the last one (:meth:`segment`), verified
    # link by link as it lands (:meth:`append_rows`); a gap or a bad link
    # makes the follower ask for the whole chain instead.

    def head_at(self, n: int) -> bytes:
        """Chain head after the first ``n`` entries (GENESIS at 0)."""
        if n < 0 or n > len(self.heads):
            raise ValueError(f"head_at({n}) out of range [0, {len(self.heads)}]")
        return GENESIS if n == 0 else self.heads[n - 1]

    def fork_point(self, other_heads: List[bytes]) -> int:
        """Length of the longest common prefix with another chain's head
        list (0 = only genesis is shared)."""
        n = 0
        for mine, theirs in zip(self.heads, other_heads):
            if mine != theirs:
                break
            n += 1
        return n

    def segment(self, start: int) -> List[Dict]:
        """JSON-able rows for entries ``[start:]`` (entry fields + the head
        after each link): what a leader ships to its replicas."""
        return [
            {"round": e.round, "client": e.client,
             "digest": e.params_digest.hex(),
             "payload_bytes": e.payload_bytes,
             "head": self.heads[start + i].hex()}
            for i, e in enumerate(self.entries[start:])
        ]

    @staticmethod
    def verify_segment(prev_head: bytes, rows: List[Dict],
                       use_native: bool = True) -> int:
        """Recompute every link of a received segment from ``prev_head``:
        -1 if every claimed head checks out, else the index (within the
        segment) of the first bad link. A tampered entry or a tampered
        claimed head both fail."""
        prev = prev_head
        for i, row in enumerate(rows):
            h = chain_extend(prev, _row_entry(row).serialize(), use_native)
            if h != bytes.fromhex(row["head"]):
                return i
            prev = h
        return -1

    def append_rows(self, rows: List[Dict]) -> int:
        """Append already-chained rows (a replica catching up from its
        leader), verifying each link as it lands: -1 on success, else the
        index of the first row whose claimed head does not extend this
        chain (the rows before it stay appended)."""
        for i, row in enumerate(rows):
            entry = _row_entry(row)
            h = chain_extend(self.head, entry.serialize(), self.use_native)
            if h != bytes.fromhex(row["head"]):
                return i
            self.heads.append(h)
            self.entries.append(entry)
        return -1

    @staticmethod
    def merge_rows(*segments: List[Dict]) -> List[Dict]:
        """Deterministic union of divergent fork segments: rows sorted by
        their full identity ``(round, client, digest, payload_bytes)``,
        exact duplicates dropped. Every peer computes the same order from
        the same segments, so re-chaining the merge gives the same heads
        everywhere."""
        seen = set()
        out = []
        for row in sorted(
                (r for seg in segments for r in seg),
                key=lambda r: (int(r["round"]), int(r["client"]),
                               r["digest"], int(r["payload_bytes"]))):
            key = (int(row["round"]), int(row["client"]), row["digest"],
                   int(row["payload_bytes"]))
            if key in seen:
                continue
            seen.add(key)
            out.append(row)
        return out

    def adopt_merge(self, fork_base: int, merged_rows: List[Dict]) -> None:
        """Replace everything after ``fork_base`` with the merged segment,
        re-chained from the fork-point head."""
        if fork_base > len(self.entries):
            raise ValueError(
                f"fork_base {fork_base} beyond chain length "
                f"{len(self.entries)}")
        del self.entries[fork_base:]
        del self.heads[fork_base:]
        for row in merged_rows:
            self.append_digest(int(row["round"]), int(row["client"]),
                               bytes.fromhex(row["digest"]),
                               int(row["payload_bytes"]))

    def commit_state(self, version: int, peer: int,
                     state_digest: bytes) -> LedgerEntry:
        """Append a reserved state-commitment row: ``peer`` attests that at
        ``version`` its full state hashes to ``state_digest``."""
        if len(state_digest) != 32:
            raise ValueError(
                f"state commitment digest must be 32 bytes, got "
                f"{len(state_digest)}")
        return self.append_digest(int(version), sync_row_client(peer),
                                  state_digest, 0)

    @staticmethod
    def find_state_commitment(rows: List[Dict], version: int,
                              peer: int) -> Optional[bytes]:
        """The state digest ``peer`` committed for ``version`` in a row
        segment (the newest match), or None. Verify the segment first: an
        unverified row proves nothing."""
        want = sync_row_client(peer)
        for row in reversed(rows):
            if int(row["client"]) == want and int(row["round"]) == int(version):
                return bytes.fromhex(row["digest"])
        return None

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
