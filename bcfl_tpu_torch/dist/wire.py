"""Length-prefixed TCP wire format for the dist runtime: port of
``bcfl_tpu/dist/wire.py``, byte for byte (RUNTIME.md §3).

The port's trees hold CPU ``torch.Tensor`` leaves (numpy arrays are taken
too). A tensor goes out as a numpy view of its storage, so its index row
and bytes are what JAX writes for the same array. numpy has no bfloat16:
JAX's bf16 leaf is an ``ml_dtypes`` array whose ``dtype.str`` is the
2-byte void ``"<V2"``, and so the port writes a bf16 tensor as ``"<V2"``
over its 16-bit patterns, and reads every ``"<V2"`` leaf back as
``torch.bfloat16``. Every other leaf is read back as the tensor of its
dtype (``torch.from_numpy`` over the received buffer, no copy).

A **frame** is one protocol message: a small JSON header (message type,
peer id, versions, digests, ...) plus zero or more named **trees** — pytrees
of numpy arrays (a codec payload dict, a raw delta tree, a full model).
Everything is length-prefixed so a reader always knows exactly how many
bytes to wait for, and every read runs under a hard deadline — a stalled
sender produces a timeout, never a wedged peer.

Frame layout (all integers little-endian):

    MAGIC "BCF1"
    u64   frame_len                  # bytes after the crc field
    u32   crc32                      # zlib.crc32 over the whole payload
    u32   header_len, header JSON
    u32   ntrees
    per tree:
        u32  name_len, name (utf-8)
        u32  index_len, index JSON   # [{path, dtype, shape}] in body order
        u64  body_len, body          # concatenated raw C-order leaf bytes

The CRC covers every payload byte (header JSON included), so any in-flight
byte damage is rejected as :class:`CrcError` before a single field is
parsed — a corrupted frame can never half-deliver a tree or feed garbage
JSON to the handler. The receiver confirms an intact frame with a 4-byte
:data:`ACK`; the sender treats a missing ack as a failed attempt and
retries (at-least-once delivery — the transport's dedup window absorbs the
resulting duplicates). A malformed payload (hostile index JSON, truncated
tree, garbage dtype) always raises a clean :class:`WireError` — never a
hang, never a partially-built tree.

Trees are nested ``dict``s of arrays (flax param trees and codec payload
dicts both are); leaf paths join nesting keys with the ``\\x1f`` unit
separator — NOT ``"/"``, because codec payload dicts use leaf path names
like ``"layer/kernel"`` as single keys, and a ``/`` join would silently
re-nest them into a different structure on the receiver (breaking both the
decode program's payload lookup and structural equality). The round-trip is
bit- and structure-exact, so the ledger fingerprint digests computed on the
sender reproduce on the receiver unless the bytes really changed in flight.

**Streaming I/O** (the hot path — RUNTIME.md §3): :func:`write_frame`
streams a frame straight out of the numpy leaf buffers (``memoryview``s
over the arrays, CRC32 accumulated incrementally in a first zero-copy
pass) — the full payload is NEVER concatenated into one ``bytes`` on the
send path, so peak serialization allocation is the small skeleton (header
+ index JSON + length words), not a second copy of a model-sized body.
:func:`read_frame` decodes symmetrically: it parses the length-prefixed
stream as it arrives and reads each leaf's bytes DIRECTLY into its
preallocated array (``recv_into``), accumulating the same incremental
CRC. Because parsing now runs before the whole-payload CRC can be known,
a malformed stream is classified at the point of failure: the reader
drains the frame's remaining bytes (still under the frame deadline),
finishes the CRC, and raises :class:`CrcError` when the payload really
was damaged in flight — so corruption is still surfaced as a CRC drop,
never misfiled as a hostile sender — and :class:`WireError` when the
bytes arrived exactly as sent but are malformed. The on-wire layout is
byte-identical to :func:`pack_frame` (pinned by
``tests/test_wire_chaos.py::test_streamed_frame_bytes_identical``), so
ledger digests, dedup identities, and the fuzz contracts all hold
unchanged. ``pack_frame``/``unpack_frame`` remain as the in-memory
reference implementation (tests, fuzzing, held-frame re-packs).
"""

from __future__ import annotations

import json
import socket
import struct
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

MAGIC = b"BCF1"
ACK = b"BCFA"  # receiver's delivery confirmation for one intact frame
# bytes before the payload: magic (4) + u64 length (8) + u32 crc (4)
PREFIX_LEN = 16
# sanity cap: a corrupt/hostile length prefix must not OOM the peer. Full
# BERT-base f32 is ~0.44 GB; 4 GiB leaves headroom for any model this repo
# trains while still rejecting garbage lengths.
MAX_FRAME = 4 << 30


class WireError(RuntimeError):
    """Malformed frame (bad magic, oversized length, truncated stream)."""


class CrcError(WireError):
    """Frame payload failed its CRC — bytes changed in flight."""


SEP = "\x1f"  # key joiner; never appears in flax keys or codec path names


def _flatten(tree: Any, prefix: str = "") -> list:
    """Nested dicts of arrays -> [(path, np.ndarray)] in sorted key order
    (a canonical order, so sender and receiver agree byte-for-byte)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            if SEP in k:
                raise WireError(f"tree key {k!r} contains the wire "
                                "separator")
            out.extend(_flatten(tree[k], f"{prefix}{k}{SEP}"))
        return out
    return [(prefix[:-1], _as_array(tree))]


def _nest(tree: Dict[str, Any], adapters: bool) -> Dict:
    """A flat ``{"a/b/c": leaf}`` model tree in the nesting of JAX's
    pytree of the same model: an adapter tree at each key's last ``/``
    (``{target: {"a" | "b" | "full": leaf}}``), a parameter tree at every
    ``/`` (flax params)."""
    out: Dict = {}
    for path, leaf in tree.items():
        parts = path.rsplit("/", 1) if adapters else path.split("/")
        node = out
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = leaf
    return out


def _unnest(tree: Dict) -> Dict[str, Any]:
    """The inverse of :func:`_nest`: nested keys joined with ``/``, in the
    received (sorted, JAX's flatten) order."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            for kk, vv in _unnest(v).items():
                out[f"{k}/{kk}"] = vv
        else:
            out[k] = v
    return out


def _model_trees(header: Dict) -> bool:
    """Whether a frame's trees are model trees: every tree but an update's
    codec payload (``wire_kind == "payload"``), which both packages key
    by path names."""
    return header.get("wire_kind") != "payload"


def to_wire(header: Dict, trees: Optional[Dict[str, Any]],
            adapters: bool) -> Optional[Dict[str, Any]]:
    """A frame's trees as they cross: the port's flat model trees in the
    nesting of JAX's pytree (``adapters``: the runtime trains an adapter
    tree), so that the frame's index paths and leaf order, and so its
    bytes, are JAX's; a codec payload as it is."""
    if not trees or not _model_trees(header):
        return trees
    return {name: _nest(t, adapters) for name, t in trees.items()}


def from_wire(header: Dict, trees: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`to_wire` on a received frame: model trees
    flat again, ``{"a/b/c": leaf}``."""
    if not trees or not _model_trees(header):
        return trees
    return {name: _unnest(t) for name, t in trees.items()}


#: numpy's view of a bfloat16 leaf: JAX's ``ml_dtypes.bfloat16`` reports
#: ``dtype.str == "<V2"``, and its bytes are the 16-bit patterns
BF16_WIRE = np.dtype("V2")
BF16_STR = "<V2"


def _as_array(leaf) -> np.ndarray:
    """A leaf as a C-contiguous numpy array: a CPU tensor as a view of its
    storage (bfloat16 as its 16-bit patterns under ``"<V2"``). As in JAX,
    ``np.ascontiguousarray`` makes a 0-d leaf 1-d (shape ``[1]``)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.device.type != "cpu":
            raise WireError(f"wire trees hold CPU tensors, got a leaf on "
                            f"{leaf.device}")
        t = leaf.detach().contiguous()
        if t.dtype == torch.bfloat16:
            leaf = t.view(torch.int16).numpy().view(BF16_WIRE)
        else:
            leaf = t.numpy()
    return np.ascontiguousarray(np.asarray(leaf))


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    """A received leaf as a CPU tensor sharing its buffer (``"<V2"`` ->
    bfloat16)."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    try:
        return torch.from_numpy(arr)
    except TypeError as e:
        raise WireError(f"leaf dtype {arr.dtype.str} has no tensor "
                        f"type: {e}") from None


def _tree_index(leaves) -> bytes:
    """Index JSON bytes for a flattened leaf list (shared by the in-memory
    reference pack and the streaming writer, so the two cannot drift)."""
    return json.dumps(
        [{"path": p, "dtype": _dtype_str(a), "shape": list(a.shape)}
         for p, a in leaves]).encode()


def _dtype_str(a: np.ndarray) -> str:
    """The index row's dtype: numpy's ``dtype.str``, except a bfloat16
    leaf's 2-byte void, which numpy spells ``"|V2"`` and JAX's
    ``ml_dtypes`` array ``"<V2"``."""
    return BF16_STR if a.dtype == BF16_WIRE else a.dtype.str


def pack_tree(tree: Any) -> Tuple[bytes, bytes]:
    """Tree -> (index JSON bytes, concatenated body bytes). In-memory
    REFERENCE implementation — the transport's send path streams leaf
    buffers via :func:`write_frame` instead of concatenating them."""
    leaves = _flatten(tree)
    body = b"".join(a.tobytes() for _, a in leaves)
    return _tree_index(leaves), body


def _json_loads(raw: bytes, what: str) -> Any:
    """Decode hostile JSON into a value or a clean WireError — garbage
    bytes on the wire must never surface as a JSONDecodeError deep in a
    serving thread."""
    try:
        return json.loads(bytes(raw).decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise WireError(f"malformed {what} JSON: {e}") from None


def unpack_tree(index_json: bytes, body: bytes) -> Dict:
    """(index JSON, body) -> nested dict of CPU tensors. Any malformed
    index — non-list JSON, garbage dtype, negative/overflowing shape, a
    leaf extending past the body — raises :class:`WireError`; a partial
    tree is never returned."""
    out: Dict = {}
    off = 0
    rows = _json_loads(index_json, "tree index")
    try:
        for row in rows:
            dt = np.dtype(row["dtype"])
            shape = tuple(int(s) for s in row["shape"])
            if any(s < 0 for s in shape):
                raise WireError(f"negative dim in leaf shape {shape}")
            count = int(np.prod(shape, dtype=np.int64)) if shape else 1
            if count < 0 or count * dt.itemsize > MAX_FRAME:
                raise WireError(f"leaf shape {shape} overflows MAX_FRAME")
            n = dt.itemsize * count
            if off + n > len(body):
                raise WireError(
                    f"tree body truncated at leaf {row['path']!r} "
                    f"(need {off + n}, have {len(body)})")
            arr = _to_tensor(np.frombuffer(body, dt, count=count,
                                           offset=off).reshape(shape).copy())
            off += n
            node = out
            parts = str(row["path"]).split(SEP)
            for k in parts[:-1]:
                node = node.setdefault(k, {})
                if not isinstance(node, dict):
                    raise WireError(f"leaf path {row['path']!r} descends "
                                    "through a non-dict node")
            node[parts[-1]] = arr
    except WireError:
        raise
    except (TypeError, ValueError, KeyError, AttributeError,
            OverflowError) as e:
        # hostile index rows (wrong types, unknown dtypes, missing keys,
        # dims past int64 — np.prod raises OverflowError on those)
        raise WireError(f"malformed tree index: {e}") from None
    if off != len(body):
        raise WireError(f"tree body has {len(body) - off} trailing bytes")
    return out


def pack_frame(header: Dict, trees: Optional[Dict[str, Any]] = None) -> bytes:
    hdr = json.dumps(header).encode()
    parts = [struct.pack("<I", len(hdr)), hdr,
             struct.pack("<I", len(trees or {}))]
    for name, tree in (trees or {}).items():
        nb = name.encode()
        index, body = pack_tree(tree)
        parts.extend([
            struct.pack("<I", len(nb)), nb,
            struct.pack("<I", len(index)), index,
            struct.pack("<Q", len(body)), body,
        ])
    payload = b"".join(parts)
    if len(payload) > MAX_FRAME:
        raise WireError(f"frame of {len(payload)} bytes exceeds MAX_FRAME")
    return (MAGIC + struct.pack("<Q", len(payload))
            + struct.pack("<I", zlib.crc32(payload)) + payload)


def unpack_frame(payload: bytes) -> Tuple[Dict, Dict[str, Any]]:
    """Bytes AFTER the magic+length+crc prefix -> (header, {name: tree})."""
    view = memoryview(payload)
    off = 0

    def take(n: int) -> memoryview:
        nonlocal off
        if off + n > len(view):
            raise WireError("frame truncated")
        out = view[off:off + n]
        off += n
        return out

    (hdr_len,) = struct.unpack("<I", take(4))
    header = _json_loads(take(hdr_len), "frame header")
    if not isinstance(header, dict):
        raise WireError(f"frame header is {type(header).__name__}, "
                        "expected an object")
    (ntrees,) = struct.unpack("<I", take(4))
    trees = {}
    for _ in range(ntrees):
        (name_len,) = struct.unpack("<I", take(4))
        try:
            name = bytes(take(name_len)).decode()
        except UnicodeDecodeError as e:
            raise WireError(f"malformed tree name: {e}") from None
        (idx_len,) = struct.unpack("<I", take(4))
        index = bytes(take(idx_len))
        (body_len,) = struct.unpack("<Q", take(8))
        trees[name] = unpack_tree(index, bytes(take(body_len)))
    return header, trees


# ---------------------------------------------------------- streaming writer


def _frame_parts(header: Dict,
                 trees: Optional[Dict[str, Any]]) -> Tuple[list, int]:
    """The frame payload as an ordered list of buffers — small ``bytes``
    skeleton pieces (lengths, JSON) and zero-copy ``memoryview``s over the
    numpy leaf storage — plus the total payload length. Nothing here
    concatenates leaf bodies; the byte sequence is identical to
    :func:`pack_frame`'s payload by construction (same piece order)."""
    hdr = json.dumps(header).encode()
    parts: list = [struct.pack("<I", len(hdr)), hdr,
                   struct.pack("<I", len(trees or {}))]
    for name, tree in (trees or {}).items():
        nb = name.encode()
        leaves = _flatten(tree)
        index = _tree_index(leaves)
        body_len = sum(a.nbytes for _, a in leaves)
        parts.extend([
            struct.pack("<I", len(nb)), nb,
            struct.pack("<I", len(index)), index,
            struct.pack("<Q", body_len),
        ])
        # _flatten returned C-contiguous arrays: a flat byte view is a
        # borrow of the existing buffer, never a copy (0-d arrays go
        # through a reshape(1) view; zero-size leaves contribute no bytes
        # and memoryview.cast rejects them — skip)
        parts.extend(memoryview(a if a.ndim else a.reshape(1)).cast("B")
                     for _, a in leaves if a.nbytes)
    total = sum(len(p) if isinstance(p, bytes) else p.nbytes for p in parts)
    return parts, total


def frame_prefix(header: Dict,
                 trees: Optional[Dict[str, Any]] = None) -> bytes:
    """MAGIC + length + CRC prefix of the frame :func:`write_frame` would
    stream — the CRC pass without the write (used by tests and the perf
    bench to prove streamed == packed)."""
    parts, total = _frame_parts(header, trees)
    if total > MAX_FRAME:
        raise WireError(f"frame of {total} bytes exceeds MAX_FRAME")
    crc = 0
    for p in parts:
        crc = zlib.crc32(p, crc)
    return MAGIC + struct.pack("<Q", total) + struct.pack("<I", crc)


def write_frame(sock: socket.socket, header: Dict,
                trees: Optional[Dict[str, Any]] = None,
                corrupt_frac: Optional[list] = None,
                prefix: Optional[bytes] = None) -> int:
    """Stream one frame: CRC32 accumulated over the payload pieces in a
    first zero-copy pass (the prefix carries it, so it must be known before
    the first payload byte), then each piece written straight from its
    buffer — leaf bodies go out as ``memoryview``s over the numpy arrays,
    never concatenated. Small skeleton pieces are coalesced into one
    buffer between leaves to keep the syscall count low. Returns the
    total frame length (prefix + payload).

    ``prefix`` is an optional precomputed :func:`frame_prefix` for exactly
    this (header, trees): the transport's retry loop computes it once per
    logical send so re-attempts skip the CRC pass (the streaming analogue
    of "serialize once per logical send").

    ``corrupt_frac`` (the wire chaos lane's corruption hook) XOR-flips the
    payload byte at offset ``min(int(f * payload_len), payload_len - 1)``
    for each fraction, AFTER the CRC pass, so the receiver sees a
    well-framed message whose CRC no longer matches: JAX's bytes for the
    same frame and fractions. Only the pieces a flip lands in are copied;
    the frame is never materialized."""
    parts, total = _frame_parts(header, trees)
    if total > MAX_FRAME:
        raise WireError(f"frame of {total} bytes exceeds MAX_FRAME")
    if prefix is None:
        crc = 0
        for p in parts:
            crc = zlib.crc32(p, crc)
        prefix = (MAGIC + struct.pack("<Q", total)
                  + struct.pack("<I", crc))
    if corrupt_frac and total > 0:
        parts = _corrupt_parts(
            parts, [min(int(f * total), total - 1) for f in corrupt_frac])
    sock.sendall(prefix)
    pending: list = []  # coalesce consecutive small pieces
    for p in parts:
        if isinstance(p, bytes) and len(p) < (1 << 16):
            pending.append(p)
            continue
        if pending:
            sock.sendall(b"".join(pending))  # skeleton only, never a body
            pending = []
        sock.sendall(p)
    if pending:
        sock.sendall(b"".join(pending))
    return PREFIX_LEN + total


def _corrupt_parts(parts: list, corrupt_pos: list) -> list:
    """Flip the payload byte at each absolute offset, copying only the
    pieces a flip lands in."""
    out = list(parts)
    offsets = []
    off = 0
    for p in out:
        offsets.append(off)
        off += len(p) if isinstance(p, bytes) else p.nbytes
    for pos in corrupt_pos:
        pos = min(int(pos), off - 1)
        if pos < 0:
            continue
        # the last piece starting at or before pos (few pieces: linear)
        for i in range(len(out) - 1, -1, -1):
            if offsets[i] <= pos:
                buf = bytearray(out[i])
                buf[pos - offsets[i]] ^= 0xFF
                out[i] = bytes(buf)
                break
    return out


# ---------------------------------------------------------- streaming reader


class _FrameReader:
    """Incremental reader of one frame's payload: hands out exactly the
    requested bytes (or fills a caller-provided buffer in place), keeps a
    running CRC32 and a byte budget, and never reads past the declared
    payload length — trailing protocol bytes (the next frame, the ack
    channel) stay untouched."""

    CHUNK = 1 << 20

    def __init__(self, sock: socket.socket, length: int,
                 deadline: Optional[float]):
        self.sock = sock
        self.remaining = int(length)
        self.deadline = deadline
        self.crc = 0

    def _budget(self) -> None:
        import time

        if self.deadline is not None:
            budget = self.deadline - time.monotonic()
            if budget <= 0:
                raise socket.timeout(
                    f"frame deadline expired with {self.remaining} payload "
                    "bytes unread")
            self.sock.settimeout(budget)

    def take(self, n: int, what: str = "payload") -> bytes:
        """Exactly ``n`` payload bytes (skeleton pieces: lengths, JSON)."""
        if n < 0 or n > self.remaining:
            raise WireError(
                f"frame {what} of {n} bytes overruns the declared payload "
                f"({self.remaining} left)")
        chunks = []
        left = n
        while left:
            self._budget()  # deadline: settimeout from the frame budget
            chunk = self.sock.recv(min(left, self.CHUNK))
            if not chunk:
                raise WireError(f"connection closed {left} bytes early")
            chunks.append(chunk)
            left -= len(chunk)
        out = b"".join(chunks)
        self.crc = zlib.crc32(out, self.crc)
        self.remaining -= n
        return out

    def readinto(self, view: memoryview, what: str = "leaf") -> None:
        """Fill ``view`` (a leaf's preallocated array storage) directly from
        the socket — the receive-side zero-copy path."""
        n = view.nbytes
        if n > self.remaining:
            raise WireError(
                f"frame {what} of {n} bytes overruns the declared payload "
                f"({self.remaining} left)")
        off = 0
        while off < n:
            self._budget()
            got = self.sock.recv_into(view[off:off + self.CHUNK])
            if not got:
                raise WireError(
                    f"connection closed {n - off} bytes early")
            self.crc = zlib.crc32(view[off:off + got], self.crc)
            off += got
        self.remaining -= n

    def drain(self) -> None:
        """Consume (and CRC) the rest of the payload — the classification
        pass after a parse error: if the finished CRC mismatches the
        prefix, the bytes were damaged in flight (CrcError), otherwise the
        sender really sent a malformed frame (WireError). Bounded by the
        same frame deadline as every other read."""
        buf = bytearray(min(self.remaining, self.CHUNK))
        view = memoryview(buf)
        while self.remaining:
            self._budget()
            got = self.sock.recv_into(view[:min(self.remaining, len(buf))])
            if not got:
                raise WireError(
                    f"connection closed {self.remaining} bytes early")
            self.crc = zlib.crc32(view[:got], self.crc)
            self.remaining -= got


def _read_stream_tree(reader: _FrameReader) -> Dict:
    """One named tree off the stream: index JSON, then each leaf decoded
    straight into a preallocated array (``recv_into``). Every declared
    length is validated against the remaining payload BEFORE any
    allocation — a hostile index cannot make the receiver allocate more
    than the frame actually carries."""
    (idx_len,) = struct.unpack("<I", reader.take(4, "index length"))
    index = reader.take(idx_len, "tree index")
    (body_len,) = struct.unpack("<Q", reader.take(8, "body length"))
    if body_len > reader.remaining:
        raise WireError(
            f"tree body of {body_len} bytes overruns the declared payload "
            f"({reader.remaining} left)")
    rows = _json_loads(index, "tree index")
    out: Dict = {}
    consumed = 0
    try:
        for row in rows:
            dt = np.dtype(row["dtype"])
            shape = tuple(int(s) for s in row["shape"])
            if any(s < 0 for s in shape):
                raise WireError(f"negative dim in leaf shape {shape}")
            count = int(np.prod(shape, dtype=np.int64)) if shape else 1
            if count < 0 or count * dt.itemsize > MAX_FRAME:
                raise WireError(f"leaf shape {shape} overflows MAX_FRAME")
            n = dt.itemsize * count
            if consumed + n > body_len:
                raise WireError(
                    f"tree body truncated at leaf {row['path']!r} "
                    f"(need {consumed + n}, have {body_len})")
            # allocation bounded by the validated body length above
            arr = np.empty(shape, dt)
            if arr.nbytes:  # zero-size leaves carry no bytes to read
                reader.readinto(
                    memoryview(arr if arr.ndim else arr.reshape(1))
                    .cast("B"),
                    what=f"leaf {row['path']!r}")
            consumed += n
            node = out
            parts = str(row["path"]).split(SEP)
            for k in parts[:-1]:
                node = node.setdefault(k, {})
                if not isinstance(node, dict):
                    raise WireError(f"leaf path {row['path']!r} descends "
                                    "through a non-dict node")
            node[parts[-1]] = _to_tensor(arr)
    except WireError:
        raise
    except (TypeError, ValueError, KeyError, AttributeError,
            OverflowError) as e:
        # hostile index rows — incl. dims past int64, where np.prod
        # raises OverflowError rather than ValueError
        raise WireError(f"malformed tree index: {e}") from None
    if consumed != body_len:
        raise WireError(
            f"tree body has {body_len - consumed} trailing bytes")
    return out


def _read_exact(sock: socket.socket, n: int,
                deadline: Optional[float] = None) -> bytes:
    """Read exactly ``n`` bytes before ``deadline`` (``time.monotonic``
    instant). The deadline bounds the WHOLE read, not each chunk — a
    trickling sender (1 byte per chunk, each inside a per-recv timeout)
    must still hit the frame deadline instead of holding the serving
    thread and its growing buffer forever. A peer closing mid-frame raises
    WireError instead of returning garbage."""
    import time

    chunks = []
    remaining = n
    while remaining:
        if deadline is not None:
            budget = deadline - time.monotonic()
            if budget <= 0:
                raise socket.timeout(
                    f"frame deadline expired with {remaining} bytes unread")
            sock.settimeout(budget)
        chunk = sock.recv(min(remaining, 1 << 20))
        if not chunk:
            raise WireError(f"connection closed {remaining} bytes early")
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)


def read_frame(sock: socket.socket,
               timeout_s: Optional[float] = None) -> Tuple[Dict, Dict]:
    """Read one frame under a hard WHOLE-FRAME deadline, decoding the
    payload AS IT STREAMS — header and index JSON parsed off the socket,
    every leaf received straight into its preallocated array
    (``recv_into``), CRC32 accumulated incrementally. The whole payload is
    never held as one ``bytes``.

    Error contract (identical to the pre-streaming reader's, pinned by the
    fuzz suite): ``socket.timeout`` on deadline; :class:`CrcError` when the
    payload bytes were damaged in flight — on a parse failure the reader
    drains the frame's remaining bytes (same deadline) to finish the CRC
    and classify, so corruption that happens to land in a length word or
    the index JSON still surfaces as a CRC drop, not a hostile sender;
    :class:`WireError` for a stream that arrived exactly as sent but is
    malformed. A partial tree is never returned."""
    import time

    deadline = (time.monotonic() + timeout_s
                if timeout_s is not None else None)
    magic = _read_exact(sock, 4, deadline)
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r}")
    (length,) = struct.unpack("<Q", _read_exact(sock, 8, deadline))
    if length > MAX_FRAME:
        raise WireError(f"frame length {length} exceeds MAX_FRAME")
    (crc,) = struct.unpack("<I", _read_exact(sock, 4, deadline))
    reader = _FrameReader(sock, int(length), deadline)
    try:
        (hdr_len,) = struct.unpack("<I", reader.take(4, "header length"))
        header = _json_loads(reader.take(hdr_len, "frame header"),
                             "frame header")
        if not isinstance(header, dict):
            raise WireError(f"frame header is {type(header).__name__}, "
                            "expected an object")
        (ntrees,) = struct.unpack("<I", reader.take(4, "tree count"))
        trees: Dict = {}
        for _ in range(ntrees):
            (name_len,) = struct.unpack("<I", reader.take(4, "name length"))
            try:
                name = reader.take(name_len, "tree name").decode()
            except UnicodeDecodeError as e:
                raise WireError(f"malformed tree name: {e}") from None
            trees[name] = _read_stream_tree(reader)
        if reader.remaining:
            raise WireError(
                f"frame has {reader.remaining} trailing payload bytes")
    except WireError as parse_err:
        # classification pass: the payload was parsed before its CRC could
        # be known (that is what streaming means), so tell in-flight damage
        # apart from a genuinely hostile sender by finishing the CRC over
        # the undrained remainder. A drain failure (peer died mid-frame,
        # deadline) reports the original parse error.
        try:
            reader.drain()
        except (WireError, OSError, socket.timeout):
            raise parse_err from None
        if reader.crc != crc:
            raise CrcError(
                f"payload CRC mismatch over {length} bytes "
                f"(parse failed at: {parse_err})") from None
        raise
    if reader.crc != crc:
        raise CrcError(f"payload CRC mismatch over {length} bytes")
    return header, trees


def write_ack(sock: socket.socket) -> None:
    """Confirm one intact frame back to the sender (4 bytes)."""
    sock.sendall(ACK)


def read_ack(sock: socket.socket, timeout_s: Optional[float] = None) -> None:
    """Wait for the receiver's :data:`ACK` under a hard deadline. Raises
    ``socket.timeout`` / :class:`WireError` when it never arrives — the
    sender's retry path treats either as a failed attempt."""
    import time

    deadline = (time.monotonic() + timeout_s
                if timeout_s is not None else None)
    got = _read_exact(sock, len(ACK), deadline)
    if got != ACK:
        raise WireError(f"bad ack {got!r}")
