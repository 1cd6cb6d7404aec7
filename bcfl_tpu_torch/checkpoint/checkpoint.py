"""Crash-safe checkpoint and resume: port of
``bcfl_tpu/checkpoint/checkpoint.py`` (save, classify, restore, scrub).

A checkpoint is the engine's round state: the global tree, the stacked
per-client view, the codec's error-feedback residual, the reputation
arrays and the run's identity (seed, codec, PRNG scheme), plus the ledger
JSON. The format is the port's own: the state is a dict of CPU tensors
(nested dicts allowed, ``None`` entries dropped), written with
``torch.save`` into ``round_XXXXXX/state.pt`` and read back with
``torch.load(..., weights_only=True)``. Strings and integers travel as
uint8 and int64 tensors, as the JAX state carries them as arrays. A JAX
(orbax) checkpoint is not readable here.

Crash safety, as in the JAX package:

- **Atomic commit.** The state is written and fsynced under a
  dot-prefixed staging directory, renamed to ``round_XXXXXX`` (the one
  commit point, its directory entry fsynced), and only then is the meta
  sidecar (the state's SHA-256 digest by
  :func:`bcfl_tpu_torch.ledger.params_digest`, and the ledger JSON)
  written, fsynced and renamed into place. A crash leaves no ``round_``
  entry, a complete state pending its meta (restored unverified), or a
  complete verified one; on re-save of a round the stale meta goes first,
  so a valid state is never paired with a mismatching digest.
- **Verified restore.** :func:`restore_latest` walks the rounds
  newest-first through :func:`classify_round` and skips (with a warning)
  any round whose state fails to load, whose digest mismatches, or whose
  ledger chain fails verification.
- **One classification.** :func:`classify_round` is the single reader
  under :func:`restore_latest`, :func:`restore_checkpoint` and
  :func:`scrub`, over the :data:`ROUND_STATUSES` taxonomy.
- **Retention.** ``save_checkpoint(..., keep_last=K)`` removes rounds
  beyond the newest K only after the new round's commit, so a crash during
  the clean-up leaves extra old rounds, never fewer valid ones.
- **Storage fault seam.** :func:`apply_storage_fault` damages committed
  state in one of the fault plan's ``STORAGE_CLASSES`` (the storage lane
  of the multi-process runtime); :func:`scrub` is the audit a peer runs
  before trusting its own disk. The byte-level classes act on the
  ``torch.save`` archive's members, largest first, as the JAX module acts
  on the orbax tree's files: a flip lands in the largest tensor's bytes
  (``digest_mismatch``) or, when the pickled structure is the largest
  member, in the structure (usually ``unrestorable``).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import struct
import time
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from bcfl_tpu_torch.ledger.ledger import Ledger, params_digest
from bcfl_tpu_torch.telemetry import events as _telemetry

logger = logging.getLogger(__name__)

# staging prefix: never matches the `round_` scan, so an interrupted save
# is invisible until the atomic rename commits it
_STAGING = ".staging."
_META_SUFFIX = ".meta.json"
_STATE_FILE = "state.pt"

# the damage taxonomy classify_round reports:
#   ok              — loaded, digest verified, ledger chain verifies
#   unverified      — loaded, no meta sidecar (a save cut between the
#                     commit and the meta)
#   unrestorable    — the state fails to load (torn, truncated, rotten)
#   digest_mismatch — the state loads but its digest differs from the meta
#   meta_corrupt    — a meta sidecar exists but is unreadable
#   ledger_corrupt  — state and digest fine, the ledger chain fails
#   deleted         — the round dir is gone but its meta survived
#   missing         — neither dir nor meta
ROUND_STATUSES = ("ok", "unverified", "unrestorable", "digest_mismatch",
                  "meta_corrupt", "ledger_corrupt", "deleted", "missing")

# statuses a resume may trust
_USABLE = ("ok", "unverified")


def _to_host(state):
    """The state as CPU tensors: numpy arrays and scalars converted,
    nested dicts kept, ``None`` entries dropped (as a JAX tree drops
    them)."""
    out = {}
    for k, v in state.items():
        if v is None:
            continue
        if isinstance(v, dict):
            out[k] = _to_host(v)
        elif isinstance(v, torch.Tensor):
            out[k] = v.detach().cpu()
        else:
            out[k] = torch.from_numpy(np.array(v))
    return out


def _state_digest(state) -> str:
    """Hex SHA-256 over the host state (leaf names, dtypes, shapes and raw
    bytes): the ledger's params digest as integrity evidence. It hashes
    gigabytes, so it takes hashlib (OpenSSL, the CPU's SHA instructions),
    not the ledger's plain C++ core: on an H100 host a 2.2 GB save took
    23.9 s with the core and 8.2 s with hashlib. The digest is the same
    either way."""
    return params_digest(state, use_native=False).hex()


def _fsync_dir(path: str) -> None:
    """Durably record directory-entry changes (renames)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platform without directory fds; best effort
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _meta_path(directory: str, round_idx: int) -> str:
    return os.path.join(directory, f"round_{round_idx:06d}{_META_SUFFIX}")


def save_checkpoint(directory: str, round_idx: int, state: Dict[str, Any],
                    ledger_json: Optional[str] = None,
                    keep_last: int = 0) -> str:
    """Atomically write ``state`` for ``round_idx``; returns the committed
    path. ``keep_last > 0`` then removes every round but the newest
    ``keep_last``."""
    t0 = time.perf_counter()
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    name = f"round_{round_idx:06d}"
    final = os.path.join(directory, name)
    staging = os.path.join(directory, _STAGING + name)
    if os.path.isdir(staging):  # leftover from an interrupted save
        shutil.rmtree(staging)
    os.makedirs(staging)

    host = _to_host(state)
    with open(os.path.join(staging, _STATE_FILE), "wb") as f:
        torch.save(host, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(staging)

    meta_path = _meta_path(directory, round_idx)
    if os.path.isdir(final):
        # re-save of the same round: retire the old meta FIRST (the old
        # state degrades to unverified, never digest-mismatched)
        if os.path.exists(meta_path):
            os.unlink(meta_path)
            _fsync_dir(directory)
        shutil.rmtree(final)
    os.replace(staging, final)  # commit point
    _fsync_dir(directory)

    meta = {"round": int(round_idx), "digest": _state_digest(host),
            "ledger": ledger_json}
    meta_staging = os.path.join(directory, _STAGING + name + _META_SUFFIX)
    with open(meta_staging, "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(meta_staging, meta_path)
    _fsync_dir(directory)
    old = []
    if keep_last and keep_last > 0:
        committed = _list_rounds(directory)
        old = committed[:-keep_last] if len(committed) > keep_last else []
        for r in old:
            _remove_round(directory, r, keep_meta=False)
        if old:
            _fsync_dir(directory)
    # one event per committed checkpoint (a no-op without a writer), with
    # the committed chain length, as JAX emits it
    chain_len = None
    if ledger_json:
        try:
            chain_len = len(json.loads(ledger_json))
        except (ValueError, TypeError):
            pass
    _telemetry.emit("ckpt.save", step=int(round_idx), dir=directory,
                    wall_s=time.perf_counter() - t0, chain_len=chain_len,
                    gc=len(old))
    return final


def _list_rounds(directory: str) -> list:
    """Committed round indices (dirs only), ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(d.split("_")[1]) for d in os.listdir(directory)
        if d.startswith("round_") and d.split("_")[1].isdigit()
        and os.path.isdir(os.path.join(directory, d)))


def _meta_rounds(directory: str) -> list:
    """Round indices with a meta sidecar present, ascending."""
    if not os.path.isdir(directory):
        return []
    out = []
    for f in os.listdir(directory):
        if not (f.startswith("round_") and f.endswith(_META_SUFFIX)):
            continue
        stem = f[:-len(_META_SUFFIX)].split("_")[1]
        if stem.isdigit():
            out.append(int(stem))
    return sorted(out)


def _remove_round(directory: str, round_idx: int, keep_meta: bool) -> None:
    """Remove one committed round, and its meta unless ``keep_meta`` (no
    fsync: callers batch it)."""
    path = os.path.join(directory, f"round_{round_idx:06d}")
    if os.path.isdir(path):
        shutil.rmtree(path)
    if not keep_meta and os.path.exists(_meta_path(directory, round_idx)):
        os.unlink(_meta_path(directory, round_idx))


def _read_meta(directory: str, round_idx: int) -> Optional[Dict[str, Any]]:
    path = _meta_path(directory, round_idx)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        logger.warning("checkpoint meta %s unreadable (%s)", path, e)
        return None


def classify_round(directory: str, round_idx: int
                   ) -> Tuple[str, Optional[Dict[str, Any]], Optional[str]]:
    """``(status, state, ledger_json)`` for ONE round; ``status`` is one of
    :data:`ROUND_STATUSES`, ``state`` and ``ledger_json`` are non-None only
    for the usable statuses (``ok``/``unverified``)."""
    directory = os.path.abspath(directory)
    round_idx = int(round_idx)
    path = os.path.join(directory, f"round_{round_idx:06d}")
    meta_path = _meta_path(directory, round_idx)
    if not os.path.isdir(path):
        return (("deleted" if os.path.exists(meta_path) else "missing"),
                None, None)
    meta = None
    if os.path.exists(meta_path):
        meta = _read_meta(directory, round_idx)
        if meta is None:
            # present but unreadable: the atomic protocol never leaves this
            return "meta_corrupt", None, None
    try:
        state = torch.load(os.path.join(path, _STATE_FILE),
                           map_location="cpu", weights_only=True)
    except Exception as e:  # torn, truncated or rotten
        logger.warning("checkpoint %s failed to restore (%s)", path, e)
        return "unrestorable", None, None
    if meta is not None and meta.get("digest"):
        if _state_digest(state) != meta["digest"]:
            logger.warning("checkpoint %s digest mismatch (bit corruption "
                           "or foreign overwrite)", path)
            return "digest_mismatch", None, None
    ledger_json = meta.get("ledger") if meta is not None else None
    if ledger_json:
        # a checkpoint whose ledger no longer verifies link by link must
        # not be resumed from
        try:
            if Ledger.from_json(ledger_json).verify_chain() != -1:
                logger.warning("checkpoint %s ledger chain fails "
                               "verification", path)
                return "ledger_corrupt", None, None
        except (ValueError, KeyError, TypeError) as e:
            logger.warning("checkpoint %s ledger json unreadable (%s)",
                           path, e)
            return "ledger_corrupt", None, None
    return ("ok" if meta is not None else "unverified"), state, ledger_json


def restore_checkpoint(directory: str, round_idx: int
                       ) -> Optional[Tuple[int, Dict[str, Any], Optional[str]]]:
    """``(round, state, ledger_json)`` of ONE committed round, or None if
    it is absent or damaged (no fallback to an older round)."""
    status, state, ledger_json = classify_round(directory, round_idx)
    if status not in _USABLE:
        logger.warning("checkpoint %s/round_%06d not restorable: %s",
                       directory, int(round_idx), status)
        return None
    return int(round_idx), state, ledger_json


def restore_latest(directory: str
                   ) -> Optional[Tuple[int, Dict[str, Any], Optional[str]]]:
    """``(round, state, ledger_json)`` of the newest usable round, or None;
    damaged rounds are skipped newest-first with a warning."""
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return None
    for r in reversed(_list_rounds(directory)):
        status, state, ledger_json = classify_round(directory, r)
        if status in _USABLE:
            _telemetry.emit("ckpt.restore", step=int(r), dir=directory)
            return r, state, ledger_json
        logger.warning("checkpoint %s/round_%06d %s; falling back to the "
                       "previous checkpoint", directory, r, status)
    return None


def scrub(directory: str) -> Dict[str, Any]:
    """Audit every round of a checkpoint directory:

        {"empty":         no rounds, no meta, no staging entries,
         "rounds":        ((round, status), ...) ascending, over the union
                          of round dirs and meta sidecars,
         "newest_intact": newest usable round or None,
         "damaged":       ((round, status), ...) of the unusable rounds,
         "torn":          (staging entry names, ...)}

    and emits one ``scrub`` event with the verdict (``clean`` /
    ``damaged`` / ``empty``)."""
    directory = os.path.abspath(directory)
    torn = tuple(sorted(
        d for d in (os.listdir(directory) if os.path.isdir(directory) else ())
        if d.startswith(_STAGING)))
    rounds = sorted(set(_list_rounds(directory))
                    | set(_meta_rounds(directory)))
    statuses = tuple((r, classify_round(directory, r)[0]) for r in rounds)
    damaged = tuple((r, s) for r, s in statuses if s not in _USABLE)
    usable = [r for r, s in statuses if s in _USABLE]
    report = {
        "empty": not statuses and not torn,
        "rounds": statuses,
        "newest_intact": max(usable) if usable else None,
        "damaged": damaged,
        "torn": torn,
    }
    verdict = ("empty" if report["empty"]
               else "damaged" if (damaged or torn) else "clean")
    _telemetry.emit("scrub", status=verdict, dir=directory,
                    newest_intact=report["newest_intact"],
                    damaged=len(damaged), torn=len(torn))
    return report


_HEX = "0123456789abcdef"


def _rot_hex(ch: str) -> str:
    """A different hex digit, deterministically (bit rot that always
    changes the value)."""
    return _HEX[(_HEX.index(ch.lower()) + 1) % 16]


def _zip_members(path: str) -> list:
    """``(name, data offset, size)`` of each member of a ``torch.save``
    archive (an uncompressed zip), or None if ``path`` is no zip."""
    try:
        with zipfile.ZipFile(path) as z:
            infos = z.infolist()
    except (OSError, zipfile.BadZipFile):
        return None
    out = []
    with open(path, "rb") as f:
        for zi in infos:
            # the data follows the local header (30 bytes, then the name
            # and the extra field, whose lengths it records)
            f.seek(zi.header_offset + 26)
            n, m = struct.unpack("<HH", f.read(4))
            out.append((zi.filename, zi.header_offset + 30 + n + m,
                        zi.file_size))
    return out


def _tree_files(path: str) -> list:
    """The byte ranges of a committed round, largest first (name-ordered
    within a size tie): ``(file, offset, size, name)``. A ``torch.save``
    archive contributes one range per member (the pickled structure, each
    tensor's bytes), as the JAX module's orbax tree contributes one file
    per array and metadata record; any other file is one range."""
    out = []
    for root, _dirs, files in os.walk(path):
        for fn in files:
            p = os.path.join(root, fn)
            rel = os.path.relpath(p, path)
            members = _zip_members(p)
            if members is None:
                out.append((-os.path.getsize(p), rel, p, 0,
                            os.path.getsize(p)))
                continue
            for name, off, size in members:
                out.append((-size, f"{rel}:{name}", p, off, size))
    return [(p, off, size, name) for _neg, name, p, off, size in sorted(out)]


def apply_storage_fault(directory: str, action: Dict[str, Any]
                        ) -> Optional[Dict[str, Any]]:
    """Damage committed durable state per one storage draw
    (:meth:`bcfl_tpu_torch.faults.FaultPlan.storage_action`):
    ``action`` is ``{"cls", "frac", "delete_last"}``, the damage targets
    the newest committed round (and older ones for ``delete``). Returns a
    record of what was done (for the ``chaos`` event), or None when there
    was nothing to damage.

    The classes: ``torn`` moves the round back under its staging name and
    drops its meta (an interrupted commit); ``payload_flip`` flips one
    byte, and ``truncate`` cuts the state file, at ``frac`` of the largest
    byte range (:func:`_tree_files`); ``meta_flip`` rots one hex digit of
    the newest meta's digest; ``ledger`` rots one row head of the newest
    meta's ledger; ``delete`` removes the newest ``delete_last`` round
    dirs and keeps their metas (the evidence deletion leaves);
    ``rollback`` removes the newest round and its meta cleanly, which no
    local audit can tell from a round never written."""
    directory = os.path.abspath(directory)
    rounds = _list_rounds(directory)
    if not rounds:
        return None
    cls = action["cls"]
    frac = float(action.get("frac", 0.0))
    newest = rounds[-1]
    name = f"round_{newest:06d}"
    path = os.path.join(directory, name)
    meta_path = _meta_path(directory, newest)
    record: Dict[str, Any] = {"cls": cls, "round": int(newest)}

    if cls == "torn":
        staging = os.path.join(directory, _STAGING + name)
        if os.path.isdir(staging):
            shutil.rmtree(staging)
        if os.path.exists(meta_path):
            os.unlink(meta_path)
        os.replace(path, staging)
    elif cls in ("payload_flip", "truncate"):
        ranges = [r for r in _tree_files(path) if r[2] > 0]
        if not ranges:
            return None
        target, start, size, member = ranges[0]
        offset = start + min(int(frac * size), size - 1)
        record["file"] = os.path.relpath(target, directory)
        record["member"] = member
        record["offset"] = offset
        with open(target, "r+b") as f:
            if cls == "payload_flip":
                f.seek(offset)
                b = f.read(1)
                f.seek(offset)
                f.write(bytes([b[0] ^ 0xFF]))
            else:
                f.truncate(offset)
    elif cls == "meta_flip":
        # the newest round that has a meta (the newest dir may lack one
        # when a kill landed inside the commit window)
        metas = _meta_rounds(directory)
        if not metas:
            return None
        record["round"] = int(metas[-1])
        meta_path = _meta_path(directory, metas[-1])
        # rot one hex digit of the committed digest: the smallest meta
        # flip that is sure to be detected
        with open(meta_path, "rb") as f:
            raw = bytearray(f.read())
        tag = b'"digest": "'
        idx = raw.find(tag)
        if idx < 0:
            return None
        pos = idx + len(tag) + min(int(frac * 64), 63)
        raw[pos] = ord(_rot_hex(chr(raw[pos])))
        record["offset"] = pos
        with open(meta_path, "wb") as f:
            f.write(raw)
    elif cls == "ledger":
        metas = _meta_rounds(directory)
        if not metas:
            return None
        newest = metas[-1]
        record["round"] = int(newest)
        meta_path = _meta_path(directory, newest)
        meta = _read_meta(directory, newest)
        if not meta or not meta.get("ledger"):
            return None
        try:
            rows = json.loads(meta["ledger"])
        except (ValueError, TypeError):
            return None
        if not rows:
            return None
        i = min(int(frac * len(rows)), len(rows) - 1)
        rows[i]["head"] = _rot_hex(rows[i]["head"][0]) + rows[i]["head"][1:]
        meta["ledger"] = json.dumps(rows)
        record["row"] = i
        with open(meta_path, "w") as f:
            json.dump(meta, f)
    elif cls == "delete":
        k = max(1, int(action.get("delete_last", 1)))
        victims = rounds[-k:]
        for r in victims:
            _remove_round(directory, r, keep_meta=True)
        record["rounds"] = [int(r) for r in victims]
    elif cls == "rollback":
        _remove_round(directory, newest, keep_meta=False)
        record["now_newest"] = int(rounds[-2]) if len(rounds) > 1 else None
    else:
        raise ValueError(f"unknown storage damage class {cls!r}")
    _fsync_dir(directory)
    return record
