"""Live run monitoring (port of ``bcfl_tpu/telemetry/live.py``, host-only,
the same checks, health records, alerts and exit codes): incremental
collation, streaming invariants and the per-round health series
(OBSERVABILITY.md §6).

The batch collator (:mod:`bcfl_tpu_torch.telemetry.collate`) loads every
stream, sorts the world and renders a verdict after the run ends. This
module watches a run that is still going, in three layers:

- **StreamTailer / LiveCollator**: incremental readers over the same
  ``events_*.jsonl`` streams the batch collator reads: remembered file
  offsets, torn tails held until they complete (an in-progress write is
  *pending*, not corrupt), streams picked up when they appear mid-run, and
  a finalize meta equal to :func:`collate.read_stream`'s on any closed
  stream. Memory is O(live identities), never O(stream bytes).
- **Streaming invariants**: incremental forms of the
  :mod:`invariants` checks with windowed state. Violations are emitted
  the moment they become decidable. Parity contract: on any closed stream
  set, ``StreamingInvariantSuite.finalize`` equals
  ``run_invariants(causal_order(events))``, because every batch check is
  either order-independent set accumulation or scoped to one (peer, pid)
  stream whose file order is its seq order
  (``tests/test_torch_live.py`` holds it against the JAX package under
  adversarial chunk boundaries).
- **Health and alerts**: a ``health.jsonl`` record per merge (the global
  round clock): round wall, bytes on wire, staleness p50/p95, the
  merge-weight distribution, quorum state, per-peer trust, the merged
  adapter's effective rank when LoRA is on, and the latest host-resource
  samples. Threshold alerts have an explicit fire/heal lifecycle; only
  *unhealed critical* alerts (and invariant violations) gate the
  monitor's exit code, so an expected byzantine quarantine (trust_low,
  a warn) never fails a run.

The monitor writes its health and alert events through its OWN
:class:`~bcfl_tpu_torch.telemetry.events.EventWriter` at ``health.jsonl``,
a name outside the ``events_*.jsonl`` glob, so the batch collator never
reads the observer's observations.

``python -m bcfl_tpu_torch.entrypoints monitor RUN_DIR``
(:func:`monitor_main`) is the CLI.
"""

from __future__ import annotations

import heapq
import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from bcfl_tpu_torch.telemetry import events as _telemetry
from bcfl_tpu_torch.telemetry.collate import find_streams
from bcfl_tpu_torch.telemetry.invariants import (
    ACK_GRACE_S,
    INVARIANTS,
    MERGE_EVS,
)


# ----------------------------------------------------------------- tailing


class StreamTailer:
    """Incremental reader of ONE append-only JSONL stream.

    Remembers its byte offset between polls; bytes after the last newline
    are held *pending* (an in-progress write — possibly a torn tail that a
    later append completes, possibly the file's final partial line). A
    complete nonempty line either parses to an event or counts toward the
    corrupt/torn meta exactly the way :func:`collate.read_stream` counts
    it: at :meth:`finalize`, a nonempty pending tail that parses is one
    more event, an unparseable one is the torn tail, and a *newline-
    terminated* garbage line that is still the stream's last nonempty line
    is ALSO the torn tail (a predecessor's torn write that an append-mode
    reopen newline-terminated), not a corrupt line."""

    def __init__(self, path: str):
        self.path = path
        self.offset = 0
        self.events = 0
        self._pending = b""
        self._bad_complete = 0        # complete nonempty lines that failed
        self._last_nonempty_bad = False   # ...and the latest one did
        self._finalized: Optional[Dict] = None

    def _parse(self, ln: bytes) -> Optional[Dict]:
        try:
            e = json.loads(ln)
            if not isinstance(e, dict):
                raise ValueError("event is not an object")
            return e
        except (ValueError, UnicodeDecodeError):
            return None

    def feed_bytes(self, chunk: bytes) -> List[Dict]:
        """Consume a byte chunk at ANY boundary (mid-line, mid-frame, one
        byte at a time) and return the newly completed events in file
        order."""
        buf = self._pending + chunk
        lines = buf.split(b"\n")
        self._pending = lines.pop()   # bytes after the last newline
        out: List[Dict] = []
        for ln in lines:
            if not ln.strip():
                continue
            e = self._parse(ln)
            if e is None:
                self._bad_complete += 1
                self._last_nonempty_bad = True
            else:
                self._last_nonempty_bad = False
                self.events += 1
                out.append(e)
        return out

    def poll(self, chunk_bytes: int = 1 << 20) -> List[Dict]:
        """Read whatever the file has grown by since the last poll (in
        bounded chunks) and return the newly completed events."""
        out: List[Dict] = []
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return out
        while self.offset < size:
            with open(self.path, "rb") as f:
                f.seek(self.offset)
                chunk = f.read(min(chunk_bytes, size - self.offset))
            if not chunk:
                break
            self.offset += len(chunk)
            out.extend(self.feed_bytes(chunk))
        return out

    @property
    def corrupt_so_far(self) -> int:
        """Lines that are *definitely* corrupt right now: a bad line that
        is still the stream's last nonempty line may yet be the torn tail,
        so it is excluded until another line lands after it."""
        return self._bad_complete - (1 if self._last_nonempty_bad else 0)

    def finalize(self) -> Tuple[Optional[Dict], Dict]:
        """End-of-stream accounting. Returns ``(tail_event, meta)`` where
        ``tail_event`` is the pending line's event when it parses without
        a trailing newline (read_stream counts it), and ``meta`` matches
        :func:`collate.read_stream`'s meta for the same bytes."""
        if self._finalized is not None:
            return None, self._finalized
        tail_event = None
        torn = False
        corrupt = self._bad_complete
        if self._pending.strip():
            e = self._parse(self._pending)
            if e is None:
                torn = True
            else:
                tail_event = e
                self.events += 1
        elif self._last_nonempty_bad:
            # the final nonempty line was newline-terminated garbage:
            # read_stream classifies the LAST nonempty line as the torn
            # tail wherever the newline ended up
            torn = True
            corrupt -= 1
        self._finalized = {"path": self.path, "events": self.events,
                           "torn_tail": torn, "corrupt_lines": corrupt}
        return tail_event, self._finalized


# ----------------------------------------------- streaming invariant checks


class _StreamingCheck:
    """One incremental invariant. ``feed`` returns violations that became
    decidable on this event; ``finalize`` completes end-of-stream judgment
    and returns the FULL final violation list (parity with the batch
    check). ``out`` always holds the current believed list."""

    name = ""

    def __init__(self):
        self.out: List[Dict] = []

    def feed(self, e: Dict) -> List[Dict]:
        raise NotImplementedError

    def finalize(self) -> List[Dict]:
        return self.out


class SNoDoubleMerge(_StreamingCheck):
    name = "no_double_merge"

    def __init__(self):
        super().__init__()
        self._seen: Dict = {}   # ((leader, pid), peer, epoch, id) -> version

    def feed(self, e: Dict) -> List[Dict]:
        if e.get("ev") not in MERGE_EVS:
            return []
        leader = (e.get("peer"), e.get("pid"))
        new: List[Dict] = []
        for a in e.get("arrivals") or []:
            if a.get("msg_id") is None:
                new.append({
                    "rule": self.name,
                    "problem": "merged arrival without (msg_epoch, msg_id) "
                               "identity",
                    "leader": leader[0], "leader_pid": leader[1],
                    "version": e.get("version"), "arrival": a})
                continue
            key = (leader, a.get("peer"), a.get("msg_epoch"),
                   a.get("msg_id"))
            if key in self._seen:
                new.append({
                    "rule": self.name,
                    "problem": "update identity merged twice",
                    "leader": leader[0], "leader_pid": leader[1],
                    "key": list(key[1:]),
                    "first_version": self._seen[key],
                    "second_version": e.get("version")})
            else:
                self._seen[key] = e.get("version")
        self.out.extend(new)
        return new


class SAckedNotLost(_StreamingCheck):
    """Windowed form of ``acked_not_lost``: an *acked-awaiting-recv* map
    keyed ``(dst, src, epoch, msg_id)``, evicted the moment the matching
    recv lands (so memory tracks in-flight identities, not history). A
    send becomes judgeable when its receiver's stream closes (``run.end``
    — per-stream file order guarantees every flushed recv was already
    fed), with the same grace window and single-incarnation scoping the
    batch check applies. A second pid appearing later in the receiver's
    stream retracts any fired verdicts against it (the batch check skips
    restarted receivers entirely); ``finalize`` recomputes the exact
    batch judgment from the retained state."""

    name = "acked_not_lost"

    def __init__(self):
        super().__init__()
        self._recv_seen: Dict = {}   # peer -> {(src, epoch, id)}
        self._closed_at: Dict = {}   # peer -> last run.end t_wall
        self._pids: Dict = {}        # peer -> {pid}
        self._unmatched: Dict = {}   # (dst, src, epoch, id) -> [send rec]

    def _violation(self, r: Dict) -> Dict:
        return {"rule": self.name,
                "problem": "acked send never appeared in the receiver's "
                           "stream",
                "src": r["src"], "dst": r["dst"],
                "msg_epoch": r["msg_epoch"], "msg_id": r["msg_id"],
                "type": r["type"]}

    def _judge(self, r: Dict) -> bool:
        end = self._closed_at.get(r["dst"])
        if end is None or r["sent_done"] > end - ACK_GRACE_S:
            return False
        if len(self._pids.get(r["dst"], ())) > 1:
            return False
        return ((r["src"], r["msg_epoch"], r["msg_id"])
                not in self._recv_seen.get(r["dst"], ()))

    def feed(self, e: Dict) -> List[Dict]:
        new: List[Dict] = []
        ev = e.get("ev")
        p = e.get("peer")
        pid = e.get("pid")
        if pid is not None:
            s = self._pids.setdefault(p, set())
            if pid not in s:
                s.add(pid)
                if len(s) > 1 and any(v["dst"] == p for v in self.out):
                    # the receiver restarted: its kill window is no longer
                    # provable — retract every live verdict against it
                    self.out = [v for v in self.out if v["dst"] != p]
        if ev == "recv" and e.get("msg_id") is not None:
            ident = (e.get("src"), e.get("msg_epoch"), e.get("msg_id"))
            self._recv_seen.setdefault(p, set()).add(ident)
            self._unmatched.pop((p,) + ident, None)
        elif ev == "run.end":
            self._closed_at[p] = e.get("t_wall", 0.0)
            for key, recs in self._unmatched.items():
                if key[0] != p:
                    continue
                for r in recs:
                    if not r.get("fired") and self._judge(r):
                        r["fired"] = True
                        new.append(self._violation(r))
        elif ev == "send" and e.get("ok") and e.get("msg_id") is not None:
            r = {"src": p, "dst": e.get("to"),
                 "msg_epoch": e.get("msg_epoch"), "msg_id": e.get("msg_id"),
                 "type": e.get("type"),
                 "sent_done": (e.get("t_wall") or 0.0)
                              + (e.get("wall_s") or 0.0)}
            self._unmatched.setdefault(
                (r["dst"], p, r["msg_epoch"], r["msg_id"]), []).append(r)
            if r["dst"] in self._closed_at and self._judge(r):
                r["fired"] = True
                new.append(self._violation(r))
        self.out.extend(new)
        return new

    def finalize(self) -> List[Dict]:
        # exact batch recomputation over the retained window: matched
        # sends were evicted (their key is in recv_seen — never a batch
        # violation), everything else is re-judged against final state
        out: List[Dict] = []
        for recs in self._unmatched.values():
            for r in recs:
                if self._judge(r):
                    out.append(self._violation(r))
        self.out = out
        return self.out


class SNoCrossPartitionMerge(_StreamingCheck):
    name = "no_cross_partition_merge"

    def feed(self, e: Dict) -> List[Dict]:
        if e.get("ev") not in MERGE_EVS:
            return []
        comp = e.get("component")
        if not comp:
            return []
        comp_set = set(comp)
        new = [{
            "rule": self.name,
            "problem": "merged an update from outside the leader's "
                       "component",
            "leader": e.get("peer"), "version": e.get("version"),
            "component": comp, "from_peer": a["peer"]}
            for a in e.get("arrivals") or []
            if a.get("peer") is not None and a["peer"] not in comp_set]
        self.out.extend(new)
        return new


class SQuarantineEvidence(_StreamingCheck):
    name = "quarantine_evidence"

    def __init__(self):
        super().__init__()
        self._evidenced: set = set()

    def feed(self, e: Dict) -> List[Dict]:
        ev = e.get("ev")
        if ev == "rep.evidence":
            self._evidenced.add((e.get("peer"), e.get("client")))
            return []
        if ev == "rep.transition" and e.get("to") == "quarantined":
            if e.get("from") == "restored":
                # re-declaration of restored state, evidenced at the
                # original decision site (possibly another process's
                # stream) — same exemption as the batch check
                return []
            key = (e.get("peer"), e.get("client"))
            if key not in self._evidenced:
                v = {"rule": self.name,
                     "problem": "quarantined with no prior evidence event",
                     "peer": key[0], "client": key[1],
                     "trust": e.get("trust")}
                self.out.append(v)
                return [v]
        return []


class SMonotoneHeads(_StreamingCheck):
    name = "monotone_heads"

    def __init__(self):
        super().__init__()
        self._last: Dict = {}   # (peer, pid) -> last chain_len

    def feed(self, e: Dict) -> List[Dict]:
        if "chain_len" not in e:
            return []
        n = e.get("chain_len")
        if n is None:
            return []
        p = (e.get("peer"), e.get("pid"))
        prev = self._last.get(p)
        self._last[p] = n
        if prev is not None and n < prev and not e.get("rewrite"):
            v = {"rule": self.name,
                 "problem": "ledger chain shrank outside a declared "
                            "rewrite",
                 "peer": p[0], "pid": p[1], "event": e.get("ev"),
                 "op": e.get("op"), "prev_len": prev, "new_len": n}
            self.out.append(v)
            return [v]
        return []


class SNoQuarantinedMerge(_StreamingCheck):
    name = "no_quarantined_merge"

    def __init__(self):
        super().__init__()
        self._quarantined: Dict = {}   # (peer, pid) -> {peer ids}

    def feed(self, e: Dict) -> List[Dict]:
        key = (e.get("peer"), e.get("pid"))
        ev = e.get("ev")
        if ev == "rep.transition" and e.get("scope") == "peer":
            q = self._quarantined.setdefault(key, set())
            if e.get("to") == "quarantined":
                q.add(e.get("client"))
            else:
                q.discard(e.get("client"))
            return []
        if ev not in MERGE_EVS:
            return []
        q = self._quarantined.get(key)
        if not q:
            return []
        new = [{
            "rule": self.name,
            "problem": "merged an arrival from a peer quarantined at "
                       "this leader",
            "leader": key[0], "leader_pid": key[1],
            "version": e.get("version"), "from_peer": a.get("peer"),
            "arrival": a}
            for a in e.get("arrivals") or [] if a.get("peer") in q]
        self.out.extend(new)
        return new


class SRepairAuthenticated(_StreamingCheck):
    name = "repair_authenticated"

    def __init__(self):
        super().__init__()
        self._pending: Dict = {}   # (peer, pid) -> unconsumed verified-ok

    def feed(self, e: Dict) -> List[Dict]:
        ev = e.get("ev")
        if ev not in ("state.sync.verify", "state.sync.adopt"):
            return []
        key = (e.get("peer"), e.get("pid"))
        if ev == "state.sync.verify":
            if e.get("ok"):
                self._pending[key] = self._pending.get(key, 0) + 1
            return []
        if self._pending.get(key, 0) > 0:
            self._pending[key] -= 1
            return []
        v = {"rule": self.name,
             "problem": "state adopted without a preceding verified-ok "
                        "STATE_SYNC in this incarnation",
             "peer": key[0], "pid": key[1],
             "version": e.get("version"), "src": e.get("src")}
        self.out.append(v)
        return [v]


class SNoRollbackReadmission(_StreamingCheck):
    name = "no_rollback_readmission"

    def __init__(self):
        super().__init__()
        self._hw: Dict = {}      # peer -> (max chain_len, pid)
        self._exempt: set = set()  # (peer, pid) that repaired/resynced

    def feed(self, e: Dict) -> List[Dict]:
        ev = e.get("ev")
        p = e.get("peer")
        key = (p, e.get("pid"))
        if ev == "state.sync.adopt" or (ev == "ledger"
                                        and e.get("op") == "resync"):
            self._exempt.add(key)
            return []
        if ev != "ckpt.save":
            return []
        n = e.get("chain_len")
        if n is None:
            return []
        prev = self._hw.get(p)
        new: List[Dict] = []
        if (prev is not None and n < prev[0] and e.get("pid") != prev[1]
                and key not in self._exempt):
            new.append({
                "rule": self.name,
                "problem": "restarted peer persisted a chain below an "
                           "earlier incarnation's committed high-water "
                           "without repairing forward",
                "peer": p, "pid": e.get("pid"),
                "prev_len": prev[0], "prev_pid": prev[1], "new_len": n})
        if prev is None or n >= prev[0]:
            self._hw[p] = (n, e.get("pid"))
        self.out.extend(new)
        return new


class SSlownessIsNotMalice(_StreamingCheck):
    name = "slowness_is_not_malice"

    def __init__(self):
        super().__init__()
        # (stream peer, target) with non-slowness dist evidence seen
        self._malice: set = set()

    def feed(self, e: Dict) -> List[Dict]:
        ev = e.get("ev")
        if ev == "rep.dist_evidence":
            if e.get("source") != "slowness":
                self._malice.add((e.get("peer"), e.get("target")))
            return []
        if (ev == "rep.transition" and e.get("to") == "quarantined"
                and e.get("scope") == "peer"
                and e.get("from") != "restored"):
            key = (e.get("peer"), e.get("client"))
            if key not in self._malice:
                v = {"rule": self.name,
                     "problem": "peer quarantined with no prior "
                                "non-slowness dist evidence — an "
                                "honest-slow peer was treated as "
                                "malicious",
                     "peer": key[0], "target": key[1],
                     "trust": e.get("trust")}
                self.out.append(v)
                return [v]
        return []


class SPartitionHealsLeaderless(_StreamingCheck):
    """Streaming form of ``partition_heals_leaderless``. All state is
    per (peer, pid) stream — file order IS seq order, so the span
    machine (fork.begin → fork.heal → post-heal contact → run.end) feeds
    exactly as the batch check walks it. The judgment itself is only
    decidable at end of stream (a span still awaiting contact may yet
    get it, and an unterminated stream is exempt), so ``feed`` only
    accumulates and ``finalize`` renders the exact batch verdict —
    sorted the same way, so the parity contract holds regardless of
    which stream the live collator opened first."""

    name = "partition_heals_leaderless"

    def __init__(self):
        super().__init__()
        self._streams: Dict = {}   # (peer, pid) -> state

    def feed(self, e: Dict) -> List[Dict]:
        key = (e.get("peer"), e.get("pid"))
        st = self._streams.setdefault(key, {"open": None, "awaiting": [],
                                            "closed": False, "spans": [],
                                            "peers": None})
        ev = e.get("ev")
        if ev == "run.start":
            if e.get("peers") is not None:
                st["peers"] = e.get("peers")
        elif ev == "fork.begin" and e.get("leaderless"):
            span = {"component": set(e.get("component") or ()),
                    "at_version": e.get("at_version"),
                    "healed": False, "contact": False}
            st["spans"].append(span)
            st["open"] = span
        elif ev == "fork.heal" and st["open"] is not None:
            st["open"]["healed"] = True
            st["awaiting"].append(st["open"])
            st["open"] = None
        elif ev == "run.end":
            st["closed"] = True
        elif st["awaiting"]:
            touched = []
            if ev == "send":
                touched = [e.get("to")]
            elif ev == "recv" and e.get("disposition") == "accepted":
                touched = [e.get("src")]
            elif ev == "membership.join":
                touched = [e.get("member")]
            elif ev in MERGE_EVS:
                touched = [a.get("peer") for a in e.get("arrivals") or []]
            if touched:
                still = []
                for span in st["awaiting"]:
                    if any(p is not None and p not in span["component"]
                           for p in touched):
                        span["contact"] = True
                    else:
                        still.append(span)
                st["awaiting"] = still
        return []

    def finalize(self) -> List[Dict]:
        out: List[Dict] = []
        for (peer, pid), st in self._streams.items():
            if not st["closed"]:
                continue
            for span in st["spans"]:
                n = st["peers"]
                no_outside = (n is not None
                              and len(span["component"]) >= n)
                if not span["healed"]:
                    out.append({
                        "rule": self.name,
                        "problem": "leaderless partition span never "
                                   "healed before the peer's clean close",
                        "peer": peer, "pid": pid,
                        "at_version": span["at_version"],
                        "component": sorted(span["component"])})
                elif not span["contact"] and not no_outside:
                    out.append({
                        "rule": self.name,
                        "problem": "no cross-component contact after the "
                                   "leaderless heal — anti-entropy never "
                                   "attempted",
                        "peer": peer, "pid": pid,
                        "at_version": span["at_version"],
                        "component": sorted(span["component"])})
        out.sort(key=lambda v: (str(v["peer"]), str(v["pid"]),
                                v["at_version"]
                                if v["at_version"] is not None else -1,
                                v["problem"]))
        self.out = out
        return self.out


# registry mirrors invariants.INVARIANTS key-for-key (tested)
STREAMING_CHECKS = {c.name: c for c in (
    SNoDoubleMerge, SAckedNotLost, SNoCrossPartitionMerge,
    SQuarantineEvidence, SMonotoneHeads, SNoQuarantinedMerge,
    SRepairAuthenticated, SNoRollbackReadmission, SSlownessIsNotMalice,
    SPartitionHealsLeaderless)}


class StreamingInvariantSuite:
    """All streaming checks behind one feed. Events must arrive in file
    order *per stream*; interleaving across streams is free (every check
    is either order-independent or single-stream-scoped — the parity
    contract in the module docstring)."""

    def __init__(self, names=None):
        picked = STREAMING_CHECKS if names is None else {
            n: STREAMING_CHECKS[n] for n in names}
        self.checks = {name: cls() for name, cls in picked.items()}
        self._finalized: Optional[Dict[str, List[Dict]]] = None

    def feed(self, e: Dict) -> List[Dict]:
        new: List[Dict] = []
        for c in self.checks.values():
            new.extend(c.feed(e))
        return new

    def current(self) -> Dict[str, List[Dict]]:
        return {name: list(c.out) for name, c in self.checks.items()}

    def total(self) -> int:
        return sum(len(c.out) for c in self.checks.values())

    def finalize(self) -> Dict[str, List[Dict]]:
        if self._finalized is None:
            self._finalized = {name: c.finalize()
                               for name, c in self.checks.items()}
        return self._finalized


# ------------------------------------------------------------ live ordering


class OrderedFrontier:
    """Low-watermark merge of per-stream event feeds into a near-causal
    live timeline: an event is released once every still-open stream has
    been read past its wall instant, so per-stream order is always exact
    and cross-stream order matches the batch heap's wall-time priority on
    unskewed clocks. This is the *live view* (``monitor --dump``); the
    batch collator's seq+identity-edge order stays authoritative."""

    def __init__(self):
        self._heap: List = []
        self._n = 0
        self._last: Dict[str, float] = {}
        self._closed: set = set()

    def push(self, stream: str, e: Dict) -> None:
        t = e.get("t_wall") or 0.0
        heapq.heappush(self._heap, ((t, str(e.get("peer")),
                                     e.get("seq") or 0, self._n), e))
        self._n += 1
        self._last[stream] = t
        if e.get("ev") == "run.end":
            self._closed.add(stream)
        else:
            self._closed.discard(stream)   # append-mode restart reopened it

    def drain(self, final: bool = False) -> List[Dict]:
        if final:
            wm = None
        else:
            open_last = [t for s, t in self._last.items()
                         if s not in self._closed]
            if open_last:
                wm = min(open_last)
            elif self._last:
                wm = None      # every stream closed: release everything
            else:
                return []
        out: List[Dict] = []
        while self._heap and (wm is None or self._heap[0][0][0] <= wm):
            out.append(heapq.heappop(self._heap)[1])
        return out


# -------------------------------------------------------- health and alerts


INFO, WARN, CRITICAL = "info", "warn", "critical"
_SEV_RANK = {INFO: 0, WARN: 1, CRITICAL: 2}


@dataclass
class AlertThresholds:
    """Knobs for the monitor's threshold alerting (CLI-overridable).
    Severities are chosen so an EXPECTED long-run condition never gates the
    exit code: a quarantined adversary's trust collapse is a warn; only
    stalls, runaway memory, and invariant violations are critical."""

    round_stall_warn_s: float = 60.0      # gap between merges
    round_stall_critical_s: float = 180.0
    staleness_p95_warn: float = 12.0      # merge staleness, window p95
    trust_warn: float = 0.35              # per-peer trust floor
    rss_critical_gb: float = 24.0         # per-peer resident set
    corrupt_lines_warn: int = 1           # definite mid-stream damage
    # free space on the filesystem holding the run dir (resource samples
    # carry disk_free_gb when ResourceMonitor was given the run_dir) —
    # the ENOSPC ladder's leading indicator. Warn early, critical when a
    # checkpoint-sized write is plausibly about to fail.
    disk_low_warn_gb: float = 2.0
    disk_low_critical_gb: float = 0.5


class AlertManager:
    """Keyed alert lifecycle: ``(what, key)`` fires once on the rising
    edge and heals once (``healed=True``) on the falling edge; a severity
    escalation (warn → critical) re-fires. ``unhealed(CRITICAL)`` is the
    exit-code gate."""

    def __init__(self, thresholds: Optional[AlertThresholds] = None):
        self.thresholds = thresholds or AlertThresholds()
        self._active: Dict[Tuple[str, Optional[str]], str] = {}
        self.fired = 0
        self.healed = 0

    def set_state(self, what: str, key, firing: bool,
                  severity: str = WARN, **fields) -> List[Dict]:
        k = (what, None if key is None else str(key))
        out: List[Dict] = []
        if firing:
            prev = self._active.get(k)
            if prev is None or _SEV_RANK[severity] > _SEV_RANK[prev]:
                self._active[k] = severity
                self.fired += 1
                out.append({"what": what, "severity": severity,
                            "key": k[1], **fields})
        elif k in self._active:
            sev = self._active.pop(k)
            self.healed += 1
            out.append({"what": what, "severity": sev, "key": k[1],
                        "healed": True, **fields})
        return out

    def unhealed(self, severity: Optional[str] = None) -> List[Dict]:
        return [{"what": w, "key": k, "severity": s}
                for (w, k), s in sorted(self._active.items(),
                                        key=lambda x: (x[0][0], str(x[0][1])))
                if severity is None or s == severity]


def _pctile(sorted_xs: List[float], q: float) -> Optional[float]:
    if not sorted_xs:
        return None
    i = min(len(sorted_xs) - 1, int(round(q * (len(sorted_xs) - 1))))
    return sorted_xs[i]


class HealthRollup:
    """Per-round health series: one record per ``merge`` event (the global
    round clock), folding in everything seen since the previous one —
    bytes on wire, accepted deliveries, the staleness window, the latest
    per-peer trust and host-resource samples."""

    def __init__(self, window: int = 256):
        from collections import deque
        self._staleness = deque(maxlen=window)
        self._bytes = 0
        self._sends_ok = 0
        self._recv_accepted = 0
        self._resource: Dict[str, Dict] = {}
        self._trust: Dict[str, float] = {}
        self.last_merge_t: Optional[float] = None
        self.records = 0

    def feed(self, e: Dict) -> Optional[Dict]:
        ev = e.get("ev")
        if ev == "send" and e.get("ok"):
            self._sends_ok += 1
            try:
                self._bytes += int(e.get("bytes") or 0)
            except (TypeError, ValueError):
                pass
        elif ev == "recv" and e.get("disposition") == "accepted":
            self._recv_accepted += 1
        elif ev == "resource":
            self._resource[str(e.get("peer"))] = {
                "rss_gb": e.get("rss_gb"),
                "cpu_percent": e.get("cpu_percent"),
                "disk_free_gb": e.get("disk_free_gb")}
        elif ev == "rep.transition" and e.get("scope") == "peer":
            if e.get("trust") is not None:
                try:
                    self._trust[str(e.get("client"))] = float(e["trust"])
                except (TypeError, ValueError):
                    pass
        elif ev in MERGE_EVS:
            # under gossip dispatch every peer's merge feeds the series
            # (the "round clock" is the union of per-peer merge clocks) —
            # in particular the monitor's wall-stall watchdog keys on
            # last_merge_t, and a leaderless run has no single leader
            # whose "merge" events could keep it fed
            return self._merge_record(e)
        return None

    def _merge_record(self, e: Dict) -> Dict:
        arrivals = e.get("arrivals") or []
        for a in arrivals:
            if a.get("staleness") is not None:
                self._staleness.append(float(a["staleness"]))
        if isinstance(e.get("trust"), dict):
            for k, v in e["trust"].items():
                try:
                    self._trust[str(k)] = float(v)
                except (TypeError, ValueError):
                    pass
        weights = [float(a["weight"]) for a in arrivals
                   if a.get("weight") is not None]
        t = e.get("t_wall")
        gap = (t - self.last_merge_t
               if t is not None and self.last_merge_t is not None else None)
        if t is not None:
            self.last_merge_t = t
        stal = sorted(self._staleness)
        rec = {
            "round": e.get("version"), "leader": e.get("peer"),
            "t_wall": t, "wall_s": e.get("wall_s"), "round_gap_s": gap,
            "arrivals": len(arrivals),
            "rejected": len(e.get("rejected") or []),
            "solo": bool(e.get("solo")), "degraded": bool(e.get("degraded")),
            "quorum": e.get("quorum"),
            "component": len(e.get("component") or []),
            "bytes_wire": self._bytes, "sends_ok": self._sends_ok,
            "recv_accepted": self._recv_accepted,
            "staleness_p50": _pctile(stal, 0.5),
            "staleness_p95": _pctile(stal, 0.95),
            "weight_min": min(weights) if weights else None,
            "weight_mean": (sum(weights) / len(weights)
                            if weights else None),
            "weight_max": max(weights) if weights else None,
            "trust": dict(self._trust) or None,
            "effective_rank": e.get("effective_rank"),
            "resource": ({k: dict(v) for k, v in self._resource.items()}
                         or None),
        }
        self._bytes = self._sends_ok = self._recv_accepted = 0
        self.records += 1
        return rec


def evaluate_health_alerts(alerts: AlertManager, rec: Dict) -> List[Dict]:
    """Fold one health record into the alert lifecycle; returns the alert
    records (fires + heals) this record caused."""
    th = alerts.thresholds
    out: List[Dict] = []
    gap = rec.get("round_gap_s")
    if gap is not None:
        sev = (CRITICAL if gap >= th.round_stall_critical_s
               else WARN if gap >= th.round_stall_warn_s else None)
        out.extend(alerts.set_state(
            "round_stall", rec.get("leader"), sev is not None, sev or WARN,
            round=rec.get("round"), gap_s=gap))
    p95 = rec.get("staleness_p95")
    out.extend(alerts.set_state(
        "staleness_high", rec.get("leader"),
        p95 is not None and p95 >= th.staleness_p95_warn, WARN,
        round=rec.get("round"), staleness_p95=p95))
    for peer, tr in (rec.get("trust") or {}).items():
        out.extend(alerts.set_state(
            "trust_low", peer, tr < th.trust_warn, WARN,
            round=rec.get("round"), trust=tr))
    for peer, r in (rec.get("resource") or {}).items():
        rss = r.get("rss_gb")
        out.extend(alerts.set_state(
            "rss_high", peer, rss is not None and rss >= th.rss_critical_gb,
            CRITICAL, round=rec.get("round"), rss_gb=rss))
        free = r.get("disk_free_gb")
        if free is not None:
            sev = (CRITICAL if free <= th.disk_low_critical_gb
                   else WARN if free <= th.disk_low_warn_gb else None)
            out.extend(alerts.set_state(
                "disk_low", peer, sev is not None, sev or WARN,
                round=rec.get("round"), disk_free_gb=free))
    return out


# ----------------------------------------------------------- live collator


class LiveCollator:
    """The monitor's engine: discovers ``events_*.jsonl`` streams under
    ``run_dir`` as they appear, tails each incrementally, and feeds every
    completed event through the streaming invariant suite, the health
    rollup, the alert lifecycle, and (optionally) the ordered live
    frontier. Health and alert records are also emitted through the
    process telemetry seam when a writer is installed — that is how
    ``health.jsonl`` gets written."""

    def __init__(self, run_dir: str, invariant_names=None,
                 thresholds: Optional[AlertThresholds] = None,
                 window: int = 256,
                 on_ordered: Optional[Callable[[Dict], None]] = None):
        self.run_dir = run_dir
        self.tailers: Dict[str, StreamTailer] = {}
        self.suite = StreamingInvariantSuite(invariant_names)
        self.health = HealthRollup(window)
        self.alerts = AlertManager(thresholds)
        self.frontier = OrderedFrontier() if on_ordered else None
        self._on_ordered = on_ordered
        self._closed: set = set()    # stream paths whose run.end was read
        self.events = 0
        self.runs: set = set()
        self._vio_n = 0
        self._summary: Optional[Dict] = None

    # one event through every consumer
    def _feed(self, path: str, e: Dict, res: Dict) -> None:
        self.events += 1
        if e.get("run") is not None:
            self.runs.add(str(e.get("run")))
        if e.get("ev") == "run.end":
            self._closed.add(path)
        elif path in self._closed:
            self._closed.discard(path)   # a restart reopened the stream
        for v in self.suite.feed(e):
            res["violations"].append(v)
            self._vio_n += 1
            # an invariant violation is by definition critical and never
            # heals — the run's delivery contract is already broken
            res["alerts"].extend(self.alerts.set_state(
                "invariant_violation", f"{v.get('rule')}:{self._vio_n}",
                True, CRITICAL, rule=v.get("rule")))
        rec = self.health.feed(e)
        if rec is not None:
            res["health"].append(rec)
            res["alerts"].extend(evaluate_health_alerts(self.alerts, rec))
        if self.frontier is not None:
            self.frontier.push(path, e)

    def sweep(self) -> Dict:
        """One poll across every stream. Returns what changed:
        ``{"new_events", "violations", "health", "alerts"}``."""
        res: Dict = {"new_events": 0, "violations": [], "health": [],
                     "alerts": []}
        for path in find_streams(self.run_dir):
            t = self.tailers.get(path)
            if t is None:
                t = self.tailers[path] = StreamTailer(path)
            for e in t.poll():
                res["new_events"] += 1
                self._feed(path, e, res)
        for path, t in self.tailers.items():
            res["alerts"].extend(self.alerts.set_state(
                "stream_corrupt", path,
                t.corrupt_so_far >= self.alerts.thresholds.corrupt_lines_warn,
                WARN, corrupt_lines=t.corrupt_so_far))
        self._emit(res)
        if self.frontier is not None:
            for e in self.frontier.drain():
                self._on_ordered(e)
        return res

    def _emit(self, res: Dict) -> None:
        # through the module seam: a no-op unless the monitor installed
        # its own writer (monitor_main does, at health.jsonl)
        for rec in res["health"]:
            _telemetry.emit("health", round=rec.get("round"),
                            **{k: v for k, v in rec.items() if k != "round"})
        for a in res["alerts"]:
            _telemetry.emit("alert", what=a.get("what"),
                            severity=a.get("severity"),
                            **{k: v for k, v in a.items()
                               if k not in ("what", "severity")})

    def all_closed(self) -> bool:
        """Every discovered stream has been read through its run.end."""
        return bool(self.tailers) and all(
            p in self._closed for p in self.tailers)

    def finalize(self) -> Dict:
        """Final sweep + end-of-stream judgment; returns the monitor
        summary (same verdict fields the batch ``trace`` reports)."""
        if self._summary is not None:
            return self._summary
        self.sweep()
        # a parseable unterminated final line IS an event (read_stream
        # counts it) — fed through the same pipeline, then emitted
        tail_res: Dict = {"new_events": 0, "violations": [], "health": [],
                          "alerts": []}
        metas = []
        for path in sorted(self.tailers):
            t = self.tailers[path]
            tail_e, meta = t.finalize()
            if tail_e is not None:
                self._feed(path, tail_e, tail_res)
            metas.append(meta)
        self._emit(tail_res)
        violations = self.suite.finalize()
        total = sum(len(v) for v in violations.values())
        unhealed_critical = [a for a in self.alerts.unhealed(CRITICAL)
                             if a["what"] != "invariant_violation"]
        self._summary = {
            "run_dir": self.run_dir,
            "streams": metas,
            "events": self.events,
            "runs": sorted(self.runs),
            "torn_tails": sum(1 for m in metas if m["torn_tail"]),
            "health_records": self.health.records,
            "invariants": {n: len(v) for n, v in violations.items()},
            "violations": {n: v[:20] for n, v in violations.items() if v},
            "invariant_violations_total": total,
            "alerts": {"fired": self.alerts.fired,
                       "healed": self.alerts.healed,
                       "active": self.alerts.unhealed(),
                       "unhealed_critical": unhealed_critical},
            "ok": total == 0 and not unhealed_critical,
        }
        return self._summary


# ---------------------------------------------------------------------- CLI


def monitor_main(argv=None) -> int:
    """``python -m bcfl_tpu_torch.entrypoints monitor RUN_DIR``: attach to
    a (possibly live) run's event streams, stream the invariant checks,
    write the ``health.jsonl`` per-round series, and exit 0 clean / 1 on
    any invariant violation or unhealed critical alert / 2 when no streams
    exist."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="bcfl_tpu_torch monitor",
        description="Live-monitor a run directory's events_*.jsonl "
                    "streams: incremental collation, streaming invariant "
                    "checks, per-round health series + threshold alerts "
                    "(OBSERVABILITY.md §6).")
    ap.add_argument("run_dir", help="directory holding events_*.jsonl "
                                    "streams (a dist run dir, or a "
                                    "FedConfig.telemetry_dir)")
    ap.add_argument("--poll", type=float, default=0.5,
                    help="seconds between sweeps (default 0.5)")
    ap.add_argument("--once", action="store_true",
                    help="one sweep + finalize (post-hoc streaming mode)")
    ap.add_argument("--max-wall", type=float, default=0.0,
                    help="hard cap on monitoring wall seconds (0 = none)")
    ap.add_argument("--idle", type=float, default=120.0,
                    help="finalize after this long with no new bytes "
                         "(covers SIGKILLed streams that never close)")
    ap.add_argument("--stop-file", default=None,
                    help="finalize once this path exists (whatever "
                         "runs the fleet touches it when the fleet is "
                         "done)")
    ap.add_argument("--fail-fast", action="store_true",
                    help="finalize and exit 1 on the FIRST violation "
                         "instead of watching the run to its end")
    ap.add_argument("--health-out", default=None,
                    help="health/alert event stream (default "
                         "RUN_DIR/health.jsonl; 'off' disables)")
    ap.add_argument("--summary-out", default=None,
                    help="also write the final summary JSON here")
    ap.add_argument("--dump", default=None, metavar="PATH",
                    help="append the live near-causal ordered timeline "
                         "(JSONL) here as it is released")
    ap.add_argument("--window", type=int, default=256,
                    help="staleness window size for health percentiles")
    ap.add_argument("--invariants", default=None,
                    help=f"comma subset of {sorted(INVARIANTS)} "
                         "(default: all)")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--stall-warn-s", type=float, default=None)
    ap.add_argument("--stall-critical-s", type=float, default=None)
    ap.add_argument("--staleness-p95-warn", type=float, default=None)
    ap.add_argument("--trust-warn", type=float, default=None)
    ap.add_argument("--rss-critical-gb", type=float, default=None)
    ap.add_argument("--disk-low-warn-gb", type=float, default=None)
    ap.add_argument("--disk-low-critical-gb", type=float, default=None)
    args = ap.parse_args(argv)

    names = None
    if args.invariants:
        names = [s.strip() for s in args.invariants.split(",") if s.strip()]
        bad = [s for s in names if s not in STREAMING_CHECKS]
        if bad:
            print(f"unknown invariants {bad}; known: "
                  f"{sorted(STREAMING_CHECKS)}")
            return 2
    th = AlertThresholds()
    for arg, field in (("stall_warn_s", "round_stall_warn_s"),
                       ("stall_critical_s", "round_stall_critical_s"),
                       ("staleness_p95_warn", "staleness_p95_warn"),
                       ("trust_warn", "trust_warn"),
                       ("rss_critical_gb", "rss_critical_gb"),
                       ("disk_low_warn_gb", "disk_low_warn_gb"),
                       ("disk_low_critical_gb", "disk_low_critical_gb")):
        v = getattr(args, arg)
        if v is not None:
            setattr(th, field, v)

    dump_f = open(args.dump, "a") if args.dump else None

    def on_ordered(e):
        dump_f.write(json.dumps(e) + "\n")

    health_path = args.health_out or os.path.join(args.run_dir,
                                                  "health.jsonl")
    if health_path != "off":
        # the monitor's OWN stream — flush_every=1 so a human can tail it
        _telemetry.install(_telemetry.EventWriter(
            health_path, run="monitor", flush_every=1))

    lc = LiveCollator(args.run_dir, invariant_names=names, thresholds=th,
                      window=args.window,
                      on_ordered=on_ordered if dump_f else None)
    t0 = time.time()
    last_new = t0
    try:
        while True:
            res = lc.sweep()
            now = time.time()
            if res["new_events"]:
                last_new = now
            if not args.quiet:
                for v in res["violations"]:
                    print(f"monitor: VIOLATION {v.get('rule')}: "
                          f"{v.get('problem')}", flush=True)
                for a in res["alerts"]:
                    tag = "healed" if a.get("healed") else a.get("severity")
                    print(f"monitor: alert[{tag}] {a.get('what')} "
                          f"key={a.get('key')}", flush=True)
            if args.once:
                break
            if args.fail_fast and lc.suite.total():
                break
            if lc.all_closed():
                break
            if args.stop_file and os.path.exists(args.stop_file):
                break
            if args.max_wall and now - t0 >= args.max_wall:
                break
            if args.idle and now - last_new >= args.idle:
                break
            # wall-clock stall watchdog: merges stopped arriving while
            # streams are still open (judged against the monitor's clock;
            # same host as the peers, so t_wall is comparable)
            ref = lc.health.last_merge_t or t0
            stall = now - ref
            sev = (CRITICAL if stall >= th.round_stall_critical_s
                   else WARN if stall >= th.round_stall_warn_s else None)
            stalled = lc.alerts.set_state(
                "round_stall", "wall", sev is not None, sev or WARN,
                gap_s=stall)
            if stalled:
                lc._emit({"health": [], "alerts": stalled})
                if not args.quiet:
                    for a in stalled:
                        tag = ("healed" if a.get("healed")
                               else a.get("severity"))
                        print(f"monitor: alert[{tag}] round_stall "
                              f"gap={stall:.0f}s", flush=True)
            time.sleep(args.poll)
        summary = lc.finalize()
        summary["wall_s"] = time.time() - t0
    finally:
        _telemetry.uninstall()
        if dump_f is not None:
            dump_f.close()
    out = json.dumps(summary, indent=2, default=str)
    if not args.quiet:
        print(out)
    if args.summary_out:
        with open(args.summary_out, "w") as f:
            f.write(out)
    if not lc.tailers:
        print(f"monitor: no events_*.jsonl streams under {args.run_dir}")
        return 2
    if not summary["ok"]:
        print(f"monitor: {summary['invariant_violations_total']} "
              f"violation(s), "
              f"{len(summary['alerts']['unhealed_critical'])} unhealed "
              "critical alert(s)")
        return 1
    return 0
