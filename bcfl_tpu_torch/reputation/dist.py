"""Per-PEER reputation for the dist runtime, wire evidence in and
quarantine out, committed to the ledger: port of
``bcfl_tpu/reputation/dist.py``.

The lifecycle tracker (:class:`bcfl_tpu_torch.reputation.lifecycle.
ReputationTracker`) runs unchanged; one index of its state vectors is a
PEER, and its observation clock is the leader's merge. The evidence comes
off the wire, at the leader:

- **ledger refingerprint mismatches** (``w_auth``): the leader commits
  what a sender announced and authenticates what arrived, which catches
  digest forgery and equivocation;
- **robust-merge outlier flags** (``w_anomaly``): the poisoning behaviors
  pass authentication and show only as outliers of the buffered merge
  (:func:`bcfl_tpu_torch.dist.robust.robust_merge`);
- **measured-staleness outliers and replay rejections**
  (``w_staleness``);
- **the failure detector's DOWN transitions** (``w_staleness``: peer
  death is not malice, so it is the weakest lane);
- **slowness** (the phi detector's suspicion, ``w_slow``): a down-weight
  in :meth:`DistReputationTracker.gate` only, it never moves the state
  machine.

Transitions are appended to the chain as reserved rows (client
``REP_CLIENT_BASE - peer``, a 32-byte structured snapshot in the digest
slot), which followers replay from the broadcasts they adopt
(:meth:`DistReputationTracker.absorb_rows`); rows and heads are JAX's byte
for byte. The tracker rides the peer checkpoint with the engine's
``rep_*`` keys, so a killed leader resumes with every trust score and
quarantine timer bit for bit.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bcfl_tpu_torch.reputation.lifecycle import (
    QUARANTINED,
    STATE_NAMES,
    ReputationConfig,
    ReputationTracker,
)
from bcfl_tpu_torch.telemetry import events as _telemetry

# reserved ledger-row client ids for reputation transitions: real clients
# are >= 0, so rows at or below this base never collide with an update
# commitment. Peer p's rows use REP_CLIENT_BASE - p.
REP_CLIENT_BASE = -1000

# the 32-byte structured "digest" of one transition snapshot: magic, peer,
# state, timer, quarantine_events, trust (f64), 4 pad bytes. The chain
# hashes these bytes like any entry digest, and a rejoining peer decodes
# them back into state.
_ROW_FMT = "<4siiiid4x"
_ROW_MAGIC = b"REPv"


def rep_row_client(peer: int) -> int:
    return REP_CLIENT_BASE - int(peer)


def encode_rep_row(peer: int, state: int, timer: int, events: int,
                   trust: float) -> bytes:
    out = struct.pack(_ROW_FMT, _ROW_MAGIC, int(peer), int(state),
                      int(timer), int(events), float(trust))
    assert len(out) == 32
    return out


def decode_rep_row(client: int, digest: bytes) -> Optional[Dict]:
    """The snapshot a reserved ledger row carries, or None for ordinary
    rows (a non-reserved client id or foreign digest bytes)."""
    if client > REP_CLIENT_BASE or len(digest) != 32:
        return None
    magic, peer, state, timer, events, trust = struct.unpack(_ROW_FMT,
                                                             digest)
    if magic != _ROW_MAGIC or rep_row_client(peer) != client:
        return None
    if not 0 <= state < len(STATE_NAMES):
        return None
    return {"peer": int(peer), "state": int(state), "timer": int(timer),
            "events": int(events), "trust": float(trust)}


class DistReputationTracker:
    """Peer-granularity reputation at one dist peer. Evidence accrues
    between merges through the ``note_*`` methods (each emits a
    ``rep.dist_evidence`` event naming its source); :meth:`observe_merge`
    folds the pending evidence into the state machine, one step per
    merge. Several sources for one peer combine by max."""

    # evidence source names (the `source` field of rep.dist_evidence)
    SRC_AUTH = "ledger_auth"
    SRC_OUTLIER = "robust_outlier"
    SRC_STALENESS = "staleness"
    SRC_REPLAY = "stale_replay"
    SRC_DETECTOR = "detector_down"
    SRC_SLOWNESS = "slowness"

    def __init__(self, cfg: ReputationConfig, peers: int, self_id: int):
        self.cfg = cfg
        self.peers = int(peers)
        self.self_id = int(self_id)
        self.tracker = ReputationTracker(cfg, peers, scope="peer")
        self._pending = np.zeros((self.peers,), np.float64)
        # per-peer slowness EWMA in [0, 1], fed by the phi detector; not
        # part of _pending, so slowness down-weights through gate() and
        # never drives the state machine (slowness_is_not_malice)
        self._slow = np.zeros((self.peers,), np.float64)
        self.quarantine_drops = 0  # post-ack refusals of quarantined arrivals

    # ------------------------------------------------------------- evidence

    def _note(self, peer: int, source: str, fault: float, **extra) -> None:
        peer = int(peer)
        if not 0 <= peer < self.peers or fault <= 0.0:
            return
        fault = min(float(fault), 1.0)
        self._pending[peer] = max(self._pending[peer], fault)
        _telemetry.emit("rep.dist_evidence", target=peer, source=source,
                        fault=fault, **extra)

    def note_auth_failure(self, peer: int, frac_failed: float) -> None:
        """``frac_failed`` of the peer's client slice failed the leader's
        refingerprint."""
        self._note(peer, self.SRC_AUTH, self.cfg.w_auth * frac_failed,
                   frac_failed=float(frac_failed))

    def note_outlier(self, peer: int, distance: Optional[float] = None
                     ) -> None:
        """The robust merge flagged this peer's vote as an outlier."""
        self._note(peer, self.SRC_OUTLIER, self.cfg.w_anomaly,
                   **({"distance": distance} if distance is not None
                      else {}))

    def note_staleness(self, peer: int, staleness: int) -> None:
        lim = self.cfg.staleness_limit
        if lim <= 0 or staleness <= lim:
            return
        self._note(peer, self.SRC_STALENESS, self.cfg.w_staleness,
                   staleness=int(staleness))

    def note_replay(self, peer: int, reason: str) -> None:
        """A lineage-check rejection (fork lineage mismatch, unknown
        base)."""
        self._note(peer, self.SRC_REPLAY, self.cfg.w_staleness,
                   reason=reason)

    def note_detector_down(self, peer: int) -> None:
        self._note(peer, self.SRC_DETECTOR, self.cfg.w_staleness)

    def note_slowness(self, peer: int, severity: float) -> None:
        """Fold one slowness observation (clipped to [0, 1]) into the
        peer's slowness EWMA. Bypasses ``_pending``: it scales
        :meth:`gate` by ``1 - w_slow * slow`` and nothing else. Called for
        every peer at every merge (0.0 when healthy), so the EWMA decays
        back when the limp clears."""
        p = int(peer)
        if not 0 <= p < self.peers:
            return
        sev = float(np.clip(severity, 0.0, 1.0))
        a = self.cfg.ewma_alpha
        self._slow[p] = (1.0 - a) * self._slow[p] + a * sev
        if sev > 0.0:
            _telemetry.emit("rep.dist_evidence", target=p,
                            source=self.SRC_SLOWNESS, fault=sev,
                            slow=round(float(self._slow[p]), 6))

    # -------------------------------------------------------------- observe

    def observe_merge(self, arrived: Sequence[int]
                      ) -> List[Tuple[int, str, str]]:
        """Advance the state machine one step. ``arrived`` are the peers
        with an arrival in this merge (accepted or rejected); a peer with
        pending evidence but no arrival is active too. Returns the
        transitions ``[(peer, from_name, to_name), ...]``, which the
        leader commits to the ledger."""
        active = np.zeros((self.peers,), bool)
        for p in arrived:
            if 0 <= int(p) < self.peers:
                active[int(p)] = True
        active |= self._pending > 0.0
        before = self.tracker.state.copy()
        self.tracker.observe(self._pending, active=active)
        self._pending[:] = 0.0
        out = []
        for p in np.nonzero(self.tracker.state != before)[0]:
            out.append((int(p), STATE_NAMES[int(before[p])],
                        STATE_NAMES[int(self.tracker.state[p])]))
        return out

    # ---------------------------------------------------------------- gates

    def gate(self, peer: int) -> float:
        """Merge-weight multiplier for one peer's arrivals: 0.0
        quarantined, ``probation_weight`` on probation, else 1.0; times
        the trust score and the slowness down-weight (``w_slow < 1``, so
        slowness alone never silences a vote)."""
        p = int(peer)
        base = float(self.tracker.gate()[p])
        if base == 0.0:
            return 0.0
        trust = float(np.clip(self.tracker.trust[p], 0.0, 1.0))
        slow_mult = 1.0 - self.cfg.w_slow * float(
            np.clip(self._slow[p], 0.0, 1.0))
        return base * trust * slow_mult

    def is_quarantined(self, peer: int) -> bool:
        return (0 <= int(peer) < self.peers
                and int(self.tracker.state[int(peer)]) == QUARANTINED)

    def quarantined_peers(self) -> List[int]:
        return [int(p) for p in
                np.nonzero(self.tracker.state == QUARANTINED)[0]]

    # ------------------------------------------------------------ ledger I/O

    def commit_transitions(self, ledger, version: int,
                           transitions: List[Tuple[int, str, str]]) -> int:
        """Append one reserved row per transition (leader side); returns
        how many rows were appended."""
        if ledger is None or not transitions:
            return 0
        n = 0
        for peer, _old, _new in transitions:
            digest = encode_rep_row(
                peer, int(self.tracker.state[peer]),
                int(self.tracker.timer[peer]),
                int(self.tracker.quarantine_events[peer]),
                float(self.tracker.trust[peer]))
            ledger.append_digest(int(version), rep_row_client(peer),
                                 digest, 0)
            n += 1
        return n

    def absorb_rows(self, rows) -> int:
        """Replay the reserved rows of an adopted chain segment: each
        decoded snapshot overwrites that peer's state, timer, quarantine
        count and trust, later rows winning (chain order). Malformed rows
        are skipped. Returns how many rows applied."""
        n = 0
        for row in rows or ():
            try:
                client = int(row["client"])
                digest = bytes.fromhex(row["digest"])
            except (KeyError, TypeError, ValueError):
                continue
            snap = decode_rep_row(client, digest)
            if snap is None or not 0 <= snap["peer"] < self.peers:
                continue
            p = snap["peer"]
            self.tracker.state[p] = snap["state"]
            self.tracker.timer[p] = snap["timer"]
            self.tracker.quarantine_events[p] = snap["events"]
            self.tracker.trust[p] = snap["trust"]
            n += 1
        return n

    # ------------------------------------------------------ checkpoint/report

    def checkpoint_state(self) -> Dict[str, np.ndarray]:
        out = self.tracker.checkpoint_state()
        out["rep_slow"] = self._slow.copy()
        return out

    def restore(self, state: Dict) -> None:
        self.tracker.restore(state)
        if state.get("rep_slow") is not None:
            self._slow = np.asarray(state["rep_slow"], np.float64).copy()

    def report(self) -> Dict:
        """The report block: trust as rounded floats and as exact
        ``float.hex()`` strings (the resume proof compares the hex forms
        with the checkpoint's arrays)."""
        return {
            "scope": "peer",
            "state": self.tracker.state_names(),
            "trust": [round(float(t), 6) for t in self.tracker.trust],
            "trust_hex": [float(t).hex() for t in self.tracker.trust],
            "slow": [round(float(s), 6) for s in self._slow],
            "slow_hex": [float(s).hex() for s in self._slow],
            "timer": [int(t) for t in self.tracker.timer],
            "quarantine_events": self.tracker.quarantine_events.tolist(),
            "rounds_quarantined": self.tracker.rounds_quarantined.tolist(),
            "quarantine_drops": int(self.quarantine_drops),
        }
