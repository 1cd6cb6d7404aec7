"""Elastic membership (port of ``bcfl_tpu/dist/membership.py``, host-only)
for the leaderless gossip dispatch (RUNTIME.md
"Gossip dispatch").

A :class:`MembershipView` is one peer's LOCAL belief about which peers are
currently part of the federation. There is no global registry and no
consensus round: the view starts optimistic (every statically configured
peer is live), shrinks when the transport's failure detector drives a peer
to DOWN or a peer announces it is leaving, and re-grows the moment any
frame arrives from a departed peer (the HELLO beacon makes that a
steady-state event, not a special rejoin protocol). Neighbor sampling
(the gossip dispatch's neighbor sampler, not ported yet) always draws over
``live()``, so a SIGKILLed peer stops being gossiped at within the
failure-detector window and a rejoining one is folded back in by its first
beacon — membership stretches and shrinks with zero privileged process.

Thread safety: ``note_alive`` is called from the pipelined intake thread
(any received update re-attests liveness) while ``note_leave``/``live``
run on the main loop — all state moves under one internal lock. Join and
leave transitions are emitted as ``membership.join`` / ``membership.leave``
telemetry events (OBSERVABILITY.md), which is how the soak gates count
churn cycles on a gossip run.
"""

from __future__ import annotations

import threading
from typing import Tuple

from bcfl_tpu_torch import telemetry


class MembershipView:
    """One peer's live-peer view over the static id space ``range(peers)``."""

    def __init__(self, peers: int, self_id: int):
        self.peers = int(peers)
        self.self_id = int(self_id)
        self._lock = threading.Lock()
        self._live = set(range(self.peers))  # guarded-by: _lock
        self.joins = 0    # guarded-by: _lock (writes)
        self.leaves = 0   # guarded-by: _lock (writes)

    def live(self) -> Tuple[int, ...]:
        """Sorted tuple of peers this view currently believes live
        (always includes self)."""
        with self._lock:
            return tuple(sorted(self._live))

    def is_live(self, p: int) -> bool:
        with self._lock:
            return int(p) in self._live

    def dormant(self) -> Tuple[int, ...]:
        """Sorted static ids currently ABSENT from the live view — the
        anti-entropy probe lane's candidate pool
        (the gossip dispatch's probe lane). The HELLO beacon
        only samples ``live()``, so without a periodic probe at a dormant
        peer two detector-shrunk views could never rediscover each other
        after a partition heals — split-brain forever."""
        with self._lock:
            return tuple(p for p in range(self.peers)
                         if p not in self._live)

    def note_alive(self, p: int) -> bool:
        """A frame arrived from ``p``: fold it (back) into the live view.
        Returns True when this was a re-entry (a join transition)."""
        p = int(p)
        if p < 0 or p >= self.peers:
            return False
        with self._lock:
            if p in self._live:
                return False
            self._live.add(p)
            self.joins += 1
            live = sorted(self._live)
        telemetry.emit("membership.join", member=p, live=live)
        return True

    def note_leave(self, p: int, reason: str) -> bool:
        """Drop ``p`` from the live view (detector DOWN transition or an
        explicit leaving announcement). Self never leaves its own view.
        Returns True when this was an actual departure transition."""
        p = int(p)
        if p == self.self_id or p < 0 or p >= self.peers:
            return False
        with self._lock:
            if p not in self._live:
                return False
            self._live.discard(p)
            self.leaves += 1
            live = sorted(self._live)
        telemetry.emit("membership.leave", member=p, reason=reason,
                       live=live)
        return True

    def report(self) -> dict:
        with self._lock:
            return {"live": sorted(self._live), "joins": self.joins,
                    "leaves": self.leaves}
