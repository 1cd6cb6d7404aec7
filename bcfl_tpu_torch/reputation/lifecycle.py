"""Peer lifecycle, reputation-driven quarantine with probation
readmission: port of ``bcfl_tpu/reputation/lifecycle.py``.

A deterministic per-peer state machine

    HEALTHY -> SUSPECT -> QUARANTINED -> PROBATION -> HEALTHY
                  ^                          |
                  +----- repeat offense -----+  (straight back to QUARANTINED)

driven by an EWMA trust score over the evidence the engine produces each
round: ledger-auth failures, anomaly-filter flags, injected corruption hits
and async staleness (``FedEngine._reputation_observe``). Trust, state and
timers are float64/int64 numpy arrays on the host, so a trajectory is the
JAX package's bit for bit for the same evidence; no RNG is involved, and
``checkpoint_state``/``restore`` carry the tracker across a crash.

Semantics of the multiplier (:meth:`ReputationTracker.gate`): quarantined
peers carry 0.0 (excluded like an anomaly-masked client), probation peers
``probation_weight`` (a fractional vote in the mean and gossip paths; the
robust order statistics treat any positive weight as participation),
everyone else 1.0.

Like the JAX tracker, :meth:`ReputationTracker.observe` emits
``rep.evidence`` (before the state machine advances) and
``rep.transition`` events into the run's event stream
(:mod:`bcfl_tpu_torch.telemetry`; a no-op without a writer), stamped with
the tracker's ``scope``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from bcfl_tpu_torch.telemetry import events as _telemetry

# lifecycle states (ints so the state vector checkpoints as a plain array)
HEALTHY = 0
SUSPECT = 1
QUARANTINED = 2
PROBATION = 3
STATE_NAMES = ("healthy", "suspect", "quarantined", "probation")


@dataclasses.dataclass(frozen=True)
class ReputationConfig:
    """Knobs of the state machine (the JAX ``ReputationConfig``: same
    fields, defaults and checks). ``trust' = (1 - ewma_alpha) * trust +
    ewma_alpha * (1 - fault)`` with fault in [0, 1] per round: from trust
    1.0 at alpha 0.4 one full fault lands at 0.6 (suspect), a second at
    0.36 (quarantined)."""

    enabled: bool = False
    ewma_alpha: float = 0.4
    # trust thresholds: below suspect_below -> SUSPECT, below
    # quarantine_below -> QUARANTINED (must be ordered)
    suspect_below: float = 0.7
    quarantine_below: float = 0.4
    # rounds a quarantined peer sits out before probation readmission
    quarantine_rounds: int = 3
    # clean rounds on probation before full HEALTHY status
    probation_rounds: int = 2
    # vote weight while on probation
    probation_weight: float = 0.5
    # a fault score >= this during PROBATION is a repeat offense
    strike_threshold: float = 0.5
    # --- evidence weights (per-source fault score, combined by max) ---
    w_auth: float = 1.0       # ledger-auth failure
    w_corrupt: float = 1.0    # injected corruption hit
    w_anomaly: float = 0.5    # anomaly-filter flag
    w_staleness: float = 0.25  # async staleness beyond staleness_limit
    staleness_limit: int = 4  # 0 disables staleness evidence
    # the JAX multi-process runtime's slowness down-weight ceiling; the
    # local engine never reads it (kept for the same config surface)
    w_slow: float = 0.5
    # count the plan's injected corruption hits as evidence (they coincide
    # with auth failures when the ledger is on)
    observe_injected: bool = True

    def __post_init__(self):
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(
                f"ewma_alpha must be in (0, 1], got {self.ewma_alpha}")
        if not 0.0 <= self.quarantine_below < self.suspect_below <= 1.0:
            raise ValueError(
                "thresholds must satisfy 0 <= quarantine_below < "
                f"suspect_below <= 1, got {self.quarantine_below} / "
                f"{self.suspect_below}")
        if self.quarantine_rounds < 1 or self.probation_rounds < 1:
            raise ValueError("quarantine_rounds and probation_rounds must "
                             "be >= 1")
        if not 0.0 < self.probation_weight <= 1.0:
            raise ValueError(
                f"probation_weight must be in (0, 1], got "
                f"{self.probation_weight}")
        for name in ("strike_threshold", "w_auth", "w_corrupt", "w_anomaly",
                     "w_staleness"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.staleness_limit < 0:
            raise ValueError(
                f"staleness_limit must be >= 0, got {self.staleness_limit}")
        if not 0.0 <= self.w_slow < 1.0:
            raise ValueError(
                f"w_slow must be in [0, 1), got {self.w_slow}")


class ReputationTracker:
    """Per-run lifecycle state for ``num_clients`` peers. Per round:
    ``gate()`` (the multiplier folded into the round's mask, from the state
    before the round), the round, then ``observe(fault)``."""

    def __init__(self, cfg: ReputationConfig, num_clients: int,
                 scope: str = "client"):
        self.cfg = cfg
        self.n = int(num_clients)
        # what one index IS ("client", or "peer" for a per-peer tracker);
        # stamped onto every rep.* event
        self.scope = str(scope)
        self.trust = np.ones((self.n,), np.float64)
        self.state = np.full((self.n,), HEALTHY, np.int64)
        self.timer = np.zeros((self.n,), np.int64)
        # lifetime counters (ride the checkpoint so resumed rollups match)
        self.quarantine_events = np.zeros((self.n,), np.int64)
        self.rounds_quarantined = np.zeros((self.n,), np.int64)

    def gate(self) -> np.ndarray:
        """[C] float32 multiplier for this round's participation mask."""
        mult = np.ones((self.n,), np.float32)
        mult[self.state == QUARANTINED] = 0.0
        mult[self.state == PROBATION] = np.float32(self.cfg.probation_weight)
        return mult

    def observe(self, fault: np.ndarray,
                active: Optional[np.ndarray] = None) -> None:
        """Advance one round given per-client fault scores in [0, 1].
        ``active`` ([C] bool, default all) marks who participated: an
        inactive client's trust does not drift and its probation clock does
        not tick; quarantine sentences tick regardless."""
        cfg = self.cfg
        fault = np.clip(np.asarray(fault, np.float64), 0.0, 1.0)
        act = (np.ones((self.n,), bool) if active is None
               else np.asarray(active, bool))
        # evidence events BEFORE the state machine advances (cause
        # precedes effect in the stream); quarantined clients were
        # excluded, so their scores are not evidence
        if _telemetry.get_writer() is not None:
            for c in np.nonzero(act & (fault > 0.0)
                                & (self.state != QUARANTINED))[0]:
                _telemetry.emit("rep.evidence", client=int(c),
                                fault=float(fault[c]), scope=self.scope)
        state_before = self.state.copy()
        for c in range(self.n):
            if self.state[c] == QUARANTINED:
                # excluded this round: no evidence, the sentence ticks
                self.rounds_quarantined[c] += 1
                self.timer[c] -= 1
                if self.timer[c] <= 0:
                    self.state[c] = PROBATION
                    self.timer[c] = cfg.probation_rounds
                    # readmit at the suspect boundary
                    self.trust[c] = cfg.suspect_below
                continue
            if not act[c]:
                continue
            a = cfg.ewma_alpha
            self.trust[c] = (1.0 - a) * self.trust[c] + a * (1.0 - fault[c])
            if self.state[c] == PROBATION:
                if fault[c] >= cfg.strike_threshold:
                    self._quarantine(c)  # repeat offense on probation
                else:
                    self.timer[c] -= 1
                    if self.timer[c] <= 0:
                        self.state[c] = HEALTHY
                continue
            if self.trust[c] < cfg.quarantine_below:
                self._quarantine(c)
            elif self.trust[c] < cfg.suspect_below:
                self.state[c] = SUSPECT
            else:
                self.state[c] = HEALTHY
        if _telemetry.get_writer() is not None:
            for c in np.nonzero(self.state != state_before)[0]:
                _telemetry.emit(
                    "rep.transition", client=int(c), scope=self.scope,
                    **{"from": STATE_NAMES[int(state_before[c])],
                       "to": STATE_NAMES[int(self.state[c])],
                       "trust": float(self.trust[c])})

    def _quarantine(self, c: int) -> None:
        self.state[c] = QUARANTINED
        self.timer[c] = self.cfg.quarantine_rounds
        self.trust[c] = min(self.trust[c], self.cfg.quarantine_below)
        self.quarantine_events[c] += 1

    def state_names(self) -> list:
        return [STATE_NAMES[int(s)] for s in self.state]

    def summary(self) -> Dict:
        """Run-level rollup for ``RunMetrics.reputation``."""
        return {
            "final_state": self.state_names(),
            "final_trust": [round(float(t), 6) for t in self.trust],
            "quarantine_events": self.quarantine_events.tolist(),
            "rounds_quarantined": self.rounds_quarantined.tolist(),
            "total_quarantine_events": int(self.quarantine_events.sum()),
        }

    def checkpoint_state(self) -> Dict[str, np.ndarray]:
        """Arrays for the engine checkpoint (prefix ``rep_``)."""
        return {
            "rep_trust": self.trust.copy(),
            "rep_state": self.state.copy(),
            "rep_timer": self.timer.copy(),
            "rep_quarantine_events": self.quarantine_events.copy(),
            "rep_rounds_quarantined": self.rounds_quarantined.copy(),
        }

    def restore(self, state: Dict) -> None:
        self.trust = np.asarray(state["rep_trust"], np.float64).copy()
        self.state = np.asarray(state["rep_state"], np.int64).copy()
        self.timer = np.asarray(state["rep_timer"], np.int64).copy()
        if state.get("rep_quarantine_events") is not None:
            self.quarantine_events = np.asarray(
                state["rep_quarantine_events"], np.int64).copy()
        if state.get("rep_rounds_quarantined") is not None:
            self.rounds_quarantined = np.asarray(
                state["rep_rounds_quarantined"], np.int64).copy()
