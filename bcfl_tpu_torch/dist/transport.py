"""Host-level peer transport: port of ``bcfl_tpu/dist/transport.py``
(self-healing loopback TCP, RUNTIME.md §3 and "Delivery contract"),
host-only: frames carry CPU tensors and never touch the card.

One :class:`PeerTransport` per peer process: a listener thread accepts
connections on the peer's own port and enqueues complete frames into a
BOUNDED inbox; sends open a fresh connection per message (a crashed
receiver can never wedge a cached socket). Every operation runs under a
hard deadline. Frames are STREAMED both ways (wire.write_frame /
read_frame): the send path never concatenates a payload into one bytes,
and the receive path decodes into preallocated buffers.

Two send seams share one reliable protocol (:meth:`_send_reliable`):
:meth:`PeerTransport.send` blocks until delivered/budget-expired (control
messages, probes, tests), and :meth:`send_async` enqueues onto a bounded
per-destination sender WORKER and returns, preserving per-destination
msg-id order with block-on-full back-pressure
(``DistConfig.pipeline_depth``).

The delivery contract, as in JAX:

- **At-least-once**: every frame carries a monotone per-destination
  ``(from, msg_id)`` plus the sender's incarnation epoch, and a CRC32;
  delivery is confirmed by the receiver's 4-byte ack. A failed attempt
  retries with exponential backoff + deterministic jitter under a
  per-destination deadline budget; :meth:`PeerTransport.send` never
  raises on network failure.
- **Idempotent receive**: the receiver verifies the CRC before parsing a
  field (damage -> ``crc_drops``, no ack), then dedups on a per-sender
  msg-id window (``dups_dropped``).
- **Failure detection**: every attempt outcome feeds a per-peer detector
  (REACHABLE -> SUSPECT -> DOWN; while DOWN only one probe per interval):
  the adaptive phi-accrual-style :class:`PhiFailureDetector` (default) or
  the fixed consecutive counter :class:`FailureDetector`
  (``DistConfig.detector``).

:class:`PartitionGate` is the fault plan's partition lane over peer ids,
consulted on both ends of every message: a blocked pair is dropped at the
sender and, on the receiver's own clock, at the receiver, and both count
in ``dropped_by_gate``.

The fault plan's wire lane (:class:`WireChaos`) injects drop / duplicate /
reorder-hold / delay-jitter / byte-corruption per transmission attempt at
the socket, drawn from ``(seed, round, src, dst, msg_id, attempt)``; the
limp lane (:class:`LimpChaos`) paces a degraded direction's attempts by
the frame's wire time at the throttled byte rate. Both read the peer's
local round, pinned at enqueue time on the pipelined path, and both are
counted (``chaos_injected[action]``, ``limp_paced``) and sampled into the
event stream (``chaos``, ``limp.inject``).
"""

from __future__ import annotations

import json
import logging
import queue
import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from bcfl_tpu_torch.config import DistConfig
from bcfl_tpu_torch.faults import FaultPlan
from bcfl_tpu_torch.dist.wire import (
    CrcError,
    WireError,
    frame_prefix,
    from_wire,
    read_ack,
    read_frame,
    to_wire,
    write_ack,
    write_frame,
)
from bcfl_tpu_torch.telemetry import events as _telemetry

logger = logging.getLogger(__name__)


class TransportError(RuntimeError):
    """One send ATTEMPT failed (unreachable / refused / deadline / no
    ack). Internal to the retry seam — :meth:`PeerTransport.send`
    absorbs it into the backoff loop and the stats counters."""


# failure-detector states (RUNTIME.md "Delivery contract")
REACHABLE = "reachable"
SUSPECT = "suspect"
DOWN = "down"


class FailureDetector:
    """Per-peer circuit-breaker failure detector.

    Consecutive send-attempt failures move a peer REACHABLE -> SUSPECT
    (``suspect_after``) -> DOWN (``down_after``); any success snaps it back
    to REACHABLE, as does INBOUND traffic from the peer
    (:meth:`on_inbound`, called from the serving threads — hence the
    lock). While DOWN the circuit is open: :meth:`allow` returns False
    except for one probe per ``probe_interval_s``."""

    def __init__(self, peers: int, suspect_after: int = 2,
                 down_after: int = 6, probe_interval_s: float = 2.0):
        import collections

        self.suspect_after = int(suspect_after)
        self.down_after = int(down_after)
        self.probe_interval_s = float(probe_interval_s)
        self._lock = threading.Lock()
        self._state = {p: REACHABLE for p in range(int(peers))}  # guarded-by: _lock
        self._fails = {p: 0 for p in range(int(peers))}  # guarded-by: _lock
        self._last_probe = {p: 0.0 for p in range(int(peers))}  # guarded-by: _lock
        # bounded: a long-lived peer on a lossy link flaps at message
        # rate, and the full log is serialized into every report — keep
        # the recent window (enough for the chaos gates) plus a total.
        # Writes under the lock; external readers (the transport's stats
        # rollup, the runtime's evidence drain) take snapshot reads of
        # the deque/int, which CPython keeps tear-free.
        self.transitions = collections.deque(maxlen=256)  # guarded-by: _lock (writes)
        self.transitions_total = 0  # guarded-by: _lock (writes)

    def _set(self, peer: int, state: str) -> None:  # guarded-by: _lock
        old = self._state[peer]
        if old == state:
            return
        self._state[peer] = state
        self.transitions_total += 1
        self.transitions.append(
            {"peer": int(peer), "from": old, "to": state,
             "at": time.time()})
        # never sampled: the timeline's SUSPECT->REACHABLE roundtrip gate
        # and quorum analysis read these
        _telemetry.emit("detector",
                        **{"target": int(peer), "from": old, "to": state})

    def state_of(self, peer: int) -> str:
        with self._lock:
            return self._state[peer]

    def states(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._state)

    def on_success(self, peer: int) -> None:
        with self._lock:
            self._fails[peer] = 0
            self._set(peer, REACHABLE)

    def on_failure(self, peer: int) -> None:
        with self._lock:
            self._fails[peer] += 1
            if self._fails[peer] >= self.down_after:
                self._set(peer, DOWN)
            elif self._fails[peer] >= self.suspect_after:
                self._set(peer, SUSPECT)

    def on_inbound(self, peer: int) -> None:
        """Liveness evidence from the RECEIVE path: a CRC-valid frame from
        ``peer`` proves its process is up, so snap the circuit shut. A
        just-restarted peer must not have its repair traffic refused
        (``circuit_open``) for a whole probe interval by the stale DOWN
        verdict its crash earned — its state_sync_req IS the heartbeat.
        Unknown sender ids are ignored (hostile headers never grow the
        peer table)."""
        with self._lock:
            if peer not in self._state:
                return
            self._fails[peer] = 0
            self._set(peer, REACHABLE)

    def allow(self, peer: int) -> bool:
        """Should a send to ``peer`` be attempted now? True unless the
        circuit is open (DOWN) and no probe is due; a granted probe
        reserves the interval."""
        with self._lock:
            if self._state[peer] != DOWN:
                return True
            now = time.monotonic()
            if now - self._last_probe[peer] >= self.probe_interval_s:
                self._last_probe[peer] = now
                return True
            return False


class PhiFailureDetector(FailureDetector):
    """Adaptive phi-accrual-style failure detector (``detector="phi"``,
    RUNTIME.md "Timing contract"; after Hayashibara et al.'s phi-accrual
    design, adapted to bursty request/response traffic).

    Same public surface, state vocabulary, and transition/telemetry
    contract as the fixed counter, but suspicion is a CONTINUOUS per-peer
    level::

        phi(p) = consecutive_failures(p)
                 + max(0, silence(p) / window(p) - 1)

    where ``silence`` is the time since the last liveness evidence
    (successful send to, or CRC-valid inbound frame from, the peer) and
    ``window`` is the learned expected silence — EWMA mean + 3 sigma of
    the peer's inbound intervals, clamped to [window_floor_s,
    window_ceil_s] (the ceiling is also the prior before any sample, so
    an unheard-from peer accrues slowly instead of flapping at startup).
    phi is monotone between evidence — silence only grows it — and any
    liveness evidence snaps it back to 0 (REACHABLE). ``phi_suspect`` /
    ``phi_down`` replace ``suspect_after`` / ``down_after``: under pure
    send failures the defaults grade identically (1 phi unit per
    consecutive failure), while a peer that is merely SILENT — the
    SIGSTOP'd, swapping, or one-way-degraded gray failure — also accrues,
    which the fixed counter is structurally blind to.

    The estimator additionally learns per-destination RTT (EWMA +
    variance over per-attempt success wall times) and throughput (bytes/s
    over large frames), from which :meth:`send_budget_s` derives the
    ADAPTIVE per-destination send deadline: RTT headroom plus the frame's
    expected wire time at the measured (or assumed-minimum) throughput,
    clamped to [deadline_floor_s, deadline_ceil_s]. That is the
    large-frame starvation fix: a 32 MB frame on a slow link earns a
    size-proportional budget instead of starving under a latency-tuned
    constant.

    Estimates are measurements of the live run (wall clock in, wall
    clock out) — nothing here is part of the seeded-determinism scope;
    the seeded lanes INJECT slowness, this class measures it."""

    _ALPHA = 0.2   # EWMA weight for the interval/RTT/throughput estimates
    _THROUGHPUT_MIN_BYTES = 65536   # frames below this measure latency,
    # not bandwidth — keep them out of the throughput estimate

    def __init__(self, peers: int, phi_suspect: float = 2.0,
                 phi_down: float = 6.0, probe_interval_s: float = 2.0,
                 window_floor_s: float = 5.0, window_ceil_s: float = 120.0,
                 deadline_floor_s: float = 2.0,
                 deadline_ceil_s: float = 120.0,
                 min_bandwidth_bps: float = 1_048_576.0,
                 base_deadline_s: float = 20.0):
        super().__init__(peers, probe_interval_s=probe_interval_s)
        self.phi_suspect = float(phi_suspect)
        self.phi_down = float(phi_down)
        self.window_floor_s = float(window_floor_s)
        self.window_ceil_s = float(window_ceil_s)
        self.deadline_floor_s = float(deadline_floor_s)
        self.deadline_ceil_s = float(deadline_ceil_s)
        self.min_bandwidth_bps = float(min_bandwidth_bps)
        self.base_deadline_s = float(base_deadline_s)
        n = int(peers)
        now = time.monotonic()
        # all estimator state is guarded-by: _lock (inherited)
        self._last = {p: now for p in range(n)}        # guarded-by: _lock
        self._int_mean: Dict[int, Optional[float]] = \
            {p: None for p in range(n)}                # guarded-by: _lock
        self._int_var = {p: 0.0 for p in range(n)}     # guarded-by: _lock
        self._rtt_mean: Dict[int, Optional[float]] = \
            {p: None for p in range(n)}                # guarded-by: _lock
        self._rtt_var = {p: 0.0 for p in range(n)}     # guarded-by: _lock
        self._thr_mean: Dict[int, Optional[float]] = \
            {p: None for p in range(n)}                # guarded-by: _lock

    # --------------------------------------------------- evidence intake

    def _heard(self, peer: int) -> None:  # guarded-by: _lock
        """Liveness evidence: fold the silence gap into the interval
        estimate, reset the silence clock and failure pressure, snap the
        state shut."""
        now = time.monotonic()
        gap = now - self._last[peer]
        self._last[peer] = now
        m = self._int_mean[peer]
        if m is None:
            self._int_mean[peer] = gap
        else:
            d = gap - m
            self._int_mean[peer] = m + self._ALPHA * d
            self._int_var[peer] = ((1.0 - self._ALPHA)
                                   * (self._int_var[peer]
                                      + self._ALPHA * d * d))
        self._fails[peer] = 0
        self._set(peer, REACHABLE)

    def on_success(self, peer: int) -> None:
        with self._lock:
            self._heard(peer)

    def on_inbound(self, peer: int) -> None:
        with self._lock:
            if peer not in self._state:
                return
            self._heard(peer)

    def on_failure(self, peer: int) -> None:
        with self._lock:
            self._fails[peer] += 1
            self._refresh(peer)

    def note_rtt(self, peer: int, rtt_s: float, nbytes: int = 0) -> None:
        """One successful attempt's wall time (and frame size) feeds the
        per-destination RTT / throughput estimates the adaptive send
        deadline is derived from."""
        with self._lock:
            rtt_s = float(rtt_s)
            m = self._rtt_mean[peer]
            if m is None:
                self._rtt_mean[peer] = rtt_s
            else:
                d = rtt_s - m
                self._rtt_mean[peer] = m + self._ALPHA * d
                self._rtt_var[peer] = ((1.0 - self._ALPHA)
                                       * (self._rtt_var[peer]
                                          + self._ALPHA * d * d))
            if nbytes >= self._THROUGHPUT_MIN_BYTES and rtt_s > 0:
                bps = nbytes / rtt_s
                t = self._thr_mean[peer]
                self._thr_mean[peer] = (bps if t is None
                                        else t + self._ALPHA * (bps - t))

    # ------------------------------------------------------- suspicion

    def _window_s(self, peer: int) -> float:  # guarded-by: _lock
        m = self._int_mean[peer]
        if m is None:
            return self.window_ceil_s
        w = m + 3.0 * self._int_var[peer] ** 0.5
        return min(max(w, self.window_floor_s), self.window_ceil_s)

    def _phi_locked(self, peer: int) -> float:  # guarded-by: _lock
        silence = time.monotonic() - self._last[peer]
        return (float(self._fails[peer])
                + max(0.0, silence / self._window_s(peer) - 1.0))

    def _refresh(self, peer: int) -> None:  # guarded-by: _lock
        """Map the continuous phi onto the shared state vocabulary. phi
        never decreases between evidence (silence only grows, failures
        only accumulate), so thresholds only ever move the state UP here;
        the snap back down is _heard's job."""
        ph = self._phi_locked(peer)
        if ph >= self.phi_down:
            self._set(peer, DOWN)
        elif ph >= self.phi_suspect:
            self._set(peer, SUSPECT)

    def phi(self, peer: int) -> float:
        """The peer's current suspicion level (refreshes its state)."""
        with self._lock:
            self._refresh(peer)
            return self._phi_locked(peer)

    def state_of(self, peer: int) -> str:
        with self._lock:
            self._refresh(peer)
            return self._state[peer]

    def states(self) -> Dict[int, str]:
        with self._lock:
            for p in self._state:
                self._refresh(p)
            return dict(self._state)

    def allow(self, peer: int) -> bool:
        with self._lock:
            self._refresh(peer)
            if self._state[peer] != DOWN:
                return True
            now = time.monotonic()
            if now - self._last_probe[peer] >= self.probe_interval_s:
                self._last_probe[peer] = now
                return True
            return False

    # ------------------------------------------------ adaptive deadline

    def send_budget_s(self, peer: int, nbytes: int) -> float:
        """Adaptive per-destination send deadline: measured RTT headroom
        (mean + 4 sigma) plus the frame's expected wire time at the
        destination's measured throughput (halved for safety margin; the
        configured minimum-bandwidth assumption stands in before any
        measurement), clamped to [deadline_floor_s, deadline_ceil_s].
        Before any RTT sample the static base deadline is the headroom —
        first contact is never MORE aggressive than the fixed policy."""
        with self._lock:
            m = self._rtt_mean[peer]
            if m is None:
                base = self.base_deadline_s
            else:
                base = m + 4.0 * self._rtt_var[peer] ** 0.5
            thr = self._thr_mean[peer]
            if thr is None or thr <= 0:
                bps = self.min_bandwidth_bps
            else:
                bps = max(0.5 * thr, 1.0)
            budget = base + float(nbytes) / bps
            return min(max(budget, self.deadline_floor_s),
                       self.deadline_ceil_s)

    def phi_snapshot(self) -> Dict[str, Dict]:
        """Per-peer estimator snapshot for the report/telemetry rollup."""
        with self._lock:
            out = {}
            for p in self._state:
                self._refresh(p)
                out[str(p)] = {
                    "phi": round(self._phi_locked(p), 4),
                    "window_s": round(self._window_s(p), 4),
                    "rtt_s": (round(self._rtt_mean[p], 6)
                              if self._rtt_mean[p] is not None else None),
                    "bps": (round(self._thr_mean[p], 1)
                            if self._thr_mean[p] is not None else None),
                }
            return out


class PartitionGate:
    """The fault plan's partition lane, evaluated over PEER ids at the
    socket.

    ``components`` come from :meth:`FaultPlan.partition_components` with
    the peer count as the population; the span clock is the owning peer's
    local round (``version_fn``). It advances with the peer's own training
    loop, so each side crosses the span on its own counter even while
    cross-partition messages are dropped; the two sides agree on the
    components and may briefly disagree on whether the span is active
    (one side drops at send while the other still drops at receive).
    ``allowed(a, b)`` is False iff the span is active on this peer's clock
    and ``a`` and ``b`` sit in different components."""

    def __init__(self, plan: Optional[FaultPlan], peers: int,
                 version_fn: Callable[[], int] = lambda: 0):
        self.plan = plan if plan is not None else FaultPlan()
        self.peers = int(peers)
        self.version_fn = version_fn

    def components(self) -> Optional[Tuple[Tuple[int, ...], ...]]:
        return self.plan.partition_components(int(self.version_fn()),
                                              self.peers)

    def component_of(self, peer: int) -> Optional[Tuple[int, ...]]:
        """The peer's component, or None for an id no component holds (an
        unknown sender, never a crash: see ``allowed``)."""
        comps = self.components()
        if comps is None:
            return tuple(range(self.peers))
        return next((c for c in comps if peer in c), None)

    def allowed(self, a: int, b: int) -> bool:
        comps = self.components()
        if comps is None:
            return True
        ca, cb = self.component_of(a), self.component_of(b)
        if ca is None or cb is None:
            # a frame with a missing or out-of-range "from" during a span:
            # dropped, an unknown sender is in no component
            return False
        return ca == cb


class WireChaos:
    """The fault plan's wire lane bound to one sender: per (message,
    attempt) socket faults, with the peer's local round as the lane clock
    (the partition gate's clock, which advances with the peer's own
    training and never through the faulted messages)."""

    def __init__(self, plan: Optional[FaultPlan],
                 clock_fn: Callable[[], int]):
        self.plan = plan if plan is not None else FaultPlan()
        self.clock_fn = clock_fn

    def actions(self, src: int, dst: int, msg_id: int, attempt: int,
                clock: Optional[int] = None) -> Optional[dict]:
        """The fault draw of one attempt. ``clock`` pins the lane clock
        to an instant the caller captured (the pipelined sender records
        it at enqueue), so a message's fate depends on the round that
        produced it, not on when a worker sends it."""
        c = int(self.clock_fn()) if clock is None else int(clock)
        return self.plan.wire_actions(c, src, dst, msg_id, attempt)


class LimpChaos:
    """The fault plan's limp lane, its throttle seam, bound to one sender:
    the direction-keyed link byte rate on the local-round clock (pinned at
    enqueue as :class:`WireChaos` pins it). ``(src, dst)`` and ``(dst,
    src)`` draw independently: A->B can limp while B->A answers."""

    def __init__(self, plan: Optional[FaultPlan],
                 clock_fn: Callable[[], int]):
        self.plan = plan if plan is not None else FaultPlan()
        self.clock_fn = clock_fn

    def throttle_bps(self, src: int, dst: int,
                     clock: Optional[int] = None) -> Optional[float]:
        """The byte rate of the src->dst direction this round, or None
        when it is healthy or the lane is off."""
        c = int(self.clock_fn()) if clock is None else int(clock)
        return self.plan.limp_throttle(c, src, dst)


class PeerTransport:
    """Frame transport bound to one peer id.

    ``addrs[p]`` is peer ``p``'s ``(host, port)``; the transport listens on
    its own address and connects outward per send. ``gate`` (optional) is
    consulted on both send and receive; ``chaos`` (optional) is the wire
    fault lane and ``limp`` the limp lane's throttle; ``policy`` (a
    :class:`DistConfig`) carries the retry / detector / dedup / inbox
    knobs. With ``adapters`` set (the runtime's: True when it trains an
    adapter tree), the runtime's flat model trees cross in the nesting of
    JAX's pytree and arrive flat again (:func:`wire.to_wire`)."""

    def __init__(self, peer_id: int, addrs: List[Tuple[str, int]],
                 gate: Optional[PartitionGate] = None,
                 connect_timeout_s: float = 5.0,
                 io_timeout_s: float = 60.0,
                 chaos: Optional[WireChaos] = None,
                 policy: Optional[DistConfig] = None,
                 epoch: Optional[int] = None,
                 limp: Optional[LimpChaos] = None,
                 adapters: Optional[bool] = None):
        self.peer_id = int(peer_id)
        # the model-tree layout (wire.to_wire / from_wire): None passes
        # every tree as the caller gives it
        self.adapters = adapters
        self.addrs = list(addrs)
        self.gate = gate
        self.chaos = chaos
        self.limp = limp
        self.policy = policy if policy is not None else DistConfig()
        self.connect_timeout_s = connect_timeout_s
        self.io_timeout_s = io_timeout_s
        self.inbox: "queue.Queue" = queue.Queue(
            maxsize=self.policy.inbox_max)
        if self.policy.detector == "phi":
            self.detector: FailureDetector = PhiFailureDetector(
                len(addrs),
                phi_suspect=self.policy.phi_suspect,
                phi_down=self.policy.phi_down,
                probe_interval_s=self.policy.probe_interval_s,
                window_floor_s=self.policy.phi_window_floor_s,
                window_ceil_s=self.policy.phi_window_ceil_s,
                deadline_floor_s=self.policy.deadline_floor_s,
                deadline_ceil_s=self.policy.deadline_ceil_s,
                min_bandwidth_bps=self.policy.min_bandwidth_bps,
                base_deadline_s=self.policy.send_deadline_s)
        else:
            self.detector = FailureDetector(
                len(addrs), self.policy.suspect_after,
                self.policy.down_after, self.policy.probe_interval_s)
        # receive-path counters are bumped from concurrent per-connection
        # serve threads AND (with the pipeline on) the sender workers: a
        # plain += is a racy read-add-store there. Writes go through
        # _bump / locked sections; stats() reads are GIL-atomic snapshots
        # (the (writes) qualifier states exactly that contract).
        self._stats_lock = threading.Lock()
        # --- observability counters (stats()) ---
        self.retries = 0            # guarded-by: _stats_lock (writes) — re-attempts
        self.send_failures = 0      # guarded-by: _stats_lock (writes) — budget exhausted
        self.dups_dropped = 0       # guarded-by: _stats_lock (writes) — dedup drops
        self.crc_drops = 0          # guarded-by: _stats_lock (writes) — CRC failures
        self.wire_drops = 0         # guarded-by: _stats_lock (writes) — malformed/stalled
        self.inbox_overflow = 0     # guarded-by: _stats_lock (writes) — bounded-inbox sheds
        self.reorders_held = 0      # guarded-by: _stats_lock (writes) — chaos holds
        self.circuit_skips = 0      # guarded-by: _stats_lock (writes) — open-circuit skips
        self.dropped_by_gate = 0    # guarded-by: _stats_lock (writes) — partition drops
        self.limp_paced = 0         # guarded-by: _stats_lock (writes) — limp throttle pacings
        self.chaos_injected = {"drop": 0, "dup": 0, "reorder": 0,  # guarded-by: _stats_lock (writes)
                               "delay": 0, "corrupt": 0}
        self._held_cv = threading.Condition()
        self._held = 0  # guarded-by: _held_cv — reorder-held frames not yet enqueued
        # the sender's incarnation epoch: part of the dedup identity, so a
        # restarted peer (fresh msg-id counter) opens a fresh window at
        # every receiver instead of colliding with its dead incarnation's
        # ids — crash/rejoin cannot have its first HELLOs eaten as "dups".
        # Callers that can persist state across restarts (PeerRuntime's
        # file-backed restart counter) pass ``epoch`` explicitly —
        # guaranteed monotone even when the wall clock steps backward
        # between incarnations; the wall-ms default covers ad-hoc use.
        self.epoch = (int(epoch) if epoch is not None
                      else time.time_ns() // 1_000_000)
        self._dedup_lock = threading.Lock()
        self._dedup_seen: Dict[int, set] = {}   # guarded-by: _dedup_lock
        self._dedup_max: Dict[int, int] = {}    # guarded-by: _dedup_lock
        self._dedup_epoch: Dict[int, int] = {}  # guarded-by: _dedup_lock
        self._server: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []
        self._closing = threading.Event()
        # --- pipelined sender (policy.pipeline; RUNTIME.md §4) ---
        # one worker + bounded handoff queue per destination: send_async
        # allocates the msg_id in the CALLER's thread (per-destination
        # allocation order == enqueue order == wire order, since the
        # worker drains FIFO) and returns immediately; the retry/backoff
        # loop and detector feeding run in the worker.
        # The bounded queue IS the back-pressure: a slow link blocks the
        # enqueuing round loop after pipeline_depth frames instead of
        # buffering model-sized trees without bound.
        self._send_lock = threading.Lock()  # msg-id alloc + worker spawn
        self._send_queues: Dict[int, "queue.Queue"] = {}  # guarded-by: _send_lock
        self._next_msg_id: Dict[int, int] = {}  # guarded-by: _send_lock
        self._inflight_cv = threading.Condition()
        self._inflight = 0  # guarded-by: _inflight_cv — sends enqueued or executing
        self.async_enqueued = 0     # guarded-by: _stats_lock (writes) — handed to a worker
        self.backpressure_blocks = 0  # guarded-by: _stats_lock (writes) — waited on full queue

    def _bump(self, name: str) -> None:
        with self._stats_lock:
            setattr(self, name, getattr(self, name) + 1)

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        host, port = self.addrs[self.peer_id]
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(16)
        srv.settimeout(0.25)  # so the accept loop notices close()
        self._server = srv
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name=f"bcfl-dist-accept-{self.peer_id}")
        t.start()
        self._threads.append(t)

    def close(self) -> None:
        self._closing.set()
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass

    def _accept_loop(self) -> None:
        while not self._closing.is_set():
            try:
                # deadline: settimeout(0.25) on the listener in start()
                conn, _ = self._server.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._serve_one, args=(conn,),
                                 daemon=True)
            t.start()

    # --------------------------------------------------------------- receive

    def _serve_one(self, conn: socket.socket) -> None:
        """Receive pipeline for one connection. The ack is the LAST step:
        it confirms the frame was delivered AND accepted (enqueued, or
        deliberately discarded by gate/dedup/hostile-header policy — an
        application decision that must not feed the sender's failure
        detector). The one case that withholds the ack besides wire
        damage is inbox overflow: an acked-then-shed frame would be
        unrecoverable (the sender stops retrying and the dedup window
        would eat any retransmit), so overflow refuses the ack and
        un-records the id — at-least-once survives a full inbox."""
        try:
            with conn:
                header, trees = read_frame(conn, self.io_timeout_s)
                if self.adapters is not None:
                    trees = from_wire(header, trees)
                try:
                    # CRC is integrity, not authentication: a well-CRC'd
                    # frame can still carry hostile field TYPES
                    # ("from": "abc"). Coerce them here so a garbage
                    # header is a counted drop, never a dead serving
                    # thread.
                    src = int(header.get("from", -1))
                    msg_id = header.get("msg_id")
                    if msg_id is not None:
                        msg_id = int(msg_id)
                    epoch = int(header.get("msg_epoch") or 0)
                    hold = float(header.pop("chaos_hold_s", 0.0) or 0.0)
                except (TypeError, ValueError) as e:
                    self._bump("wire_drops")
                    logger.warning("peer %d: dropped frame with hostile "
                                   "header fields: %s", self.peer_id, e)
                    _telemetry.emit("recv", disposition="hostile")
                    self._ack(conn)  # delivered garbage: never retryable
                    return
                # even a frame the gate/dedup will discard is liveness
                # evidence: the sender's PROCESS is demonstrably up
                self.detector.on_inbound(src)
                if (self.gate is not None
                        and not self.gate.allowed(self.peer_id, src)):
                    # the RECEIVER'S clock is authoritative: a frame from
                    # across the partition is dropped before anything can
                    # merge it
                    self._bump("dropped_by_gate")
                    logger.info("peer %d: partition gate dropped %s from "
                                "peer %d", self.peer_id,
                                header.get("type"), src)
                    self._recv_event("gate", src, epoch, msg_id, header)
                    self._ack(conn)
                    return
                if msg_id is not None and not self._dedup_accept(
                        src, epoch, msg_id):
                    self._bump("dups_dropped")
                    logger.info("peer %d: dedup dropped duplicate %s "
                                "(%d, %d)", self.peer_id,
                                header.get("type"), src, msg_id)
                    self._recv_event("dedup", src, epoch, msg_id, header)
                    self._ack(conn)
                    return
                if hold > 0:
                    # chaos reorder: hold the frame so later arrivals
                    # overtake it. Capacity is checked now (the ack is due
                    # while the sender waits); a flood during the hold can
                    # still shed the release, a chaos-only residual
                    if self.inbox.full():
                        self._shed_overflow(header, src, msg_id)
                        return
                    self._bump("reorders_held")
                    with self._held_cv:
                        self._held += 1
                    t = threading.Timer(hold, self._release_held,
                                        args=(header, trees))
                    t.daemon = True
                    t.start()
                    # accepted (it enqueues after the hold): the event
                    # precedes the ack, as for every accepted frame
                    self._recv_event("accepted", src, epoch, msg_id,
                                     header, held_s=hold)
                    self._ack(conn)
                elif self._enqueue(header, trees):
                    self._recv_event("accepted", src, epoch, msg_id,
                                     header)
                    self._ack(conn)
                else:
                    self._shed_overflow(header, src, msg_id,
                                        counted=True)
        except CrcError as e:
            self._bump("crc_drops")
            _telemetry.emit("recv", disposition="crc")
            logger.warning("peer %d: dropped corrupt inbound frame: %s",
                           self.peer_id, e)
        except (WireError, OSError, socket.timeout) as e:
            self._bump("wire_drops")
            _telemetry.emit("recv", disposition="wire")
            logger.warning("peer %d: dropped malformed/stalled inbound "
                           "frame: %s", self.peer_id, e)

    def _recv_event(self, disposition: str, src: int, epoch: int,
                    msg_id: Optional[int], header: Dict, **extra) -> None:
        """One receive-disposition event carrying the (src, msg_epoch,
        msg_id) transport identity — the receiver half of every
        cross-process correlation (never sampled)."""
        _telemetry.emit("recv", disposition=disposition, src=src,
                        msg_epoch=epoch, msg_id=msg_id,
                        type=header.get("type"), **extra)

    def _ack(self, conn: socket.socket) -> None:
        try:
            write_ack(conn)
        except OSError:
            # the sender vanished mid-handshake; it will retry and the
            # dedup window absorbs the duplicate
            pass

    def _shed_overflow(self, header: Dict, src: int,
                       msg_id: Optional[int],
                       counted: bool = False) -> None:
        """Bounded-inbox shed: count it, un-record the dedup id, and do
        NOT ack — the sender's retry (or a later retransmit) can still
        deliver once the inbox drains."""
        if not counted:
            self._bump("inbox_overflow")
        if msg_id is not None:
            self._dedup_unrecord(src, msg_id)
        # deliberately NO msg_id on the event: the frame was refused
        # (no ack), so its identity must not satisfy the acked_not_lost
        # lookup — the retransmit's accepted recv is the one that counts
        _telemetry.emit("recv", disposition="overflow", src=src,
                        type=header.get("type"))
        logger.warning("peer %d: inbox full (%d); refused %s (sender "
                       "will retry)", self.peer_id, self.policy.inbox_max,
                       header.get("type"))

    def _release_held(self, header: Dict, trees: Dict) -> None:
        try:
            self._enqueue(header, trees)
        finally:
            with self._held_cv:
                self._held -= 1
                self._held_cv.notify_all()

    def wait_held(self, timeout_s: float) -> bool:
        """Block until every reorder-held frame has been enqueued (True),
        or ``timeout_s``. The frames were acked when they arrived, so a
        message sent after them (a shutdown) must not be acted on before
        they land."""
        deadline = time.monotonic() + timeout_s
        with self._held_cv:
            while self._held > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._held_cv.wait(left)
        return True

    def _enqueue(self, header: Dict, trees: Dict) -> bool:
        try:
            self.inbox.put_nowait((header, trees))
            return True
        except queue.Full:
            self._bump("inbox_overflow")
            return False

    def _dedup_accept(self, src: int, epoch: int, msg_id: int) -> bool:
        """Record-and-test one (sender, epoch, msg_id): False for a
        duplicate or an id older than the window (treated as a duplicate —
        dropping a too-old retransmit is always safe under at-least-once).
        A NEWER sender epoch (process restart) resets the window; an older
        one is a dead incarnation's delayed frame and is never handled."""
        with self._dedup_lock:
            cur = self._dedup_epoch.get(src)
            if cur is None or epoch > cur:
                self._dedup_epoch[src] = epoch
                self._dedup_seen[src] = set()
                self._dedup_max[src] = -1
            elif epoch < cur:
                return False
            seen = self._dedup_seen.setdefault(src, set())
            newest = self._dedup_max.get(src, -1)
            if msg_id <= newest - self.policy.dedup_window or msg_id in seen:
                return False
            seen.add(msg_id)
            if msg_id > newest:
                self._dedup_max[src] = msg_id
            if len(seen) > 2 * self.policy.dedup_window:
                cut = self._dedup_max[src] - self.policy.dedup_window
                self._dedup_seen[src] = {i for i in seen if i > cut}
            return True

    def _dedup_unrecord(self, src: int, msg_id: int) -> None:
        """Forget a recorded id whose frame was shed before handling
        (inbox overflow): the sender's retransmit must not be rejected as
        a duplicate of a delivery that never happened."""
        with self._dedup_lock:
            self._dedup_seen.get(src, set()).discard(msg_id)

    def recv(self, timeout_s: float) -> Optional[Tuple[Dict, Dict]]:
        """Next inbound (header, trees), or None after ``timeout_s``."""
        try:
            return self.inbox.get(timeout=timeout_s)
        except queue.Empty:
            return None

    # ------------------------------------------------------------------ send

    def alloc_msg_id(self, to: int) -> int:
        """Next monotone message id for destination ``to`` (the leader also
        draws ids for its own self-buffered updates, so every merged update
        has a unique (from, msg_id) identity). Thread-safe: the round loop
        and the pipeline's enqueue path both allocate."""
        with self._send_lock:
            i = self._next_msg_id.get(to, 0)
            self._next_msg_id[to] = i + 1
            return i

    def send(self, to: int, header: Dict, trees: Optional[Dict] = None,
             timeout_s: Optional[float] = None) -> bool:
        """THE one reliable send seam (at-least-once). Stamps the frame
        with this peer's id and a monotone ``msg_id``, then retries failed
        attempts with exponential backoff + deterministic jitter under the
        per-destination deadline budget (``timeout_s`` or
        ``policy.send_deadline_s``), feeding every attempt outcome to the
        failure detector. BLOCKS until delivered or the budget expires;
        :meth:`send_async` is the pipelined fire-and-track variant.

        Returns True once the destination acked one copy; False when the
        partition gate blocks the pair, the circuit is open (peer DOWN, no
        probe due), or the retry budget expired. It never raises on
        network failure — call sites need no per-call error handling; the
        :meth:`stats` counters and the detector carry the evidence."""
        if self.gate is not None and not self.gate.allowed(self.peer_id, to):
            self._bump("dropped_by_gate")
            _telemetry.emit("send", to=to, type=header.get("type"),
                            ok=False, reason="gate", msg_id=None)
            return False
        msg_id = self.alloc_msg_id(to)
        header = dict(header, **{"from": self.peer_id, "msg_id": msg_id,
                                 "msg_epoch": self.epoch})
        return self._send_reliable(to, header, trees, timeout_s,
                                   time.time())

    # ------------------------------------------------- pipelined sender

    def send_async(self, to: int, header: Dict,
                   trees: Optional[Dict] = None,
                   timeout_s: Optional[float] = None) -> bool:
        """Enqueue one logical send on the per-destination sender worker
        and return immediately — the comms/compute overlap seam
        (RUNTIME.md §4): the round loop hands the frame off and starts the
        next local round while the worker runs the whole reliable-send
        protocol (retry/backoff/jitter, detector feeding,
        telemetry) in the background.

        Ordering and identity are exactly the synchronous seam's: the
        ``msg_id`` is allocated HERE in the caller's thread (so
        per-destination allocation order is enqueue order) and the worker
        drains its queue FIFO, so frames to one destination hit the wire
        in msg-id order. The handoff queue is bounded
        (``policy.pipeline_depth``): when the destination is slower than
        the round loop, the enqueue BLOCKS — back-pressure, so a dead or
        slow link can never buffer unbounded model-sized frames.

        Returns True when the frame was enqueued (the delivery outcome is
        reported through the detector/stats/event stream, like every
        at-least-once send); False when the partition gate blocks the pair
        at enqueue time or the transport is closing."""
        if self.gate is not None and not self.gate.allowed(self.peer_id, to):
            self._bump("dropped_by_gate")
            _telemetry.emit("send", to=to, type=header.get("type"),
                            ok=False, reason="gate", msg_id=None)
            return False
        with self._send_lock:
            q = self._send_queues.get(to)
            if q is None:
                q = queue.Queue(maxsize=max(1, self.policy.pipeline_depth))
                self._send_queues[to] = q
                t = threading.Thread(
                    target=self._sender_loop, args=(to, q), daemon=True,
                    name=f"bcfl-dist-send-{self.peer_id}-{to}")
                t.start()
                self._threads.append(t)
            i = self._next_msg_id.get(to, 0)
            self._next_msg_id[to] = i + 1
        # pin the chaos lanes' clock now: a message's fate is a function of
        # the round that produced it, not of when the worker sends it
        chaos_clock = (int(self.chaos.clock_fn())
                       if self.chaos is not None else None)
        item = (dict(header, **{"from": self.peer_id, "msg_id": i,
                                "msg_epoch": self.epoch}),
                trees, timeout_s, time.time(), chaos_clock)
        with self._inflight_cv:
            self._inflight += 1
        blocked = q.full()  # the enqueue is about to wait on the bound
        while not self._closing.is_set():
            try:
                # deadline: bounded handoff — block-on-full IS the
                # back-pressure contract; each wait re-checks closing
                q.put(item, timeout=0.25)
                with self._stats_lock:
                    self.async_enqueued += 1
                    if blocked:
                        self.backpressure_blocks += 1
                return True
            except queue.Full:
                blocked = True
        with self._inflight_cv:
            self._inflight -= 1
            self._inflight_cv.notify_all()
        return False

    def _sender_loop(self, to: int, q: "queue.Queue") -> None:
        """One destination's sender worker: drain the bounded queue FIFO,
        running the full reliable-send protocol per frame. Exits when the
        transport closes and the queue is drained."""
        while True:
            try:
                item = q.get(timeout=0.25)
            except queue.Empty:
                if self._closing.is_set():
                    return
                continue
            header, trees, timeout_s, t_start, chaos_clock = item
            try:
                self._send_reliable(to, header, trees, timeout_s, t_start,
                                    chaos_clock=chaos_clock)
            except Exception:  # noqa: BLE001 — a worker must never die
                logger.exception("peer %d: sender worker to %d failed",
                                 self.peer_id, to)
            finally:
                with self._inflight_cv:
                    self._inflight -= 1
                    self._inflight_cv.notify_all()

    def flush_sends(self, timeout_s: float = 30.0) -> bool:
        """Block until every async send has completed its protocol (queue
        drained AND workers idle), or ``timeout_s``. The runtime calls
        this before broadcasting shutdown (so a queued final update or
        global can't race the stop message) and before closing."""
        deadline = time.monotonic() + timeout_s
        with self._inflight_cv:
            while self._inflight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._inflight_cv.wait(min(left, 0.25))
        return True

    def _send_reliable(self, to: int, header: Dict, trees: Optional[Dict],
                       timeout_s: Optional[float], t_start: float,
                       chaos_clock: Optional[int] = None) -> bool:
        """The reliable-send protocol shared by the sync seam and the
        sender workers: circuit check, probe budgeting, retry loop, chaos
        draws, detector feeding, telemetry. ``header`` arrives
        already stamped with (from, msg_id, msg_epoch). Thread-safe: all
        counters go through the stats lock."""
        msg_id = header["msg_id"]
        if self.adapters is not None:
            trees = to_wire(header, trees, self.adapters)
        if (self.gate is not None
                and not self.gate.allowed(self.peer_id, to)):
            # the async path re-checks at EXECUTION time: a partition span
            # can open between enqueue and dequeue, and skipping the
            # attempt keeps a blocked pair from burning its retry budget
            # (the receiver's own gate is still authoritative)
            self._bump("dropped_by_gate")
            _telemetry.emit("send", to=to, type=header.get("type"),
                            ok=False, reason="gate", msg_id=msg_id)
            return False
        if not self.detector.allow(to):
            self._bump("circuit_skips")
            _telemetry.emit("send", to=to, type=header.get("type"),
                            ok=False, reason="circuit_open", msg_id=msg_id)
            return False
        # a granted probe of a DOWN peer is a SINGLE attempt under a
        # probe-interval-bounded budget: a BLACK-HOLING corpse (SYNs
        # dropped, not refused — real DCN) must cost at most one probe
        # budget per interval, never connect_timeout_s inline in the peer
        # loop per message, and a full retry loop per probe would turn
        # "a corpse costs ~zero" into the leader spending its wall time
        # probing
        state = self.detector.state_of(to)
        probe = state == DOWN
        pol = self.policy
        # CRC ONCE per logical send: the prefix pass walks the leaf
        # buffers zero-copy; re-attempts of the unchanged frame reuse it
        # instead of re-checksumming a potentially multi-hundred-MB tree. The
        # frame itself is never materialized — attempts stream straight
        # from the numpy buffers (wire.write_frame). Computed BEFORE the
        # budget: the adaptive deadline scales with the frame size.
        prefix = frame_prefix(header, trees)
        nbytes = len(prefix) + int.from_bytes(prefix[4:12], "little")
        # the header JSON's share of the frame, as wire._frame_parts
        # writes it: the rest is framing, tree index and payload
        header_bytes = len(json.dumps(header).encode())
        if timeout_s is not None:
            budget_s = timeout_s
        else:
            # detector="phi": per-destination deadline from measured RTT /
            # throughput, proportional to THIS frame's size (the
            # large-frame starvation fix — RUNTIME.md "Timing contract");
            # detector="fixed" keeps the static policy deadline verbatim
            adapt = getattr(self.detector, "send_budget_s", None)
            budget_s = (adapt(to, nbytes) if adapt is not None
                        else pol.send_deadline_s)
        if probe:
            # bound the probe: a single cheap ping under a probe-interval
            # budget, never the full send deadline inline in the peer
            # loop. ONLY true probes (state DOWN) are capped — capping
            # SUSPECT sends too would starve any frame whose genuine
            # wire time exceeds the probe budget (a model-sized update
            # on a slow link would flap SUSPECT->DOWN->REACHABLE forever
            # while only tiny pings get through). The cost: a
            # black-holing destination can freeze the loop for up to
            # the send budget per send during the bounded SUSPECT
            # transient (at most ~down_after failed attempts) before the
            # circuit opens — the transient is bounded, starvation would
            # not be (and under detector="phi" the budget itself adapts
            # to the link)
            budget_s = min(budget_s, pol.probe_interval_s)
        deadline = time.monotonic() + budget_s
        # the limp lane's direction-keyed throttle, drawn once per logical
        # send (the draw is round-keyed) on the wire lane's pinned clock
        limp_bps = (self.limp.throttle_bps(self.peer_id, to,
                                           clock=chaos_clock)
                    if self.limp is not None else None)
        attempt = 0
        while True:
            acts = (self.chaos.actions(self.peer_id, to, msg_id, attempt,
                                       clock=chaos_clock)
                    if self.chaos is not None else None)
            t_att = time.monotonic()
            try:
                self._attempt(to, header, trees, prefix, acts, deadline,
                              limp_bps=limp_bps)
                self.detector.on_success(to)
                note = getattr(self.detector, "note_rtt", None)
                if note is not None:
                    # per-attempt success wall, pacing included: an
                    # injected-slow link is a slow link to the estimator
                    note(to, time.monotonic() - t_att, nbytes)
                # stamped with the send's START instant (t_wall=t_start):
                # the causal timeline needs the send to precede the recv
                # it caused, and emission happens only after the ack
                _telemetry.emit(
                    "send", to=to, type=header.get("type"), ok=True,
                    msg_id=msg_id, msg_epoch=self.epoch,
                    attempts=attempt + 1, bytes=nbytes,
                    header_bytes=header_bytes,
                    wall_s=time.time() - t_start, t_wall=t_start)
                return True
            except TransportError as e:
                self.detector.on_failure(to)
                attempt += 1
                backoff = min(pol.retry_base_s * (2 ** (attempt - 1)),
                              pol.retry_max_s)
                # deterministic jitter in [0.5, 1.5): desynchronizes
                # lockstep retries without a nondeterministic RNG. The
                # sender/destination ids are in the hash — every peer's
                # per-destination msg ids start at 0, so an id-only hash
                # would have all followers of a briefly-dead leader retry
                # in unison (the herd jitter exists to break up)
                backoff *= 0.5 + ((self.peer_id * 7919 + to * 104729
                                   + msg_id * 2654435761 + attempt * 97)
                                  % 1024) / 1024.0
                # per-attempt outcomes are the one high-rate stream —
                # routed through the sampling knob (telemetry_sample);
                # the final outcome below is never sampled
                _telemetry.emit_sampled(
                    "send.attempt", (self.peer_id, to, msg_id, attempt),
                    to=to, msg_id=msg_id, attempt=attempt,
                    outcome=str(e)[:200])
                if (probe or attempt > pol.send_retries
                        or time.monotonic() + backoff >= deadline):
                    self._bump("send_failures")
                    _telemetry.emit(
                        "send", to=to, type=header.get("type"), ok=False,
                        msg_id=msg_id, msg_epoch=self.epoch,
                        attempts=attempt, reason=str(e)[:200],
                        probe=probe, wall_s=time.time() - t_start,
                        t_wall=t_start)
                    # a failed probe of an already-DOWN peer is the
                    # expected steady state, not news — keep the warning
                    # for real delivery failures
                    logger.log(
                        logging.DEBUG if probe else logging.WARNING,
                        "peer %d -> %d: %s msg %d undelivered after %d "
                        "attempt(s): %s", self.peer_id, to,
                        header.get("type"), msg_id, attempt, e)
                    return False
                self._bump("retries")
                logger.debug("peer %d -> %d: attempt %d failed (%s); "
                             "retrying in %.2fs", self.peer_id, to,
                             attempt, e, backoff)
                time.sleep(backoff)

    def _attempt(self, to: int, header: Dict, trees: Optional[Dict],
                 prefix: bytes, acts: Optional[dict],
                 deadline: float, limp_bps: Optional[float] = None) -> None:
        """One transmission attempt: chaos injection, limp pacing, then the
        delivery. ``prefix`` is the clean frame prefix computed once per
        logical send; only the reorder path, which adds a header field,
        recomputes it. Raises :class:`TransportError`."""
        def _chaos(action: str, **extra) -> None:
            # per-injection events are high-rate under an armed lane, so
            # sampled; their coordinates make each injection replayable
            with self._stats_lock:
                self.chaos_injected[action] += 1
            _telemetry.emit_sampled(
                "chaos", (to, header.get("msg_id"), action),
                lane="wire", action=action, dst=to,
                msg_id=header.get("msg_id"), **extra)

        if acts is not None and acts["delay_s"] > 0:
            _chaos("delay", delay_s=acts["delay_s"])
            time.sleep(min(acts["delay_s"],
                           max(deadline - time.monotonic(), 0.0)))
        if acts is not None and acts["reorder_s"] > 0:
            _chaos("reorder", hold_s=acts["reorder_s"])
            header = dict(header, chaos_hold_s=acts["reorder_s"])
            prefix = frame_prefix(header, trees)
        corrupt = (acts["corrupt_pos"]
                   if acts is not None and acts["corrupt"] else None)
        if corrupt:
            _chaos("corrupt")
        if acts is not None and acts["drop"]:
            # the frame vanishes in the network: the sender learns only
            # through the missing ack, modelled without burning a timeout
            _chaos("drop")
            raise TransportError(
                f"chaos wire lane dropped msg {header['msg_id']} "
                f"-> peer {to}")
        if limp_bps is not None and limp_bps > 0:
            # the limp throttle: pace the attempt by the frame's wire time
            # at the degraded rate, bounded by the remaining budget (an
            # over-throttled frame then fails visibly in _deliver)
            nbytes = len(prefix) + int.from_bytes(prefix[4:12], "little")
            pace_s = min(nbytes / limp_bps,
                         max(deadline - time.monotonic(), 0.0))
            if pace_s > 0:
                self._bump("limp_paced")
                _telemetry.emit_sampled(
                    "limp.inject", (to, header.get("msg_id"), "throttle"),
                    kind="throttle", dst=to, msg_id=header.get("msg_id"),
                    bps=limp_bps, pace_s=round(pace_s, 4))
                time.sleep(pace_s)
        self._deliver(to, header, trees, prefix, corrupt, deadline)
        if acts is not None and acts["dup"]:
            # a second clean copy of the same frame within the same
            # deadline: the receiver's dedup window must absorb it
            _chaos("dup")
            try:
                self._deliver(to, header, trees, prefix, None, deadline)
            except TransportError:
                pass

    def _deliver(self, to: int, header: Dict, trees: Optional[Dict],
                 prefix: bytes, corrupt: Optional[list],
                 deadline: float) -> None:
        """One physical delivery: connect, STREAM the frame straight from
        the leaf buffers (wire.write_frame — the payload is never
        concatenated; ``corrupt`` flips bytes in flight), read the ack,
        every socket op capped by the remaining deadline budget. The
        attempt and the chaos duplicate both go through it. Raises
        :class:`TransportError`."""
        budget = deadline - time.monotonic()
        if budget <= 0:
            raise TransportError(f"send deadline budget exhausted "
                                 f"before attempt to peer {to}")
        host, port = self.addrs[to]
        try:
            with socket.create_connection(
                    (host, port),
                    timeout=min(self.connect_timeout_s, budget)) as sock:
                sock.settimeout(min(self.io_timeout_s, budget))
                write_frame(sock, header, trees, corrupt_frac=corrupt,
                            prefix=prefix)
                read_ack(sock, timeout_s=min(self.io_timeout_s, budget))
        except (OSError, socket.timeout, WireError) as e:
            raise TransportError(
                f"peer {self.peer_id} -> {to} ({host}:{port}): {e}") from e

    # ----------------------------------------------------------------- stats

    def stats(self) -> Dict:
        """Transport observability rollup for the peer report."""
        return {
            "retries": self.retries,
            "send_failures": self.send_failures,
            "dups_dropped": self.dups_dropped,
            "crc_drops": self.crc_drops,
            "wire_drops": self.wire_drops,
            "inbox_overflow": self.inbox_overflow,
            "reorders_held": self.reorders_held,
            "circuit_skips": self.circuit_skips,
            "dropped_by_gate": self.dropped_by_gate,
            "limp_paced": self.limp_paced,
            "pipeline": {
                "async_enqueued": self.async_enqueued,
                "backpressure_blocks": self.backpressure_blocks,
                # lint: disable=guarded-by — len() snapshot for the
                # report rollup: a torn size is impossible (GIL) and a
                # stale one is acceptable observability lag
                "workers": len(self._send_queues),
            },
            "chaos_injected": dict(self.chaos_injected),
            "detector": {
                "states": {str(p): s
                           for p, s in self.detector.states().items()},
                "transitions": list(self.detector.transitions),
                **({"phi": self.detector.phi_snapshot()}
                   if isinstance(self.detector, PhiFailureDetector)
                   else {}),
            },
        }
