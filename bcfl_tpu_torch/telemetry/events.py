"""Run-wide event tracing (port of ``bcfl_tpu/telemetry/events.py``,
host-only, the same catalogue and stream format) — crash-safe per-process
telemetry streams
(OBSERVABILITY.md).

The reference repo's entire observability surface is a wall-clock print and
a psutil snapshot (SURVEY.md §3.5/§5); the rebuilt runtime runs real
multi-peer async federation under wire-level chaos, where the only record
of a run used to be a per-peer JSON report written *at exit* — a SIGKILLed
peer left nothing, and nothing correlated a send on peer A with the merge
it caused on peer B. This module is the fix: an append-only,
incrementally-flushed JSONL **event stream per process**.

Design constraints (all load-bearing):

- **Cheap**: emission is a dict + ``json.dumps`` into an in-memory buffer;
  the buffer flushes to the stream file every ``flush_every`` events or
  ``flush_interval_s`` seconds — never an fsync, never inside jitted code.
  High-rate transport events (per-attempt, per-chaos-draw) go through a
  deterministic **sampling knob** (:meth:`EventWriter.emit_sampled`);
  invariant-grade events (final send outcomes, receive dispositions, merge
  lineage) are never sampled.
- **Crash-safe**: the stream is append-only JSONL; a process killed
  mid-write leaves at most one torn final line, which the collator
  (:mod:`bcfl_tpu_torch.telemetry.collate`) tolerates by construction. A killed
  process loses at most the unflushed buffer tail.
- **Correlatable**: every event is stamped with hybrid time (``t_wall``
  wall clock + ``t_mono`` monotonic) and a per-writer monotone ``seq``;
  transport events carry the ``(peer, msg_epoch, msg_id)`` identity the
  transport already assigns, so events are joinable across processes.
- **Never in the way**: the module-level :func:`emit` is a no-op until a
  writer is :func:`install`-ed, and a failed emission is counted and
  dropped, never raised — telemetry can not take down the run it observes.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import threading
import time
import zlib
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)

SCHEMA_VERSION = 1

# Typed event catalogue: event name -> required payload fields (beyond the
# writer's stamps). Emission validates presence; an unknown event name or a
# missing field is a counted drop (and a one-time warning), never a raise.
# Producers may attach any extra fields. OBSERVABILITY.md documents each.
EVENT_TYPES: Dict[str, tuple] = {
    # --- lifecycle ---
    "run.start": ("role",),          # role: "peer" | "engine" | "bench"
    "run.end": ("status",),          # terminal; marks a cleanly-flushed stream
    "report.flush": ("status",),     # a (partial or final) report was written
    # --- spans (fed from metrics.tracing.StepClock and the round loops) ---
    "phase": ("name", "wall_s"),     # one StepClock phase completion
    "round": ("round", "wall_s"),    # one engine round / dist local round
    # --- transport (bcfl_tpu_torch.dist.transport) ---
    "send": ("to", "type", "ok"),    # final outcome of one logical send
    "send.attempt": ("to", "attempt", "outcome"),  # sampled per-attempt
    "recv": ("disposition",),        # accepted|dedup|gate|overflow|hostile|crc|wire
    "detector": ("target", "from", "to"),          # failure-detector transition
    "chaos": ("lane", "action"),     # one injected fault (sampled)
    # --- dist runtime (bcfl_tpu_torch.dist.runtime) ---
    "merge": ("version", "leader", "arrivals", "rejected", "solo",
              "degraded", "component", "wall_s"),  # FedBuff merge + lineage
    "adopt": ("version", "healed"),  # follower adopted a broadcast global
    "broadcast": ("version", "healed"),
    "quorum.below": ("component", "alive", "down"),  # episode entry
    "fork.begin": ("at_version", "component"),
    "fork.heal": ("at_version",),
    "reconcile": ("from_peer",),
    # --- gossip dispatch (bcfl_tpu_torch.dist.gossip, RUNTIME.md "Gossip
    # dispatch"): one neighbor exchange per local round, and the peer-local
    # commutative merge — same required shape as "merge" so every
    # merge-scoped invariant can treat the two uniformly (the merging peer
    # fills the "leader" slot: it IS the merge authority for its own state)
    "gossip.exchange": ("round", "neighbors"),
    "gossip.merge": ("version", "leader", "arrivals", "rejected", "solo",
                     "degraded", "component", "wall_s"),
    # episode entry (rising edge): the peer's reachable cohort shrank
    # below the robust rule's MIN_ORDER_VOTES — merges degrade to the
    # commutative mean until the cohort recovers (partition minority
    # components hit this by construction; the soak counts episodes)
    "gossip.vote_floor": ("votes", "need"),
    # --- elastic membership (bcfl_tpu_torch.dist.membership): one peer's LOCAL
    # live-view transitions (member joined/left the view, not the cluster)
    "membership.join": ("member", "live"),
    "membership.leave": ("member", "reason", "live"),
    # --- ledger (length-bearing; the monotone-heads invariant reads these)
    "ledger": ("op", "chain_len", "rewrite"),  # op: commit|append|resync|adopt_merge
    # --- checkpoints (bcfl_tpu_torch.checkpoint) ---
    "ckpt.save": ("step",),
    "ckpt.restore": ("step",),
    # startup durable-state audit (bcfl_tpu_torch.checkpoint.scrub): one event
    # per scrub pass; status: clean | damaged | empty. Damage detail
    # (per-round classification, torn staging dirs) rides as extras.
    "scrub": ("status",),
    # --- STATE_SYNC peer repair (RUNTIME.md "State-sync protocol") ---
    # reason: empty | damaged | rollback. The repair_authenticated
    # invariant holds adopt to a preceding ok=True verify in the same
    # peer incarnation; refusals name which gate fired (no_chain |
    # bad_links | forked_prefix | no_commitment | digest_mismatch).
    "state.sync.request": ("reason",),
    "state.sync.serve": ("to",),
    "state.sync.verify": ("ok",),
    "state.sync.adopt": ("version",),
    "state.sync.refuse": ("reason",),
    # --- reputation lifecycle (bcfl_tpu_torch.reputation) ---
    "rep.evidence": ("client", "fault"),
    "rep.transition": ("client", "from", "to", "trust"),
    # dist wire-evidence lane (reputation/dist.py): which transport-level
    # observation fed the peer tracker (source: ledger_auth |
    # robust_outlier | staleness | stale_replay | detector_down). Never
    # sampled — the quarantine proofs are queries over these.
    "rep.dist_evidence": ("target", "source", "fault"),
    # --- byzantine lane (bcfl_tpu_torch.dist.byzantine) ---
    # one adversarial injection: which behavior rewrote which outbound
    # update (the baseline legs gate on the total being exactly zero)
    "byz.inject": ("behavior",),
    # --- gray-failure adversary (ROBUSTNESS.md §11) ---
    # one injected limp action: kind = stall (train-seam sleep) |
    # throttle (paced send) | pause (SIGSTOP/SIGCONT from the harness).
    # stall is never sampled (the soak gates count them); throttle is
    # sampled (per-attempt rate)
    "limp.inject": ("kind",),
    # one injected resource fault at a durable-write seam;
    # seam: checkpoint | ledger | events; cls: enospc | emfile
    "resource.inject": ("seam", "cls"),
    # periodic phi-accrual suspicion sample (sampled — one per peer per
    # evidence drain); extras carry window_s/rtt_s/state
    "detector.phi": ("target", "phi"),
    # telemetry shed toggled in response to a durable-write failure:
    # SAMPLED events stop flowing (counted, not buffered) — ledger and
    # checkpoint bytes are never shed. Never sampled itself.
    "write.shed": ("seam", "mode"),
    # emergency retention GC triggered by ENOSPC at a durable seam:
    # oldest checkpoint rounds removed to free space. Never sampled.
    "gc.emergency": ("seam", "removed"),
    # --- anomalies worth surfacing that are not failures ---
    # e.g. what="negative_staleness": a restarted leader's fresh version
    # counter sat below a sender's base version; the merge clamps the
    # decay exponent to 0 and records the raw value here
    "warn": ("what",),
    # --- live monitoring (bcfl_tpu/telemetry/live.py; not ported yet) ---
    # per-round health rollup written by the monitor process into its OWN
    # stream (health.jsonl — deliberately outside the events_*.jsonl glob
    # so the collator never ingests the observer's observations)
    "health": ("round",),
    # threshold alert lifecycle: severity info|warn|critical; the same
    # (what, key) fires once and heals once (healed=true). Only unhealed
    # CRITICAL alerts gate the monitor's exit code.
    "alert": ("what", "severity"),
    # periodic host-resource sample (metrics.ResourceMonitor sampling
    # mode) — lets the health series track memory/CPU drift across a soak
    "resource": ("rss_gb", "cpu_percent"),
}


def _json_default(x: Any):
    """Last-resort coercion for numpy scalars/arrays reaching the stream.
    tolist() first: ndarrays also expose item(), which raises for size>1."""
    if hasattr(x, "tolist"):
        return x.tolist()
    if hasattr(x, "item"):
        return x.item()
    return str(x)


class EventWriter:
    """Buffered append-only JSONL event stream for ONE process.

    ``peer`` is the dist peer id (None for the local engine / bench);
    ``sample`` in [0, 1] is the transport-event sampling rate consumed by
    :meth:`emit_sampled`. Thread-safe: transport serve threads and the
    main loop share one writer; ``seq`` is a per-writer total order."""

    def __init__(self, path: str, peer: Optional[int] = None,
                 run: Optional[str] = None, sample: float = 1.0,
                 flush_every: int = 128, flush_interval_s: float = 2.0):
        self.path = path
        self.peer = peer
        self.run = run
        self.sample = float(sample)
        self.flush_every = max(int(flush_every), 1)
        self.flush_interval_s = float(flush_interval_s)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # append-mode reopen after a crash: if the predecessor died
        # mid-write, the file ends in a torn partial line — terminate it
        # first, or this incarnation's first event would be glued onto
        # it and lost as one unparseable line
        needs_nl = False
        try:
            if os.path.getsize(path) > 0:
                with open(path, "rb") as g:
                    g.seek(-1, os.SEEK_END)
                    needs_nl = g.read(1) != b"\n"
        except OSError:
            pass
        self._f = open(path, "ab")
        if needs_nl:
            self._f.write(b"\n")
        # reentrant: a signal handler (the peer's SIGTERM path) may emit
        # while the interrupted main-thread frame already holds the lock
        self._lock = threading.RLock()
        self._buf: list = []       # guarded-by: _lock — pending lines
        self._seq = 0              # guarded-by: _lock — per-writer order
        self._last_flush = time.monotonic()  # guarded-by: _lock
        self._closed = False       # guarded-by: _lock
        self.emitted = 0           # guarded-by: _lock (writes)
        self.dropped = 0           # guarded-by: _lock (writes)
        self.shed = 0              # guarded-by: _lock (writes) — shed sampled events
        self.shedding = False      # guarded-by: _lock — telemetry-shed active
        self._warned: set = set()  # guarded-by: _lock — warned-once types
        # optional fault seam (faults.plan resource lane): called with the
        # pending byte count before each flush write; may raise OSError to
        # model ENOSPC/EMFILE on the stream file. Installed by the dist
        # runtime, None everywhere else.
        self.write_fault = None

    # ------------------------------------------------------------------ emit

    def emit(self, ev: str, **fields) -> None:
        """Append one typed event. Validates against :data:`EVENT_TYPES`;
        a bad event is counted in ``dropped`` (one warning per event type)
        and never raises — telemetry must not take down the run."""
        try:
            required = EVENT_TYPES.get(ev)
            if required is None:
                self._drop(ev, "unknown event type")
                return
            missing = [k for k in required if k not in fields]
            if missing:
                self._drop(ev, f"missing required fields {missing}")
                return
            rec = {
                "v": SCHEMA_VERSION,
                "ev": ev,
                "run": self.run,
                "peer": self.peer,
                "pid": os.getpid(),
            }
            # explicit t_wall/t_mono in fields override the stamp (the
            # transport stamps sends with their START instant so the
            # causal timeline puts a send before the recv it caused)
            rec["t_wall"] = fields.pop("t_wall", None) or time.time()
            rec["t_mono"] = fields.pop("t_mono", None) or time.monotonic()
            rec.update(fields)
            line = json.dumps(rec, default=_json_default).encode() + b"\n"
            with self._lock:
                if self._closed:
                    return
                # seq is assigned under the lock; serialize it by
                # injecting before the closing brace (cheaper than a
                # second json.dumps of the whole record)
                line = (line[:-2] + b',"seq":%d}\n' % self._seq)
                self._seq += 1
                self._buf.append(line)
                self.emitted += 1
                due = (len(self._buf) >= self.flush_every
                       or time.monotonic() - self._last_flush
                       >= self.flush_interval_s)
                if due:
                    self._flush_locked()
        except Exception as e:  # noqa: BLE001 — observer must never crash the run
            self._drop(ev, repr(e))

    def _drop(self, ev: str, why: str) -> None:
        # under the lock: _drop is reached from concurrent emitters
        # (transport serve threads + the main loop share one writer), and
        # a bare += here is the read-add-store race the guarded-by
        # contract exists to reject — a lost drop count would make the
        # "zero dropped events" gates pass vacuously. RLock, so the
        # flush-failure path (already holding it) re-enters fine.
        with self._lock:
            self.dropped += 1
            warn = ev not in self._warned
            if warn:
                self._warned.add(ev)
        if warn:
            logger.warning("telemetry: dropped %r event (%s)", ev, why)

    def sampled(self, key) -> bool:
        """Deterministic sampling decision for high-rate transport events:
        stable under replay (hash of the message coordinates, not an RNG),
        so two runs of the same schedule sample the same events."""
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        h = zlib.crc32(repr(key).encode()) % 10_000
        return h < self.sample * 10_000

    def emit_sampled(self, ev: str, key, **fields) -> None:
        with self._lock:
            if self.shedding:
                # telemetry-shed: sampled (high-rate) events are the FIRST
                # thing dropped when the disk is failing writes — counted
                # so the shed is visible in the final report, never
                # buffered. Never-sampled events (emit) keep flowing: the
                # invariants read those.
                self.shed += 1
                return
        if self.sampled(key):
            self.emit(ev, **fields)

    def begin_shed(self, seam: str) -> bool:
        """Turn on telemetry-shed (idempotent). Returns True if this call
        flipped it, False if shedding was already active. The caller owns
        emitting ``write.shed`` exactly when this returns True."""
        with self._lock:
            if self.shedding:
                return False
            self.shedding = True
            return True

    # ----------------------------------------------------------------- flush

    def _flush_locked(self) -> None:  # guarded-by: _lock
        if self._buf:
            # detach the buffer BEFORE writing: a reentrant emit (signal
            # handler interrupting this very write) appends to the fresh
            # list and its own flush writes only those events — no line
            # is ever written twice
            buf, self._buf = self._buf, []
            data = b"".join(buf)
            fault = self.write_fault
            try:
                if fault is not None:
                    fault(len(data))  # may raise OSError (injected seam)
            except OSError as e:
                # an injected ENOSPC/EMFILE fails the write before any
                # byte lands: the batch stays buffered, ahead of what
                # arrived meanwhile, for the next flush. (JAX drops it,
                # never-sampled events included, and the invariants then
                # read an accepted frame of that batch as lost.)
                self._buf = buf + self._buf
                self._last_flush = time.monotonic()
                logger.warning("telemetry: flush to %s failed: %s",
                               self.path, e)
                self._shed_on_errno(e)
                return
            except Exception as e:  # noqa: BLE001 — a broken hook drops
                self.dropped += len(buf)
                logger.warning("telemetry: flush to %s failed: %s",
                               self.path, e)
                self._last_flush = time.monotonic()
                return
            try:
                self._f.write(data)
                self._f.flush()  # buffered write to the OS; no fsync
            except Exception as e:  # noqa: BLE001
                # OSError (disk) — but ALSO RuntimeError: a signal
                # handler re-entering the BufferedWriter mid-write raises
                # "reentrant call"; either way the events are counted
                # dropped and the observer never takes down the run
                self.dropped += len(buf)
                logger.warning("telemetry: flush to %s failed: %s",
                               self.path, e)
                self._shed_on_errno(e)
        self._last_flush = time.monotonic()

    def _shed_on_errno(self, e: BaseException) -> None:  # guarded-by: _lock
        if isinstance(e, OSError) and e.errno in (28, 24):
            # ENOSPC/EMFILE on the stream: the disk this stream shares
            # with the ledger/checkpoints is failing writes — shed sampled
            # telemetry immediately so durable bytes get whatever headroom
            # remains. RLock: the write.shed emit below re-enters fine.
            if not self.shedding:
                self.shedding = True
                self.emit("write.shed", seam="events", mode="on",
                          errno=e.errno)

    def _drain_locked(self) -> None:  # guarded-by: _lock
        # a batch an injected fault kept is retried: each flush draws anew
        for _ in range(8):
            self._flush_locked()
            if not self._buf:
                return

    def flush(self) -> None:
        with self._lock:
            if not self._closed:
                self._drain_locked()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._drain_locked()
            self._closed = True
            try:
                self._f.close()
            except OSError:
                pass


# --------------------------------------------------------- process-global seam
# One writer per process, installed by whoever owns the run (PeerRuntime,
# FedEngine.run, bench.py). Everything else — transport serve threads, the
# StepClock, the ledger commit path, the reputation tracker — emits through
# the module functions, which are no-ops until a writer exists. This is what
# keeps emission off every hot path by default.

_writer: Optional[EventWriter] = None


def install(writer: EventWriter) -> EventWriter:
    """Make ``writer`` the process's event stream (closing any previous
    one). Returns it for chaining."""
    global _writer
    if _writer is not None and _writer is not writer:
        _writer.close()
    _writer = writer
    return writer


def uninstall() -> None:
    """Flush, close, and detach the process writer (idempotent)."""
    global _writer
    if _writer is not None:
        _writer.close()
        _writer = None


def get_writer() -> Optional[EventWriter]:
    return _writer


def emit(ev: str, **fields) -> None:
    w = _writer
    if w is not None:
        w.emit(ev, **fields)


def emit_sampled(ev: str, key, **fields) -> None:
    w = _writer
    if w is not None:
        w.emit_sampled(ev, key, **fields)


def flush() -> None:
    w = _writer
    if w is not None:
        w.flush()


@atexit.register
def _atexit_flush() -> None:  # a normally-exiting process never loses its tail
    w = _writer
    if w is not None:
        w.close()
