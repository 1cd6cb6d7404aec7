"""PeerRuntime — one OS process of the multi-process async runtime: port
of ``bcfl_tpu/dist/runtime.py``, the leadered dispatch.

Each peer owns a fixed slice of the global client set and runs its own
local training loop on its own device (the card, unless it was started
with ``--device cpu``); peers exchange updates over
:mod:`bcfl_tpu_torch.dist.transport` and aggregate FedBuff-style at a
component leader, the lowest peer id reachable in the peer's connected
component (peer 0 when the network is whole). The leaderless dispatch
(``dispatch="gossip"``) subclasses this runtime in
:mod:`bcfl_tpu_torch.dist.gossip` through the ``_*_extra`` hooks.

- **Training + wire encode** go through the engine's update-exchange seam
  (:meth:`bcfl_tpu_torch.fed.engine.FedEngine._exchange_updates`,
  ``commit=False``): the wire quantity is the codec payload (the encoded
  delta against the peer's adopted base) under compression, the
  post-train stacked tree otherwise, and the announced ledger digests
  bind each client's fingerprint row to the payload's structure, as the
  local flow chains them. The int8 and top-k codec kernels (K4, K5) run
  here, in every peer.
- **Buffered async aggregation** with MEASURED staleness: an update's
  staleness is the leader's version minus the sender's base version when
  it is merged (arrival order, not a simulated clock); its merge weight
  is ``staleness_decay ** staleness`` (times example counts under
  ``weighted_agg``), and the global takes an ``async_server_lr`` step
  along the weighted-mean delta with the ``_async_merge_scale`` rescale.
- **The ledger over announced digests**: the leader commits each merged
  update's ANNOUNCED digests to its chain, refingerprints what ARRIVED,
  and masks a client whose bytes do not match; every broadcast carries
  the chain suffix since the last one, which followers verify link by
  link before adopting the model.
- **Partitions fork the ledger for real**: during a transport partition
  (the fault plan's groups over peers, on each peer's local-round clock)
  each component's leader extends its own chain from the common prefix,
  so two heads exist. At the heal the other component's leader offers
  its fork to peer 0, which verifies the segment link by link, adopts the
  deterministic merge (:meth:`Ledger.merge_rows`, ``adopt_merge``) and
  the participation-weighted mean of the two fork models, and broadcasts
  the healed global with the whole merged chain.
- **The adversarial half**: under ``aggregator != "mean"`` the leader
  merges one vote per sending peer with a robust rule
  (:mod:`bcfl_tpu_torch.dist.robust`, float64 on the leader's device),
  whose outlier flags, the ledger's auth failures, replay rejections,
  staleness and the failure detector feed a per-peer reputation tracker
  (:mod:`bcfl_tpu_torch.reputation.dist`). A quarantined peer's arrivals
  are refused after the ack and it leaves the merge target; transitions
  are committed to the chain before the broadcast, so followers inherit
  the verdicts, and the tracker rides the checkpoint. The byzantine lane
  (:mod:`bcfl_tpu_torch.dist.byzantine`) rewrites an adversary's updates
  above the wire. Every merge samples the phi detector (``detector.phi``
  events, the tracker's slowness lane), and ``resource_sample_s > 0``
  emits ``resource`` events.
- **Crash and rejoin**: every version divisible by
  ``checkpoint_every_versions`` is checkpointed (the trainable tree, the
  error-feedback residual, the version counters and the chain), and the
  storage lane may damage it right after the commit. A peer restarted
  with ``--resume`` scrubs its checkpoints, restores the newest intact
  one and rejoins with a HELLO. A peer whose durable state is gone or
  older than what it once made durable (``--bootstrap``, or the
  monotone-incarnation guard) trains nothing until a STATE_SYNC transfer
  passes both gates: the served chain verifies from genesis and extends
  the peer's surviving prefix, and the tree refingerprints to the
  server's state-commitment row on that chain. A durable write failing
  on ENOSPC or EMFILE walks a ladder (retention GC, then telemetry shed)
  before the peer exits with its own code.
- **The chaos lanes, driven for real**: the wire lane drops, duplicates,
  holds, delays and corrupts frames at the socket (``WireChaos``), the
  limp lane stalls the train seam and paces degraded links
  (``LimpChaos``), and the resource lane fails durable writes with
  ENOSPC/EMFILE at the checkpoint, ledger and event-stream seams (the
  event stream sheds, never exits). Each draw is the fault plan's, keyed
  by the peer's local round or the seam's write counter.
- **Nothing can wedge**: a hard per-process deadline, an idle watchdog
  (no version progress) and a parent-death check each force a nonzero
  exit, and the harness reaps stragglers.
- **Everything is traced**: each peer writes ``events_peer{p}.jsonl``
  (:mod:`bcfl_tpu_torch.telemetry`): local rounds, transport send/recv
  and detector events, merges with their lineage, ledger commits and
  appends, broadcasts and adoptions; the collator merges the streams
  into one causal timeline and checks the invariants. The peer rewrites
  its JSON report periodically and on SIGTERM, with the kernel launch
  counts and the device's peak memory beside JAX's fields.

Device work stays on the main thread. The intake thread and the sender
workers move only CPU tensors.
"""

from __future__ import annotations

import dataclasses
import errno
import json
import logging
import math
import os
import queue
import signal
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bcfl_tpu_torch import telemetry
from bcfl_tpu_torch.core.fence import fence
from bcfl_tpu_torch.metrics.tracing import StepClock

logger = logging.getLogger(__name__)


class ResumeError(RuntimeError):
    """``--resume`` found no usable durable state and ``--bootstrap`` was
    not given: a peer never silently re-enters the fleet with no state.
    Its own exit code tells a supervisor "my state is gone" apart from a
    crash, stall or deadline."""

    EXIT_CODE = 8


class DurabilityError(RuntimeError):
    """A durable write (checkpoint commit, chain high-water) kept failing
    after every rung of the ladder (retention GC, then telemetry shed).
    Its own exit code says "this host cannot make rounds durable": the
    peer never goes on committing state it could not write."""

    EXIT_CODE = 9


@dataclasses.dataclass
class MergeRecord:
    version: int
    leader: int
    arrivals: List[Dict]  # per merged update: peer/msg_id/staleness/latency/auth
    rejected: List[Dict]  # updates excluded (stale lineage, auth failure)
    wall_s: float
    solo: bool  # produced while partitioned (a fork extension)
    degraded: bool = False  # merged on a reduced quorum (some peer DOWN)
    quorum: Optional[Dict] = None  # {"component", "alive", "down"} when degraded
    robust: Optional[Dict] = None  # robust-rule info (k, trim_t/krum_*) when armed
    robust_degraded: bool = False  # fewer arrivals than the declared precondition


def _tamper_tree(tree: Dict[str, torch.Tensor], frac: float):
    """Flip one byte of one leaf, both chosen by ``frac`` (leaves in the
    ledger's flatten order): the seeded in-flight corruption of a served
    state transfer. The input tree is not mutated."""
    from bcfl_tpu_torch.ledger.ledger import flat_leaves

    names = [n for n, _ in flat_leaves(tree)]
    name = names[min(int(frac * len(names)), len(names) - 1)]
    leaf = tree[name].detach().cpu().contiguous().clone()
    raw = leaf.view(-1).view(torch.uint8)
    if raw.numel():
        pos = min(int(frac * raw.numel()), raw.numel() - 1)
        raw[pos] ^= 0xFF
    return dict(tree, **{name: leaf})


def _tree_digest(tree) -> Optional[str]:
    """Hex params digest of a tree of tensors (host copies, hashlib), or
    None for no tree: the report's record of restored state."""
    from bcfl_tpu_torch.ledger.ledger import params_digest

    if tree is None:
        return None
    return params_digest(_to_host(tree), use_native=False).hex()


def measured_staleness(leader_version: int, base_version: int):
    """``(staleness, clamped)`` of one arrival: the leader's version minus
    the sender's base version, clamped to >= 0 (a negative difference
    would INFLATE the decayed merge weight; ``clamped`` surfaces it)."""
    raw = int(leader_version) - int(base_version)
    return max(raw, 0), raw < 0


def _peer_engine_cfg(cfg, local_clients: int):
    """The embedded per-peer engine config: the peer's own client slice.
    The dist layer owns the async, eval and checkpoint semantics, so the
    inner engine is the plain sync-server build (its round loop is never
    used, only its data, training, codec and ledger pieces), with the
    aggregator pinned to "mean" (its ``collapse`` reduces one peer's slice
    to its vote) and reputation off."""
    from bcfl_tpu_torch.faults import FaultPlan
    from bcfl_tpu_torch.reputation import ReputationConfig

    return cfg.replace(
        runtime="local", sync="sync", mode="server",
        num_clients=local_clients, eval_every=0,
        aggregator="mean", reputation=ReputationConfig(),
        faults=FaultPlan(),  # the straggler lane acts at the transport
        checkpoint_dir=None, checkpoint_every=0, rounds_per_dispatch=1)


def _to_host(tree):
    """A (nested) tree of tensors on the device -> CPU tensors."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.detach().cpu()


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def peak_gb(device: torch.device) -> Optional[float]:
    """The device's peak allocated memory in GB (None on the CPU)."""
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 1e9


class PeerRuntime:
    def __init__(self, cfg, peer_id: int, ports: List[int], run_dir: str,
                 device=None, resume: bool = False, bootstrap: bool = False):
        from bcfl_tpu_torch.compression import codecs as cc
        from bcfl_tpu_torch.dist.transport import (
            LimpChaos,
            PartitionGate,
            PeerTransport,
            WireChaos,
        )
        from bcfl_tpu_torch.fed.engine import FedEngine

        self.cfg = cfg
        self.peer_id = int(peer_id)
        self.peers = cfg.dist.peers
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        # per-process event stream, on by default for the dist runtime
        # ("off" disables, a path overrides the run dir); installed before
        # the transport exists so its threads always see the writer
        self.events_path = None
        stream_dir = telemetry.resolve_stream_dir(cfg.telemetry_dir,
                                                  run_dir)
        if stream_dir is not None:
            self.events_path = os.path.join(
                stream_dir, f"events_peer{self.peer_id}.jsonl")
            telemetry.install(telemetry.EventWriter(
                self.events_path, peer=self.peer_id, run=cfg.name,
                sample=cfg.telemetry_sample))
        # the resource lane at the event stream: the writer's flush-time
        # fault hook consults the seeded per-flush draw, and the writer's
        # own errno handler sheds sampled telemetry (this seam never
        # reaches the exit rung)
        self._events_flush_n = 0
        self._events_fault_busy = False
        if cfg.faults is not None and cfg.faults.resource_enabled:
            w = telemetry.get_writer()
            if w is not None:
                w.write_fault = self._events_write_fault
        k = cfg.num_clients // self.peers
        self.local_clients = k
        self.global_ids = np.arange(self.peer_id * k, (self.peer_id + 1) * k)

        # batches, dropout generators and codec uniforms follow the
        # GLOBAL client ids
        self.eng = FedEngine(_peer_engine_cfg(cfg, k), device=device,
                             client_ids=self.global_ids)
        self.device = self.eng.device
        if self.eng._comp is not None:
            self.eng._ef = cc.zero_residual(self.eng.trainable0, k)

        self.trainable = self.eng.trainable0
        self.version = 0
        self.local_round = 0
        self.chain = self.eng.ledger  # the peer's chain replica (or None)
        # version -> (model tree or None, chain-head hex at creation): an
        # uncompressed update's delta is computed against the model, and
        # the head checks the update's lineage (compressed runs keep only
        # the head)
        self.history: Dict[int, tuple] = {
            0: (self.trainable if self.eng._comp is None else None,
                self._head())}
        self.history_limit = 16

        self.merges: List[MergeRecord] = []
        # host-clock phases of the peer's loop (train, encode, merge,
        # broadcast, ...): in the report, and as ``phase`` events
        self.clock = StepClock()
        self.adopted: List[int] = []
        self._last_broadcast_len = 0  # suffix base of the next chain broadcast
        self._last_hello = 0.0
        self._below_quorum = False
        self._below_quorum_events = 0  # episodes, not loop polls
        self._buffer: List[tuple] = []  # guarded-by: _buffer_lock — (header, trees, recv_time)
        self._buffer_shed = 0  # guarded-by: _buffer_lock (writes)
        # double-buffered intake (cfg.dist.pipeline): the intake thread
        # drains the transport inbox, UPDATE arrivals land in self._buffer
        # under this lock, everything else goes to the control queue the
        # main loop drains; _maybe_merge swaps the buffer out under the
        # lock and merges it while intake fills the fresh one
        self._buffer_lock = threading.Lock()
        self._ctrl: "queue.Queue" = queue.Queue()
        self._intake_thread: Optional[threading.Thread] = None
        # when the current merge window opened (first entry into an empty
        # buffer): the buffer_timeout_s clock
        self._buffer_since = 0.0  # guarded-by: _buffer_lock
        self._stop = False
        self._stopping = False  # a shutdown is being honored
        # the partition lifecycle (fork.begin at the span's entry,
        # fork.heal at its exit, the reconcile offer of a fork leader)
        self.fork: Optional[Dict] = None
        self.reconcile: Optional[Dict] = None
        self._partitioned = False
        self._fork_comps = None
        self._pending_reconcile = False
        self._last_reconcile_try = 0.0
        self._reconciled: Dict[int, int] = {}  # offerer -> version merged
        # durable-state repair: set by _restore when nothing usable
        # survived (--bootstrap) or the monotone-incarnation guard fired;
        # while set the peer neither trains nor announces, it asks live
        # peers for STATE_SYNC until a verified transfer is adopted
        self._resumed = False
        self.bootstrap = bool(bootstrap)
        self._needs_bootstrap = False
        self._bootstrap_reason: Optional[str] = None
        self._repaired: Optional[Dict] = None
        self._last_sync_req = 0.0
        self._sync_target_i = 0
        self._sync_serves: Dict[int, int] = {}  # requester -> serves so far
        self._restored: Optional[Dict] = None  # what _restore adopted
        self._ckpt_saves: List[Dict] = []
        # quarantine_drops is bumped from the intake thread and the merge:
        # a plain += would be a racy read-add-store
        self._qdrop_lock = threading.Lock()
        # per-PEER reputation (reputation/dist.py): wire evidence ->
        # quarantine, transitions committed to the chain, state
        # checkpointed bit for bit; the leader's tracker gates merges
        self.rep = None
        if cfg.reputation.enabled:
            from bcfl_tpu_torch.reputation.dist import DistReputationTracker

            self.rep = DistReputationTracker(cfg.reputation, self.peers,
                                             self.peer_id)
        self._restored_rep: Optional[Dict] = None
        self._det_seen = 0  # detector transitions already fed as evidence
        # the byzantine lane, built only when the plan arms it: otherwise
        # the injection seam in _train_once is absent, not merely inert
        self.byz = None
        if cfg.faults is not None and cfg.faults.byz_enabled:
            from bcfl_tpu_torch.dist.byzantine import ByzantineAdversary

            self.byz = ByzantineAdversary(
                cfg.faults, self.peer_id,
                clock_fn=lambda: self.local_round)
        # the robust rules' declared arrival-count precondition; a merge
        # below it still aggregates (trim clamped), recorded
        # robust_degraded
        self._robust_min = 0
        if cfg.aggregator != "mean":
            from bcfl_tpu_torch.dist.robust import (
                MIN_ORDER_VOTES,
                krum_min_buffer,
            )

            self._robust_min = (
                krum_min_buffer(cfg.dist.buffer or 1, cfg.aggregator_trim)
                if cfg.aggregator == "krum" else MIN_ORDER_VOTES)
        self._resmon = None  # the resource sampler, started by run()
        # the span clock is the peer's LOCAL ROUND: it advances with the
        # peer's own training loop, so every peer crosses the partition
        # span even while cross-partition messages are dropped (a
        # version-keyed clock could deadlock: versions advance only through
        # the messages the partition blocks)
        plan = cfg.faults if (cfg.faults is not None
                              and cfg.faults.partitions) else None
        self.gate = PartitionGate(plan, self.peers,
                                  version_fn=lambda: self.local_round)
        # the wire lane and the limp lane's throttle share the gate's
        # clock; an unarmed lane builds nothing
        faults = cfg.faults
        chaos = (WireChaos(faults, clock_fn=lambda: self.local_round)
                 if faults is not None and faults.wire_enabled else None)
        limp = (LimpChaos(faults, clock_fn=lambda: self.local_round)
                if faults is not None and faults.limp_enabled else None)
        host = cfg.dist.host
        # transport incarnation epoch: a file-backed restart counter, not
        # the wall clock
        epoch_path = os.path.join(run_dir, f"epoch_peer{self.peer_id}")
        try:
            with open(epoch_path) as f:
                epoch = int(f.read().strip()) + 1
        except (OSError, ValueError):
            epoch = 1
        with open(epoch_path, "w") as f:
            f.write(str(epoch))
        self.transport = PeerTransport(
            self.peer_id, [(host, p) for p in ports], gate=self.gate,
            io_timeout_s=min(60.0, cfg.dist.peer_deadline_s),
            chaos=chaos, limp=limp, policy=cfg.dist, epoch=epoch,
            adapters=self.eng.adapters)

        self.ckpt_dir = os.path.join(run_dir, f"ckpt_peer{self.peer_id}")
        # monotone-incarnation high-water marker, like the epoch file a
        # record outside the checkpoint dir: the newest (version,
        # chain_len) this peer ever made durable. A restore landing below
        # it means the durable state was rolled back (or fell back past
        # damage) and must resync forward before announcing anything
        self._hw_path = os.path.join(run_dir,
                                     f"highwater_peer{self.peer_id}")
        if resume:
            self._restore()

        # --- watchdogs: a hung peer FAILS, it never wedges the run ---
        self._t0 = time.time()
        self._last_version_change = time.time()
        self._ppid = os.getppid()
        self._deadline_timer = threading.Timer(
            cfg.dist.peer_deadline_s, self._deadline_fire)
        self._deadline_timer.daemon = True
        self._deadline_timer.start()
        # the deadline timer, the main loop and the SIGTERM handler all
        # write the report: a reentrant lock serializes them
        self._report_lock = threading.RLock()
        self._report_round = -1    # guarded-by: _report_lock (writes)
        self._report_version = -1  # guarded-by: _report_lock (writes)
        self._report_terminal = False  # guarded-by: _report_lock
        self._chain_ok_cache: Optional[bool] = None  # guarded-by: _report_lock
        try:
            signal.signal(signal.SIGTERM, self._sigterm)
        except ValueError:
            pass  # not the main thread (embedded/test use): skip

    # ------------------------------------------------------------- watchdogs

    def _deadline_fire(self):
        logger.error("peer %d: hard deadline %.0fs expired; exiting",
                     self.peer_id, self.cfg.dist.peer_deadline_s)
        self._write_report(status="deadline")
        os._exit(3)

    def _sigterm(self, signum, frame):
        logger.error("peer %d: SIGTERM; writing final partial report",
                     self.peer_id)
        try:
            self._write_report(status="sigterm")
        finally:
            os._exit(7)

    def _maybe_flush_report(self):
        """Rewrite the partial report every ``report_every_rounds`` local
        rounds and on every version change (0 = never mid-run)."""
        every = self.cfg.dist.report_every_rounds
        due = every > 0 and (
            self.version != self._report_version
            or self.local_round - self._report_round >= every)
        if due:
            self._write_report(status="running")

    def _check_watchdogs(self):
        if os.getppid() != self._ppid:
            logger.error("peer %d: supervisor died; exiting", self.peer_id)
            self._write_report(status="orphaned")
            os._exit(5)
        if (time.time() - self._last_version_change
                > self.cfg.dist.idle_timeout_s):
            logger.error("peer %d: no version progress for %.0fs; exiting",
                         self.peer_id, self.cfg.dist.idle_timeout_s)
            self._write_report(status="stalled")
            os._exit(4)

    # ------------------------------------------------------------------ utils

    def _head(self) -> Optional[str]:
        return self.chain.head.hex() if self.chain is not None else None

    def _component(self):
        return self.gate.component_of(self.peer_id)

    def _leader(self) -> int:
        return min(self._component())

    def _note_version(self):
        self._last_version_change = time.time()
        model = self.trainable if self.eng._comp is None else None
        self.history[self.version] = (model, self._head())
        for v in sorted(self.history):
            if len(self.history) <= self.history_limit:
                break
            del self.history[v]

    # --- extension hooks: the reputation tracker rides the checkpoint
    # through the first two; the gossip dispatch (dist/gossip.py) extends
    # all five ---

    def _checkpoint_extra(self) -> Dict:
        """Extra keys folded into the checkpoint state: the per-peer
        tracker's arrays, with the engine's ``rep_*`` keys."""
        return self.rep.checkpoint_state() if self.rep is not None else {}

    def _restore_extra(self, state: Dict) -> None:
        """Twin of :meth:`_checkpoint_extra` on restore; called from
        ``_restore`` inside ``__init__``. Records the restored tracker
        (trust as hex) before anything evolves it, for the resume proof,
        and re-declares each restored quarantine into this incarnation's
        stream: ``no_quarantined_merge`` is scoped to an incarnation, and
        ``from: "restored"`` marks the event as no fresh decision."""
        if self.rep is None or state.get("rep_trust") is None:
            return
        self.rep.restore(state)
        self._restored_rep = self.rep.report()
        for p in self.rep.quarantined_peers():
            telemetry.emit(
                "rep.transition", client=int(p), scope="peer",
                **{"from": "restored", "to": "quarantined",
                   "trust": float(self.rep.tracker.trust[p])})

    def _report_extra(self) -> Dict:
        """Extra keys a dispatch subclass folds into the peer report."""
        return {}

    def _sync_serve_extra(self, header_out: Dict) -> None:
        """Extra header keys a dispatch subclass ships with a STATE_SYNC
        serve (gossip adds its version vector)."""

    def _adopt_extra(self, header: Dict, trees: Dict) -> None:
        """Dispatch-subclass hook after a verified STATE_SYNC adoption
        (gossip refreshes its host state copy and version vector)."""

    def _cast(self, tree):
        """A received model tree on the device, floats in the param
        dtype."""
        from bcfl_tpu_torch.fed.engine import DTYPES

        pd = DTYPES[self.cfg.param_dtype]
        return {p: t.to(device=self.device,
                        dtype=pd if t.is_floating_point() else t.dtype)
                for p, t in tree.items()}

    def _stacked_like(self) -> Dict[str, torch.Tensor]:
        """``[k, ...]`` views of the global tree (no copy): the shape and
        dtype template the codec decodes a slice's payload against."""
        k = self.local_clients
        return {p: x.unsqueeze(0).expand((k,) + tuple(x.shape))
                for p, x in self.trainable.items()}

    # ----------------------------------------------------------- train + send

    def _train_once(self):
        """One local round: every local client fine-tunes from the peer's
        current base; the wire payload comes out of the engine's
        update-exchange seam."""
        from bcfl_tpu_torch.fed import client_step as cs

        cfg, eng = self.cfg, self.eng
        rnd = self.local_round
        t0 = time.time()
        batches, n_ex = eng._round_batches(rnd)
        base = cs.broadcast(self.trainable, self.local_clients)
        with self.clock.phase("train"):
            post, stats = cs.local_updates(eng.local_train, base, batches,
                                           eng._generators(rnd), eng._rmask)
            fence(post)
        with self.clock.phase("encode"):
            ex = eng._exchange_updates(rnd, post, base, None, mode="async",
                                       commit=False)
        del post, base
        digests = None
        if ex.fp is not None:
            digests = [eng._entry_digest(ex.wire_kind, ex.fp[c]).hex()
                       for c in range(self.local_clients)]
        s = stats.double().sum(0).cpu().numpy()
        header = {
            "type": "update", "base_version": int(self.version),
            "round": int(rnd), "wire_kind": ex.wire_kind,
            "lineage": self.history[self.version][1],
            "n_ex": [int(x) for x in np.asarray(n_ex)],
            "digests": digests, "sent_at": time.time(),
        }
        with self.clock.phase("to_host"):
            wire_tree = _to_host(ex.sent)
        del ex
        self.local_round += 1
        telemetry.emit("round", round=rnd, wall_s=time.time() - t0,
                       base_version=int(self.version),
                       train_loss=float(s[0] / max(s[2], 1.0)))

        # the straggler lane, driven for real: a pre-send sleep, so it
        # shows in the measured staleness and latency
        plan = cfg.faults
        delays = (plan.straggler_delays(rnd, self.peers)
                  if plan is not None else None)
        if delays is not None and delays[self.peer_id] > 0:
            time.sleep(float(delays[self.peer_id]))
        self._limp_stall(rnd)

        leader = self._leader()
        if self.byz is not None:
            # the byzantine lane's one injection seam, above the wire: the
            # poisoning behaviors re-announce digests over the mutated
            # payload so ledger auth passes (the robust merge catches
            # them); forgery and equivocation keep the honest
            # announcement, so the leader's refingerprint fails
            header, wire_tree, act = self.byz.corrupt_update(
                header, wire_tree, dst=leader)
            if act is not None and act["reannounce"] and header.get(
                    "digests") is not None:
                header = dict(header, digests=self._announce_digests(
                    header["wire_kind"], wire_tree))
        if leader == self.peer_id:
            # the leader's own update gets a real (from, msg_id) identity
            # too, so every merged update is dedup-accountable
            self._buffer_push((dict(header, **{
                "from": self.peer_id,
                "msg_id": self.transport.alloc_msg_id(self.peer_id),
                "msg_epoch": self.transport.epoch}),
                {"payload": wire_tree}, time.time()))
        elif cfg.dist.pipeline:
            # hand the frame to the per-destination sender worker and
            # start the next local round (comms/compute overlap); the
            # bounded handoff blocks when the link is slower than training
            self.transport.send_async(leader, header, {"payload": wire_tree})
        else:
            self.transport.send(leader, header, {"payload": wire_tree})

    def _limp_stall(self, rnd: int) -> None:
        """The limp lane at the train seam: a real stall on the seeded
        ``(round, peer)`` draw, so the phi detector and the slowness lane
        are graded against measured slowness. Never sampled: a soak counts
        the stalls exactly."""
        plan = self.cfg.faults
        act = plan.limp_action(rnd, self.peer_id) if plan is not None else None
        if act is not None and act["stall_s"] > 0:
            telemetry.emit("limp.inject", kind="stall", round=int(rnd),
                           stall_s=float(act["stall_s"]))
            time.sleep(float(act["stall_s"]))

    def _announce_digests(self, wire_kind: str, tree) -> List[str]:
        """Per-client entry digests of a wire payload, refingerprinted on
        this peer's device through the same fingerprint the honest
        announcement takes: what the poisoning behaviors re-announce."""
        fp = self.eng._fingerprint_rows(wire_kind,
                                        _to_device(tree, self.device))
        return [self.eng._entry_digest(wire_kind, fp[c]).hex()
                for c in range(self.local_clients)]

    # ------------------------------------------------------- leader: merging

    def _buffer_push(self, entry: tuple):
        """Leader-side FedBuff intake, bounded (shed the OLDEST past the
        cap); called from the main loop and the intake thread."""
        cap = max(4, 2 * self.peers, 2 * (self.cfg.dist.buffer or 1))
        with self._buffer_lock:
            if not self._buffer:
                self._buffer_since = entry[2]  # a new merge window opens
            self._buffer.append(entry)
            while len(self._buffer) > cap:
                self._buffer.pop(0)
                self._buffer_shed += 1

    def _maybe_merge(self):
        from bcfl_tpu_torch.dist.transport import DOWN

        cfg = self.cfg
        comp = self._component()
        # quorum degradation: peers the failure detector holds DOWN do not
        # count toward the buffer target; below quorum_frac of the
        # component the leader does not advance the global at all
        states = self.transport.detector.states()
        down = [p for p in comp
                if p != self.peer_id and states.get(p) == DOWN]
        # QUARANTINED peers leave the merge target like DOWN ones (their
        # arrivals are refused after the ack, so waiting for them would
        # hand the adversary a denial of service) but stay in the quorum
        # denominator: a distrusted majority is not a quorum
        quarantined = ([p for p in self.rep.quarantined_peers()
                        if p in comp and p != self.peer_id]
                       if self.rep is not None else [])
        alive = [p for p in comp if p not in down and p not in quarantined]
        if len(alive) < max(1, math.ceil(cfg.dist.quorum_frac * len(comp))):
            if not self._below_quorum:
                self._below_quorum = True
                self._below_quorum_events += 1
                telemetry.emit("quorum.below", component=len(comp),
                               alive=len(alive), down=list(down))
            # nothing else on a parked leader sends: probe the DOWN peers
            # so a healed network restores the quorum
            for p in down:
                self.transport.send(p, {"type": "ping"})
            return
        self._below_quorum = False
        # the target counts DISTINCT senders; target check and swap are
        # one critical section (the intake thread keeps pushing)
        want = min(cfg.dist.buffer or 1, len(alive))
        with self._buffer_lock:
            if not self._buffer:
                return
            distinct = len({int(h.get("from", -1))
                            for h, _, _ in self._buffer})
            if (distinct < want and time.time() - self._buffer_since
                    < cfg.dist.buffer_timeout_s):
                return
            buf, self._buffer = self._buffer, []
        t0 = time.time()
        arrivals, rejected, weighted = [], [], []
        for header, trees, recv_t in buf:
            with self.clock.phase("merge.prepare"):
                out = self._prepare_update(header, trees, recv_t)
            (arrivals if out.get("ok") else rejected).append(out["rec"])
            if out.get("ok"):
                weighted.append(out)
        del buf
        robust_info = None
        if weighted:
            with self.clock.phase("merge.apply"):
                if cfg.aggregator != "mean":
                    robust_info = self._apply_robust_merge(weighted)
                else:
                    self._apply_merge(weighted)
        del weighted
        self.version += 1
        rec = MergeRecord(
            version=self.version, leader=self.peer_id, arrivals=arrivals,
            rejected=rejected, wall_s=time.time() - t0,
            solo=self.gate.components() is not None,
            degraded=bool(down),
            quorum=({"component": len(comp), "alive": len(alive),
                     "down": down, "quarantined": quarantined}
                    if (down or quarantined) else None),
            robust=robust_info,
            # the precondition counts distinct peer VOTES
            robust_degraded=bool(
                robust_info is not None
                and robust_info.get("k", 0) < self._robust_min))
        self.merges.append(rec)
        # the health series' extras: the leader's per-peer trust vector
        # and, with LoRA, the merged adapter's effective rank (the
        # rank-collapse guard statistic); the live monitor folds both
        # into health.jsonl
        trust_map = ({str(p): round(float(self.rep.tracker.trust[p]), 6)
                      for p in range(self.peers)}
                     if self.rep is not None else None)
        eff_rank = None
        if self.eng.adapters:
            from bcfl_tpu_torch.models import lora

            try:
                eff_rank = float(lora.effective_rank(self.trainable))
            except Exception:  # noqa: BLE001 — a health stat never fails the merge
                pass
        # the FedBuff lineage event: which (peer, msg_epoch, msg_id)
        # updates at what measured staleness and weight composed this
        # version, and the chain state it committed
        telemetry.emit(
            "merge", version=rec.version, leader=rec.leader,
            arrivals=rec.arrivals, rejected=rec.rejected, solo=rec.solo,
            degraded=rec.degraded, component=list(comp),
            quorum=rec.quorum, wall_s=rec.wall_s,
            robust=rec.robust, robust_degraded=rec.robust_degraded,
            trust=trust_map, effective_rank=eff_rank,
            **({"chain_len": len(self.chain),
                "head8": self.chain.head.hex()[:16], "rewrite": False}
               if self.chain is not None else {}))
        # the gray-failure observation shares the merge clock whether or
        # not reputation is armed
        self._observe_gray_health()
        if self.rep is not None:
            # the merge is the observation clock: fold the pending evidence
            # AFTER this merge's event (a quarantine it triggers gates the
            # NEXT merge) and commit the transitions BEFORE the history
            # snapshot and the broadcast, so the suffix every follower
            # adopts carries them and the leader's lineage record for this
            # version is the post-rows head the followers hold (otherwise
            # every honest update based on it would bounce as a fork
            # lineage mismatch, and feed the replay lane)
            self._drain_detector_evidence()
            arrived = ([a["peer"] for a in arrivals]
                       + [r["peer"] for r in rejected])
            transitions = self.rep.observe_merge(arrived)
            if transitions and self.chain is not None:
                self.rep.commit_transitions(self.chain, self.version,
                                            transitions)
                telemetry.emit("ledger", op="rep_transition",
                               n=len(transitions),
                               chain_len=len(self.chain), rewrite=False,
                               head8=self.chain.head.hex()[:16])
        self._note_version()
        self._maybe_checkpoint()
        with self.clock.phase("broadcast"):
            self._broadcast_global(healed=False)

    def _drain_detector_evidence(self) -> None:
        """Feed the failure detector's NEW transitions to DOWN since the
        last merge to the tracker (the weakest lane: death is not
        malice)."""
        from bcfl_tpu_torch.dist.transport import DOWN

        det = self.transport.detector
        new = det.transitions_total - self._det_seen
        if new <= 0:
            return
        self._det_seen = det.transitions_total
        recent = list(det.transitions)[-min(new, len(det.transitions)):]
        for t in recent:
            if t.get("to") == DOWN:
                self.rep.note_detector_down(t["peer"])

    def _observe_gray_health(self, feed_rep: bool = True) -> None:
        """Sample the phi detector's per-peer suspicion into the stream
        (``detector.phi``, sampled) and, with reputation armed and
        ``feed_rep``, feed the tracker's slowness lane. The leader calls it
        after each merge event (JAX's clock); a follower, which merges
        nothing, calls it with ``feed_rep=False`` at each adopted global,
        so its stream carries its own samples and its tracker stays the
        leader's rows alone. Severity is the worst of phi over
        ``phi_down``, the measured throughput's shortfall below
        ``min_bandwidth_bps`` and the measured RTT's excess beyond
        ``deadline_floor_s``, each clamped to [0, 1] and 0 for a healthy
        peer, so the down-weight recovers when a limp clears. It never
        reaches the quarantine evidence (``slowness_is_not_malice``)."""
        det = self.transport.detector
        snap_fn = getattr(det, "phi_snapshot", None)
        if snap_fn is None:
            return  # detector="fixed": no continuous suspicion to sample
        phi_down = float(self.cfg.dist.phi_down)
        for key, info in snap_fn().items():
            p = int(key)
            if p == self.peer_id:
                continue
            telemetry.emit_sampled(
                "detector.phi", (int(self.version), p), target=p,
                phi=info["phi"], state=det.state_of(p),
                window_s=info.get("window_s"), rtt_s=info.get("rtt_s"),
                bps=info.get("bps"))
            if self.rep is not None and feed_rep:
                sev_phi = (min(float(info["phi"]) / phi_down, 1.0)
                           if phi_down > 0 else 0.0)
                bps = info.get("bps")
                min_bps = float(self.cfg.dist.min_bandwidth_bps)
                sev_bw = (max(0.0, 1.0 - float(bps) / min_bps)
                          if bps and min_bps > 0 else 0.0)
                rtt = info.get("rtt_s")
                floor = float(self.cfg.dist.deadline_floor_s)
                sev_rtt = (max(0.0, float(rtt) / floor - 1.0)
                           if rtt and floor > 0 else 0.0)
                self.rep.note_slowness(
                    p, min(1.0, max(sev_phi, sev_bw, sev_rtt)))

    def _apply_robust_merge(self, updates: List[Dict]) -> Dict:
        """Robust twin of :meth:`_apply_merge`: each update collapses to
        its slice's weighted mean delta (the mean path's ``collapse``),
        the deltas group into one vote per SENDING peer
        (``combine_votes``), the rule aggregates the votes in float64 on
        this peer's device, and the global takes the mean path's
        ``async_server_lr`` x ``_async_merge_scale``-rescaled step along
        the robust estimate (staleness shrinks the step, never the vote).
        Flagged peers' arrival records carry ``outlier`` and feed the
        tracker, never against self. The info gains the rule's seconds
        and the device it ran on."""
        from bcfl_tpu_torch.dist.robust import combine_votes, robust_merge

        deltas, weights, base_total = self._collapse_updates(updates)
        by_peer: Dict[int, List[int]] = {}
        for i, u in enumerate(updates):
            by_peer.setdefault(int(u["rec"]["peer"]), []).append(i)
        peer_order = sorted(by_peer)
        fence(deltas)
        t0 = time.perf_counter()
        votes = [combine_votes([deltas[i] for i in by_peer[p]],
                               [weights[i] for i in by_peer[p]])
                 for p in peer_order]
        del deltas
        vote_w = [sum(weights[i] for i in by_peer[p]) for p in peer_order]
        agg, flags, info = robust_merge(
            votes, vote_w, self.cfg.aggregator, self.cfg.aggregator_trim)
        fence(agg)
        info["rule_s"] = time.perf_counter() - t0
        info["rule_device"] = self.device.type
        del votes
        info["votes_by_peer"] = {str(p): len(by_peer[p])
                                 for p in peer_order}
        if "krum_selected" in info:
            # robust_merge speaks in vote positions; the record names the
            # PEER whose vote became the global
            info["krum_selected_peer"] = peer_order[info["krum_selected"]]
        dists = info.get("distances")
        for j, p in enumerate(peer_order):
            if not flags[j]:
                continue
            for i in by_peer[p]:
                updates[i]["rec"]["outlier"] = True
            # never against self: a leader quarantining ITSELF while it
            # stays the component leader would wedge the run
            if self.rep is not None and p != self.peer_id:
                self.rep.note_outlier(
                    p, distance=(dists[j] if dists else None))
        if agg is not None:  # None: every vote eliminated, params kept
            self._step(agg, sum(weights), base_total)
        return info

    def _prepare_update(self, header: Dict, trees: Dict, recv_t: float):
        """Commit + verify + decode one buffered update: a record and,
        when accepted, the per-client merge weights and delta rows."""
        from bcfl_tpu_torch.fed import client_step as cs
        from bcfl_tpu_torch.ledger import fingerprint as fp_lib

        cfg, eng = self.cfg, self.eng
        src = int(header["from"])
        base_v = int(header["base_version"])
        staleness, clamped = measured_staleness(self.version, base_v)
        rec = {"peer": src, "msg_id": header.get("msg_id"),
               "msg_epoch": header.get("msg_epoch"),
               "round": int(header["round"]),
               "base_version": base_v, "staleness": staleness,
               "latency_s": max(recv_t - float(header["sent_at"]), 0.0)}
        if clamped:
            rec["staleness_clamped"] = True
            telemetry.emit("warn", what="negative_staleness", peer_from=src,
                           leader_version=int(self.version),
                           base_version=base_v)
        # the post-ack quarantine gate, second seam (the first is
        # _intake_update): an update buffered before the quarantine must
        # not merge after it (no_quarantined_merge)
        if (self.rep is not None and src != self.peer_id
                and self.rep.is_quarantined(src)):
            with self._qdrop_lock:
                self.rep.quarantine_drops += 1
            rec["rejected"] = "peer quarantined (post-ack gate)"
            return {"ok": False, "rec": rec}
        if src not in self._component():
            # buffered before this leader's clock entered a partition span:
            # the sender is now across the cut, and merging it would cross
            # the partition (the receiver's clock is authoritative)
            rec["rejected"] = "outside the leader's component"
            return {"ok": False, "rec": rec}
        # lineage check (both wire formats) before anything touches the
        # chain: the sender names the chain head of its base version, and
        # it must match this leader's history for that version
        hist = self.history.get(base_v)
        if hist is not None and hist[1] != header.get("lineage"):
            rec["rejected"] = "fork lineage mismatch"
            if self.rep is not None and src != self.peer_id:
                # the replay behavior's signature: a stale base's lineage
                # resent against advanced history
                self.rep.note_replay(src, "fork lineage mismatch")
            return {"ok": False, "rec": rec}
        if eng._comp is None and hist is None:
            # the uncompressed wire ships post-train params: the delta
            # needs the base model
            rec["rejected"] = "unknown base version"
            if self.rep is not None and src != self.peer_id:
                self.rep.note_replay(src, "unknown base version")
            return {"ok": False, "rec": rec}
        t_dev = time.time()
        dev = _to_device(trees["payload"], self.device)
        ids = [src * self.local_clients + c
               for c in range(self.local_clients)]
        auth = np.ones((self.local_clients,), np.float32)
        if self.chain is not None and header.get("digests"):
            # commit what the sender ANNOUNCED, then authenticate what
            # ARRIVED: the local flow's commit -> transport -> verify
            # order, across a real wire
            kind = header["wire_kind"]
            for c, d in zip(ids, header["digests"]):
                self.chain.append_digest(int(header["round"]), int(c),
                                         bytes.fromhex(d),
                                         eng._client_payload_bytes)
            telemetry.emit("ledger", op="commit", round=int(header["round"]),
                           n=self.local_clients, chain_len=len(self.chain),
                           rewrite=False,
                           head8=self.chain.head.hex()[:16])
            if kind not in eng._struct_cache:
                eng._struct_cache[kind] = fp_lib.struct_digest(
                    dev, cfg.ledger.use_native)
            fp = fp_lib.client_fingerprint(dev).cpu().numpy()
            for c in range(self.local_clients):
                if eng._entry_digest(kind, fp[c]).hex() != header["digests"][c]:
                    auth[c] = 0.0
            rec["auth"] = auth.tolist()
            if (self.rep is not None and src != self.peer_id
                    and (auth == 0.0).any()):
                # the hard evidence lane: one fingerprint announced,
                # another shipped. Never against self: a leader's forged
                # self-update is already auth-masked out of the merge
                self.rep.note_auth_failure(
                    src, float((auth == 0.0).mean()))
        if eng._comp is None:
            deltas = {p: dev[p] - hist[0][p].unsqueeze(0) for p in dev}
        else:
            # the compressed wire ships the encoded delta itself; a base
            # evicted from the bounded history only can't be
            # lineage-verified (recorded)
            if hist is None:
                rec["lineage_unverified"] = True
            deltas = cs.decode_delta(eng._comp, dev, self._stacked_like())
        del dev
        rec["decode_s"] = time.time() - t_dev
        if self.rep is not None and src != self.peer_id:
            # measured-staleness evidence: a chronically stale peer (real
            # slowness or deliberate replay) decays toward SUSPECT
            self.rep.note_staleness(src, staleness)
        n_ex = np.asarray(header["n_ex"], np.float32)
        alpha = auth * np.float32(cfg.staleness_decay ** staleness)
        base_w = n_ex if cfg.weighted_agg else np.ones_like(n_ex)
        alpha = alpha * base_w
        if self.rep is not None:
            # trust gates the merge weight: the EWMA score scales the
            # update's whole vote (probation adds probation_weight)
            trust_mult = self.rep.gate(src)
            rec["trust"] = round(float(trust_mult), 6)
            alpha = alpha * np.float32(trust_mult)
        if float(alpha.sum()) <= 0.0:
            rec["rejected"] = "all clients eliminated (auth/trust)"
            return {"ok": False, "rec": rec}
        # the update's total merge weight: part of the merge lineage
        rec["weight"] = float(alpha.sum())
        return {"ok": True, "rec": rec, "deltas": deltas, "alpha": alpha,
                "base_w": float(base_w.sum())}

    def _collapse_updates(self, updates: List[Dict]):
        """``(deltas, weights, base_total)``: each update's slice collapsed
        to its weighted mean delta (the engine's ``collapse``), its total
        merge weight, and the sum of the undecayed weights."""
        from bcfl_tpu_torch.fed import client_step as cs

        zero = {p: torch.zeros_like(x) for p, x in self.trainable.items()}
        parts, weights, base_total = [], [], 0.0
        for u in updates:
            w = torch.as_tensor(np.asarray(u["alpha"], np.float32),
                                device=self.device)
            parts.append(cs.collapse(u["deltas"], w, zero, self.eng.agg))
            u["deltas"] = None
            weights.append(float(np.asarray(u["alpha"]).sum()))
            base_total += u["base_w"]
        return parts, weights, base_total

    def _step(self, direction: Dict, total: float, base_total: float):
        """The FedBuff step along ``direction``: ``async_server_lr`` times
        sum(weights) / sum(undecayed weights), so decay shrinks the
        applied step, not just the relative votes."""
        scale = total / max(base_total, 1e-9)
        step = float(np.float32(self.cfg.async_server_lr * scale))
        self.trainable = {p: x + step * direction[p].to(x.dtype)
                          for p, x in self.trainable.items()}

    def _apply_merge(self, updates: List[Dict]):
        """FedBuff step along the staleness-weighted mean delta: the
        updates' slice deltas combine weighted by their total weights."""
        parts, weights, base_total = self._collapse_updates(updates)
        total = sum(weights)
        ws = [np.float32(w / total) for w in weights]
        merged = {p: sum(float(w) * part[p] for w, part in zip(ws, parts))
                  for p in self.trainable}
        self._step(merged, total, base_total)

    def _global_frame(self, start: int, healed: bool = False) -> Dict:
        """The header of a GLOBAL carrying the chain rows from ``start``
        (the suffix since the last broadcast, or the whole chain)."""
        header = {"type": "global", "version": int(self.version),
                  "healed": bool(healed)}
        if self.chain is not None:
            header["chain_start"] = int(start)
            header["chain_prev_head"] = self.chain.head_at(start).hex()
            header["chain"] = self.chain.segment(start)
        else:
            header["chain"] = None
        return header

    def _broadcast_global(self, healed: bool):
        """Send the new global to every other peer of the component, with
        the chain suffix since the last broadcast. A heal sends the whole
        chain, since the merge rewrote history past the fork point; so
        does every broadcast at or past the target version, the last ones
        of the run: a follower whose replica no longer ends where the
        suffix starts (it served or took a STATE_SYNC, whose commitment
        row only its replica holds) then rebuilds it from the broadcast
        itself, and not through a HELLO round trip that the leader's
        shutdown can overtake. Mid-run, such a follower asks for the
        whole state (HELLO)."""
        full = healed or self.version >= self.cfg.num_rounds
        start = 0 if full else self._last_broadcast_len
        header = self._global_frame(start, healed)
        if self.chain is not None:
            self._last_broadcast_len = len(self.chain)
        telemetry.emit("broadcast", version=int(self.version),
                       healed=bool(healed), full=full)
        model = _to_host(self.trainable)
        for p in self._component():
            if p == self.peer_id:
                continue
            # with the pipeline on, broadcasts ride the per-destination
            # sender workers (FIFO per destination: version N goes out
            # before N+1) while the leader starts its next round
            if self.cfg.dist.pipeline:
                self.transport.send_async(p, header, {"model": model})
            else:
                self.transport.send(p, header, {"model": model})

    # --------------------------------------------------- partition lifecycle

    def _update_partition_state(self):
        comps = self.gate.components()
        if comps is not None and not self._partitioned:
            self._partitioned = True
            self._fork_comps = comps
            self.fork = {
                "at_version": int(self.version),
                "fork_base": (int(len(self.chain))
                              if self.chain is not None else None),
                "head_at_fork": self._head(),
                "component": list(self.gate.component_of(self.peer_id)),
            }
            telemetry.emit("fork.begin", at_version=int(self.version),
                           component=self.fork["component"],
                           head8=(self._head() or "")[:16],
                           fork_base=self.fork["fork_base"])
            logger.info("peer %d: partition began at version %d "
                        "(component %s)", self.peer_id, self.version,
                        self.fork["component"])
        elif comps is None and self._partitioned:
            self._partitioned = False
            self.fork["head_before_heal"] = self._head()
            self.fork["chain_len_before_heal"] = (
                int(len(self.chain)) if self.chain is not None else None)
            old_comp = next(c for c in self._fork_comps
                            if self.peer_id in c)
            if min(old_comp) == self.peer_id and self.peer_id != 0:
                # this peer led a fork component: it offers the fork
                self._pending_reconcile = True
            telemetry.emit("fork.heal", at_version=int(self.version),
                           head8=(self._head() or "")[:16])
            logger.info("peer %d: partition healed at version %d (head %s)",
                        self.peer_id, self.version,
                        (self._head() or "")[:16])

    def _solo_weight(self) -> float:
        """The participation this peer's fork gathered (arrivals merged
        in its solo merges): its weight in the reconcile consensus."""
        return float(sum(len(m.arrivals) for m in self.merges if m.solo)
                     or 1.0)

    def _try_reconcile(self):
        """Offer the fork to the global leader, throttled and retried until
        a healed GLOBAL supersedes it: a send can succeed at the socket and
        still be dropped by the leader's own gate while its clock is in
        the span, so only an adopted healed global clears the offer."""
        if not self.gate.allowed(self.peer_id, 0):
            return
        if time.time() - self._last_reconcile_try < 2.0:
            return
        self._last_reconcile_try = time.time()
        header = {
            "type": "reconcile", "version": int(self.version),
            "rows": self.chain.segment(0) if self.chain is not None else None,
            "weight": self._solo_weight(),
        }
        self.transport.send(0, header, {"model": _to_host(self.trainable)})

    def _handle_reconcile(self, header: Dict, trees: Dict):
        """The global leader's side of the heal: verify the offered fork
        segment, adopt the deterministic chain merge, take the
        participation-weighted mean of the two fork models and broadcast
        the healed global."""
        from bcfl_tpu_torch.ledger import Ledger

        src = int(header["from"])
        if int(header["version"]) <= self._reconciled.get(src, -1):
            # a retried offer of a fork already merged (the offerer resends
            # until the healed global reaches it): merging it again would
            # count its model twice. Resend the healed state instead.
            self.transport.send(src, self._global_frame(0, healed=True),
                                {"model": _to_host(self.trainable)})
            return
        t0 = time.time()
        rec = {"from_peer": src, "their_version": int(header["version"]),
               "my_version": int(self.version)}
        their_model = self._cast(trees["model"])
        their_weight = float(header.get("weight") or 1.0)
        my_weight = self._solo_weight()
        if self.chain is not None and header.get("rows") is not None:
            rows = header["rows"]
            their_heads = [bytes.fromhex(r["head"]) for r in rows]
            fork = self.chain.fork_point(their_heads)
            rec["fork_point"] = fork
            rec["my_head"] = self._head()
            rec["their_head"] = rows[-1]["head"] if rows else None
            rec["forked"] = (rec["my_head"] != rec["their_head"])
            bad = Ledger.verify_segment(
                self.chain.head_at(fork), rows[fork:],
                self.cfg.ledger.use_native)
            if bad != -1:
                # a tampered fork segment is never adopted: the offerer is
                # sent the current, unmerged global instead
                rec["segment_rejected_at"] = int(bad)
                self.reconcile = rec
                logger.warning("peer %d: rejected tampered reconcile "
                               "segment from %d (link %d)",
                               self.peer_id, src, bad)
                self._broadcast_global(healed=False)
                return
            merged = Ledger.merge_rows(self.chain.segment(fork), rows[fork:])
            self.chain.adopt_merge(fork, merged)
            rec["merged_entries"] = len(merged)
            rec["merged_head"] = self._head()
            rec["chain_ok"] = (self.chain.verify_chain() == -1)
            # a declared history rewrite: the monotone-heads invariant
            # accepts this kind of length change only
            telemetry.emit("ledger", op="adopt_merge",
                           chain_len=len(self.chain), rewrite=True,
                           head8=(self._head() or "")[:16],
                           fork_point=fork)
        # the model consensus of the healed components: the
        # participation-weighted mean of the two fork models (float32
        # weights, summed in this order, as JAX's _tree_wsum does)
        total = my_weight + their_weight
        w_mine = float(np.float32(my_weight / total))
        w_theirs = float(np.float32(their_weight / total))
        self.trainable = {p: w_mine * x + w_theirs * their_model[p]
                          for p, x in self.trainable.items()}
        del their_model
        self.version = max(self.version, int(header["version"])) + 1
        self._note_version()
        rec["healed_version"] = int(self.version)
        rec["wall_s"] = time.time() - t0
        self.reconcile = rec
        self._reconciled[src] = int(header["version"])
        telemetry.emit("reconcile", **rec)
        self._maybe_checkpoint()
        self._broadcast_global(healed=True)
        logger.info("peer %d: reconciled fork from peer %d -> version %d "
                    "(chain head %s)", self.peer_id, src, self.version,
                    (self._head() or "")[:16])

    # --------------------------------------------------------- follower side

    def _request_resync(self, leader: int):
        """Ask the leader for the whole state (throttled): the suffix a
        broadcast carried did not extend this replica."""
        if time.time() - self._last_hello < 2.0:
            return
        self._last_hello = time.time()
        self.transport.send(leader, {"type": "hello",
                                     "version": int(self.version)})

    def _extends_replica(self, start: int, rows: List[Dict],
                         prev_head: Optional[str]) -> bool:
        """Does a broadcast suffix from ``start`` continue this replica?
        It may begin before the replica's end when the rows it overlaps
        are the replica's own (a peer repaired over STATE_SYNC already
        holds the server's commitment row, which the server's next
        suffix carries again): the overlap must match head for head."""
        n = len(self.chain)
        if not (start <= n <= start + len(rows)):
            return False
        if self.chain.head_at(start).hex() != prev_head:
            return False
        return all(rows[i]["head"] == self.chain.heads[start + i].hex()
                   for i in range(n - start))

    def _handle_global(self, header: Dict, trees: Dict):
        from bcfl_tpu_torch.ledger import Ledger

        version = int(header["version"])
        if self._needs_bootstrap:
            # a repair in flight: globals carry no state commitment, so a
            # bootstrapping peer adopts only through the verified
            # STATE_SYNC path
            return
        if version <= self.version:
            return
        if self._pending_reconcile and not header.get("healed"):
            # a fork is pending: adopting an ordinary global would replace
            # the fork chain the reconcile must deliver, and clearing the
            # offer here could cancel one the leader never received (its
            # gate drops sends while its clock is still in the span). The
            # healed broadcast supersedes everything.
            return
        if self.chain is not None and header.get("chain") is not None:
            rows = header["chain"]
            start = int(header.get("chain_start", 0))
            if start == 0:
                # full sync (a heal or a hello reply): rebuild and verify
                # the whole replica from genesis; a declared rewrite, since
                # a heal may shorten a fork replica's chain
                replica = Ledger(self.cfg.ledger.use_native)
                if replica.append_rows(rows) != -1:
                    logger.error("peer %d: global v%d carried an "
                                 "unverifiable chain; not adopting",
                                 self.peer_id, version)
                    return
                self.chain = self.eng.ledger = replica
                telemetry.emit("ledger", op="resync",
                               chain_len=len(self.chain), rewrite=True,
                               head8=self.chain.head.hex()[:16])
                if self.rep is not None:
                    # inherit the leader's committed reputation verdicts:
                    # a rejoining peer knows who is quarantined
                    self.rep.absorb_rows(rows)
            elif self._extends_replica(start, rows,
                                       header.get("chain_prev_head")):
                # contiguous suffix: verify each new link as it lands
                new_rows = rows[len(self.chain) - start:]
                if self.chain.append_rows(new_rows) != -1:
                    logger.error("peer %d: global v%d suffix failed link "
                                 "verification; resyncing", self.peer_id,
                                 version)
                    self._request_resync(int(header["from"]))
                    return
                telemetry.emit("ledger", op="append",
                               chain_len=len(self.chain), rewrite=False,
                               head8=self.chain.head.hex()[:16])
                if self.rep is not None:
                    # the suffix carries the leader's reputation rows:
                    # every follower tracks its verdicts
                    self.rep.absorb_rows(new_rows)
            else:
                # a gap (missed broadcasts) or a diverged base (a fork
                # rewrite): never adopt a model whose chain this replica
                # cannot verify
                self._request_resync(int(header["from"]))
                return
        with self.clock.phase("adopt"):
            self.trainable = self._cast(trees["model"])
        self.version = version
        self.adopted.append(version)
        self._note_version()
        telemetry.emit("adopt", version=version,
                       healed=bool(header.get("healed")),
                       leader=int(header.get("from", -1)))
        self._observe_gray_health(feed_rep=False)
        if header.get("healed"):
            # only the healed global clears a pending offer: it is the one
            # broadcast that incorporated this peer's fork
            self._pending_reconcile = False
        self._maybe_checkpoint()

    def _handle_hello(self, header: Dict):
        """A peer asks for the whole state: the leader replies with the
        model and the full chain."""
        if self._leader() != self.peer_id:
            return
        self.transport.send(int(header["from"]), self._global_frame(0),
                            {"model": _to_host(self.trainable)})

    # ------------------------------------------------- state-sync repair

    def _sync_targets(self) -> List[int]:
        """Peers a bootstrap request cycles through: the leader first (it
        holds the authoritative state), then every other peer, so a
        damaged leader repairs from its followers."""
        leader = min(p for p in range(self.peers) if p != self.peer_id)
        rest = [p for p in range(self.peers)
                if p not in (self.peer_id, leader)]
        return [leader] + rest

    def _maybe_request_sync(self):
        """Throttled STATE_SYNC requests while ``_needs_bootstrap``: ask
        one live peer (cycling) for its full verified state."""
        if not self._needs_bootstrap:
            return
        if time.time() - self._last_sync_req < 2.0:
            return
        self._last_sync_req = time.time()
        targets = self._sync_targets()
        if not targets:
            return
        dst = targets[self._sync_target_i % len(targets)]
        self._sync_target_i += 1
        have_len = len(self.chain) if self.chain is not None else 0
        telemetry.emit("state.sync.request",
                       reason=self._bootstrap_reason or "empty",
                       to=int(dst), have_version=int(self.version),
                       have_len=have_len)
        self.transport.send(dst, {
            "type": "state_sync_req",
            "reason": self._bootstrap_reason or "empty",
            "version": int(self.version), "have_len": int(have_len)})

    def _handle_state_sync_req(self, header: Dict):
        """Serve a damaged or empty peer the full current state, anchored
        to the chain: a state-commitment row binding the state's digest at
        this version is appended (once per distinct digest) before the
        transfer, so the receiver verifies the chain segment link by link
        and then refingerprints the tree against committed history."""
        from bcfl_tpu_torch.ledger.ledger import Ledger, params_digest

        if self._needs_bootstrap:
            return  # damaged itself: the requester's cycle finds another
        src = int(header["from"])
        model = _to_host(self.trainable)
        header_out = {"type": "state_sync", "version": int(self.version)}
        if self.chain is not None:
            # hashlib over the state's bytes (the digest is the same as
            # the C++ core's, and faster on a model-sized tree)
            digest = params_digest(model, use_native=False)
            if Ledger.find_state_commitment(
                    self.chain.segment(0), self.version,
                    self.peer_id) != digest:
                self.chain.commit_state(self.version, self.peer_id, digest)
                telemetry.emit("ledger", op="commit_state",
                               chain_len=len(self.chain), rewrite=False,
                               head8=self.chain.head.hex()[:16])
            header_out["chain"] = self.chain.segment(0)
        else:
            header_out["chain"] = None
        self._sync_serve_extra(header_out)
        serial = self._sync_serves.get(src, 0)
        self._sync_serves[src] = serial + 1
        tam = (self.cfg.faults.sync_tamper_action(self.peer_id, src, serial)
               if self.cfg.faults is not None else None)
        if tam is not None:
            # the seeded in-flight tamper, after the digest was committed:
            # the refusal it provokes shows the refingerprint gate holds
            model = _tamper_tree(model, tam["frac"])
        telemetry.emit("state.sync.serve", to=src,
                       version=int(self.version),
                       chain_len=(len(self.chain)
                                  if self.chain is not None else 0),
                       tampered=tam is not None, serial=serial)
        self.transport.send(src, header_out, {"model": model})

    def _handle_state_sync(self, header: Dict, trees: Dict):
        """Adopt a served state only after both gates pass: (1) the chain
        segment verifies link by link from genesis and extends this peer's
        surviving prefix (a tampered row or a forked history fails here);
        (2) the received tree refingerprints to the commitment row the
        chain carries for exactly this (version, server). A refusal
        re-enters the request cycle. A serve landing after a completed
        repair goes through the same gates, so a tampered late transfer
        still surfaces as a refusal, but is never adopted and never
        re-enters the cycle."""
        from bcfl_tpu_torch.ledger.ledger import (
            GENESIS,
            Ledger,
            params_digest,
        )

        adopting = self._needs_bootstrap
        server = int(header["from"])
        version = int(header["version"])
        rows = header.get("chain")
        refuse = None
        digest = recomputed = None
        if self.chain is not None:
            if not rows:
                refuse = "no_chain"
            elif Ledger.verify_segment(
                    GENESIS, rows, self.cfg.ledger.use_native) != -1:
                refuse = "bad_links"
            else:
                heads = [bytes.fromhex(r["head"]) for r in rows]
                if self.chain.fork_point(heads) < len(self.chain):
                    # the served history contradicts what this peer still
                    # durably holds (a fork, or a rolled-back server)
                    refuse = "forked_prefix"
                else:
                    digest = Ledger.find_state_commitment(rows, version,
                                                          server)
                    if digest is None:
                        refuse = "no_commitment"
                    else:
                        recomputed = params_digest(trees["model"],
                                                   use_native=False)
                        if recomputed != digest:
                            refuse = "digest_mismatch"
        telemetry.emit("state.sync.verify", ok=refuse is None,
                       src=server, version=version,
                       digest8=(recomputed.hex()[:16]
                                if recomputed is not None else None),
                       reason=refuse)
        if refuse is not None:
            logger.warning("peer %d: refusing state_sync from %d (%s)",
                           self.peer_id, server, refuse)
            telemetry.emit("state.sync.refuse", reason=refuse, src=server,
                           version=version)
            if adopting:
                self._last_sync_req = 0.0  # next target, now
            return
        if not adopting:
            return  # a clean late serve: audited, nothing to adopt
        if self.chain is not None:
            replica = Ledger(self.cfg.ledger.use_native)
            replica.append_rows(rows)  # verified above; rebuilds the heads
            self.chain = self.eng.ledger = replica
            telemetry.emit("ledger", op="resync", chain_len=len(self.chain),
                           rewrite=True, head8=self.chain.head.hex()[:16])
            if self.rep is not None:
                self.rep.absorb_rows(rows)
        with self.clock.phase("adopt"):
            self.trainable = self._cast(trees["model"])
        self.version = version
        self.adopted.append(version)
        self._note_version()
        self._adopt_extra(header, trees)
        self._needs_bootstrap = False
        reason = self._bootstrap_reason
        self._bootstrap_reason = None
        self._repaired = {"from": server, "version": version,
                          "reason": reason}
        telemetry.emit("state.sync.adopt", version=version, src=server,
                       digest8=(digest.hex()[:16]
                                if digest is not None else None),
                       chain_len=(len(self.chain)
                                  if self.chain is not None else 0),
                       reason=reason)
        logger.info("peer %d: repaired from peer %d at version %d (%s)",
                    self.peer_id, server, version, reason)
        self._maybe_checkpoint()

    # --------------------------------------------------- checkpoint / resume

    def _durable_write(self, seam: str, counter: int, fn):
        """One durable write through the ladder: a write failing with
        ENOSPC or EMFILE (the commit protocol is all-or-nothing, so a
        retry is safe) first drops every retained checkpoint round but the
        newest, then sheds sampled telemetry, then raises
        :class:`DurabilityError`. The resource lane's seeded draw for
        ``(seam, counter)`` fails the first ``depth`` attempts the same
        way (``resource.inject`` events, one per injected attempt); a real
        error out of ``fn`` walks the same ladder."""
        plan = self.cfg.faults
        act = (plan.resource_action(seam, counter, self.peer_id)
               if plan is not None and plan.resource_enabled else None)
        remedies = 0
        while True:
            try:
                if act is not None and remedies < act["depth"]:
                    err = (errno.ENOSPC if act["cls"] == "enospc"
                           else errno.EMFILE)
                    telemetry.emit("resource.inject", seam=seam,
                                   cls=act["cls"], counter=int(counter),
                                   depth=int(act["depth"]),
                                   attempt=remedies, errno=err)
                    raise OSError(err, os.strerror(err))
                return fn()
            except OSError as e:
                if e.errno not in (errno.ENOSPC, errno.EMFILE):
                    raise
                if remedies == 0:
                    self._emergency_gc(seam)
                elif remedies == 1:
                    self._shed_telemetry(seam)
                else:
                    raise DurabilityError(
                        f"peer {self.peer_id}: durable write at the "
                        f"{seam!r} seam (counter {counter}) still failing "
                        f"(errno {e.errno}) after emergency GC and "
                        f"telemetry shed") from e
                remedies += 1

    def _emergency_gc(self, seam: str) -> None:
        """First rung: drop every retained round but the newest (the peer
        stays restorable even if the retry fails too)."""
        from bcfl_tpu_torch.checkpoint.checkpoint import (
            _fsync_dir,
            _list_rounds,
            _remove_round,
        )

        rounds = _list_rounds(self.ckpt_dir)
        victims = rounds[:-1]
        for r in victims:
            _remove_round(self.ckpt_dir, r, keep_meta=False)
        if victims:
            _fsync_dir(self.ckpt_dir)
        telemetry.emit("gc.emergency", seam=seam, removed=len(victims),
                       kept=len(rounds) - len(victims))

    def _shed_telemetry(self, seam: str) -> None:
        """Second rung: stop buffering sampled telemetry (the invariants
        read only never-sampled events; ledger and checkpoint bytes are
        never shed)."""
        w = telemetry.get_writer()
        if w is not None and w.begin_shed(seam):
            telemetry.emit("write.shed", seam=seam, mode="on")

    def _events_write_fault(self, nbytes: int) -> None:
        """The resource lane at the event-stream flush: consult the seeded
        per-flush draw and fail the stream write cleanly. The writer's own
        errno handler sheds sampled telemetry in response, so this seam
        never reaches the exit rung. The counter is the seam's own flush
        sequence; the busy flag keeps the inject event's own flush from
        drawing again."""
        if self._events_fault_busy:
            return
        n = self._events_flush_n
        self._events_flush_n += 1
        act = self.cfg.faults.resource_action("events", n, self.peer_id)
        if act is None:
            return
        err = errno.ENOSPC if act["cls"] == "enospc" else errno.EMFILE
        self._events_fault_busy = True
        try:
            telemetry.emit("resource.inject", seam="events",
                           cls=act["cls"], counter=n,
                           depth=int(act["depth"]), errno=err,
                           nbytes=int(nbytes))
            raise OSError(err, os.strerror(err))
        finally:
            self._events_fault_busy = False

    def _maybe_checkpoint(self):
        from bcfl_tpu_torch.checkpoint import save_checkpoint
        from bcfl_tpu_torch.compression import codecs as cc

        cfg = self.cfg
        every = cfg.dist.checkpoint_every_versions
        if not every or self.version % every:
            return
        # the report first: a kill lands only after a commit, and the
        # report it leaves behind must be at least as new as that commit
        # (this incarnation's kernel launches included)
        self._write_report(status="running")
        t0 = time.time()
        with self.clock.phase("checkpoint"):
            state = {
                "trainable": self.trainable,
                "version": np.int64(self.version),
                "local_round": np.int64(self.local_round),
                "seed": np.int64(cfg.seed),
                "compress_format": np.frombuffer(
                    cc.wire_format(self.eng._comp).encode(), np.uint8).copy(),
                "ef_residual": self.eng._ef,
            }
            state.update(self._checkpoint_extra())
            # both durable seams run the ladder: the checkpoint commit
            # (the state, then the meta sidecar with the chain) and the
            # high-water marker the rollback guard reads
            path = self._durable_write(
                "checkpoint", self.version,
                lambda: save_checkpoint(
                    self.ckpt_dir, self.version, state,
                    self.chain.to_json() if self.chain is not None else None,
                    keep_last=cfg.dist.checkpoint_keep_last))
            self._durable_write(
                "ledger",
                len(self.chain) if self.chain is not None else self.version,
                self._write_highwater)
        del state
        self._ckpt_saves.append({
            "version": int(self.version), "save_s": time.time() - t0,
            "bytes": sum(f.stat().st_size for f in os.scandir(path)
                         if f.is_file())})
        # the storage lane: damage the committed state per the seeded
        # (version, peer) draw, after the commit (media failure, never an
        # interrupted writer)
        action = (cfg.faults.storage_action(self.version, self.peer_id)
                  if cfg.faults is not None else None)
        if action is not None:
            from bcfl_tpu_torch.checkpoint import apply_storage_fault

            record = apply_storage_fault(self.ckpt_dir, action)
            if record is not None:
                telemetry.emit("chaos", lane="storage", action=record["cls"],
                               version=int(self.version), **{
                                   k: v for k, v in record.items()
                                   if k != "cls"})

    def _read_highwater(self) -> Optional[Dict]:
        try:
            with open(self._hw_path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _write_highwater(self):
        hw = self._read_highwater()
        cur = {"version": int(self.version),
               "chain_len": len(self.chain) if self.chain is not None else 0}
        if hw is not None and hw.get("version", -1) >= cur["version"]:
            return
        tmp = self._hw_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(cur, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._hw_path)

    def _restore(self):
        """``--resume``: scrub the checkpoint dir, restore the newest
        intact round (loaded to the CPU with ``weights_only=True``, then
        moved to this peer's device) after the seed and wire-format
        guards, and force a bootstrap when nothing usable survived
        (``--bootstrap``) or the restored version sits below the durable
        high-water."""
        from bcfl_tpu_torch.checkpoint import restore_latest, scrub
        from bcfl_tpu_torch.compression import codecs as cc
        from bcfl_tpu_torch.ledger import Ledger

        t0 = time.time()
        with self.clock.phase("scrub"):
            report = scrub(self.ckpt_dir)
        scrub_s = time.time() - t0
        restored = restore_latest(self.ckpt_dir)
        if restored is None:
            if not self.bootstrap:
                raise ResumeError(
                    f"peer {self.peer_id}: --resume found no usable "
                    f"checkpoint in {self.ckpt_dir} "
                    f"(scrub: {'empty' if report['empty'] else 'damaged'}, "
                    f"damaged={list(report['damaged'])}, "
                    f"torn={list(report['torn'])}); pass --bootstrap to "
                    f"opt into ledger-authenticated peer repair")
            self._needs_bootstrap = True
            self._bootstrap_reason = ("empty" if report["empty"]
                                      else "damaged")
            self._restored = {"scrub_s": scrub_s, "version": None}
            logger.warning("peer %d: no usable checkpoint (%s); will "
                           "bootstrap from a live peer", self.peer_id,
                           self._bootstrap_reason)
            return
        _, state, ledger_json = restored
        ck_seed = state.get("seed")
        if ck_seed is not None and int(ck_seed) != self.cfg.seed:
            raise ValueError(
                f"peer checkpoint seed {int(ck_seed)} != config seed "
                f"{self.cfg.seed}: resuming would change every stream")
        ck_comp = state.get("compress_format")
        if ck_comp is not None:
            ck_comp = bytes(ck_comp.numpy().astype(np.uint8)).decode()
            here = cc.wire_format(self.eng._comp)
            if ck_comp != here:
                raise ValueError(
                    f"peer checkpoint wire format {ck_comp!r} != this "
                    f"run's {here!r}")
        self.trainable = self._cast(state["trainable"])
        self.version = int(state["version"])
        self.local_round = int(state["local_round"])
        if state.get("ef_residual") is not None and self.eng._comp is not None:
            self.eng._ef = {p: x.to(self.device, torch.float32)
                            for p, x in state["ef_residual"].items()}
        if ledger_json and self.chain is not None:
            self.chain = self.eng.ledger = Ledger.from_json(
                ledger_json, self.cfg.ledger.use_native)
        self._restore_extra(state)
        del state, restored
        self.history = {
            self.version: (self.trainable if self.eng._comp is None
                           else None, self._head())}
        self._resumed = True
        # what this incarnation holds on its device, read back: the resume
        # proof holds these digests against the checkpoint file
        self._restored = {
            "version": self.version, "restore_s": time.time() - t0 - scrub_s,
            "scrub_s": scrub_s,
            "trainable_digest": _tree_digest(self.trainable),
            "ef_residual_digest": _tree_digest(self.eng._ef)}
        logger.info("peer %d: restored checkpoint at version %d "
                    "(round %d)", self.peer_id, self.version,
                    self.local_round)
        hw = self._read_highwater()
        if hw is not None and self.version < int(hw.get("version", -1)):
            # monotone-incarnation guard: the restored state is older than
            # one a previous incarnation made durable (a rolled-back dir,
            # or damage forced the restore past the newest round); the
            # peer resyncs forward before training or announcing, or it
            # would re-announce old versions as new
            self._needs_bootstrap = True
            self._bootstrap_reason = "rollback"
            logger.warning(
                "peer %d: restored version %d is below the durable "
                "high-water %d (rollback or damage fallback); resyncing "
                "forward before rejoining", self.peer_id, self.version,
                int(hw["version"]))

    # --------------------------------------------------------------- intake

    def _intake_update(self, header: Dict, trees: Dict):
        """The UPDATE intake seam (serial path and intake thread): the
        post-ack quarantine gate, then the leader's locked arrival buffer.
        An update addressed to a stale leader is dropped; the sender
        rebases on the next global."""
        src = int(header.get("from", -1))
        if (self.rep is not None and src != self.peer_id
                and self.rep.is_quarantined(src)):
            # refused after the ack, like a partition-gate drop: the
            # sender's failure detector must not read distrust as death
            with self._qdrop_lock:
                self.rep.quarantine_drops += 1
            return
        if self._leader() == self.peer_id:
            self._buffer_push((header, trees, time.time()))

    def _intake_loop(self):
        """Pipelined intake: UPDATE frames go straight into the arrival
        buffer, everything else to the control queue the main loop
        drains. Only CPU tensors pass through here."""
        while not self._stop:
            msg = self.transport.recv(timeout_s=0.05)
            if msg is None:
                continue
            header, trees = msg
            if header.get("type") == "update":
                self._intake_update(header, trees)
            else:
                self._ctrl.put(msg)

    def _next_ctrl(self, timeout_s: float):
        if self._intake_thread is not None:
            try:
                return self._ctrl.get(timeout=timeout_s)
            except queue.Empty:
                return None
        return self.transport.recv(timeout_s=timeout_s)

    def _handle(self, header: Dict, trees: Dict):
        kind = header.get("type")
        if kind == "update":
            self._intake_update(header, trees)  # serial path only
        elif kind == "ping":
            pass  # liveness probe: the ack was the answer
        elif kind == "global":
            self._handle_global(header, trees)
        elif kind == "reconcile":
            if self.peer_id == 0:
                self._handle_reconcile(header, trees)
        elif kind == "hello":
            self._handle_hello(header)
        elif kind == "state_sync_req":
            self._handle_state_sync_req(header)
        elif kind == "state_sync":
            self._handle_state_sync(header, trees)
        elif kind == "shutdown":
            self._honor_shutdown()
        else:
            logger.warning("peer %d: unknown message type %r",
                           self.peer_id, kind)

    def _honor_shutdown(self):
        """Stop, after the frames that were acked before the shutdown was
        sent: a wire-lane reorder hold can release the leader's final
        global after its shutdown arrived, and stopping at once would end
        this peer one version short with another chain head. Waits for the
        held frames (bounded by the hold), then handles what is queued."""
        if self._stopping:
            return
        self._stopping = True
        try:
            plan = self.cfg.faults
            hold = (plan.wire_reorder_hold_s
                    if plan is not None and plan.wire_reorder_prob > 0
                    else 0.0)
            if hold <= 0 or not self.transport.wait_held(hold + 1.0):
                return
            # the released frames pass through the intake thread (if any)
            # to the control queue
            msg = self._next_ctrl(timeout_s=0.1)
            while msg is not None:
                self._handle(*msg)
                msg = self._next_ctrl(timeout_s=0.0)
        finally:
            self._stop = True

    def _global_eval(self):
        s = self.eng.eval_one(self.trainable, self.eng.eval_batches)
        s = s.double().cpu().numpy()
        return float(s[0] / max(s[2], 1.0)), float(s[1] / max(s[2], 1.0))

    def _finalize(self):
        loss = acc = None
        try:
            loss, acc = self._global_eval()
        except Exception as e:  # an eval failure must not eat the report
            logger.warning("peer %d: final eval failed (%s)", self.peer_id, e)
        self._final_eval = {"loss": loss, "acc": acc}
        if self._resmon is not None:
            self._resmon.stop_sampling()
        # drain the sender pipeline before the stop message: the final
        # broadcast rides the workers
        self.transport.flush_sends(timeout_s=self.cfg.dist.send_deadline_s)
        for p in range(self.peers):
            if p != self.peer_id:
                self.transport.send(p, {"type": "shutdown",
                                        "version": int(self.version)})
        self._stop = True

    def run(self) -> int:
        logger.info("peer %d/%d up on %s: clients %s, version %d%s",
                    self.peer_id, self.peers, self.device,
                    list(self.global_ids), self.version,
                    " (resumed)" if self._resumed else "")
        telemetry.emit("run.start", role="peer", peers=self.peers,
                       resumed=self._resumed, version=int(self.version),
                       epoch=self.transport.epoch,
                       pipeline=bool(self.cfg.dist.pipeline))
        self.transport.start()
        # periodic host-resource sampling (resource_sample_s): only with
        # an event stream, which the sampler emits through; a failure is
        # logged, never fatal
        if (self.cfg.dist.resource_sample_s > 0
                and self.events_path is not None):
            try:
                from bcfl_tpu_torch.metrics.metrics import ResourceMonitor

                self._resmon = ResourceMonitor(run_dir=self.run_dir)
                self._resmon.start_sampling(self.cfg.dist.resource_sample_s)
            except Exception as e:  # noqa: BLE001 — an observer never kills a peer
                logger.warning("resource sampling unavailable: %s", e)
        if self.cfg.dist.pipeline:
            self._intake_thread = threading.Thread(
                target=self._intake_loop, daemon=True,
                name=f"bcfl-dist-intake-{self.peer_id}")
            self._intake_thread.start()
        self._write_report(status="running")
        if self._resumed and self.peer_id != 0 and not self._needs_bootstrap:
            self.transport.send(0, {"type": "hello",
                                    "version": int(self.version)})
        try:
            while not self._stop:
                self._check_watchdogs()
                self._maybe_flush_report()
                msg = self._next_ctrl(timeout_s=0.05)
                while msg is not None:
                    self._handle(*msg)
                    msg = self._next_ctrl(timeout_s=0.0)
                if self._stop:
                    break
                if self._needs_bootstrap:
                    # damaged, empty or rolled-back state: repair first; no
                    # training, merging or announcing until a verified
                    # transfer is adopted (the idle watchdog bounds it)
                    self._maybe_request_sync()
                    time.sleep(0.05)
                    continue
                self._update_partition_state()
                if self._pending_reconcile:
                    self._try_reconcile()
                if self._leader() == self.peer_id:
                    self._maybe_merge()
                if (self.peer_id == 0 and self.version >= self.cfg.num_rounds
                        and self.gate.components() is None
                        and (self.fork is None
                             or self.reconcile is not None)):
                    # target reached, the mesh whole and any fork of this
                    # run reconciled: evaluate, tell everyone, stop. Never
                    # mid-partition (a gate-blocked shutdown would strand
                    # the other component) nor before the heal (the fork
                    # evidence would be lost)
                    self._finalize()
                if self._stop:
                    break
                if (self.version < self.cfg.num_rounds
                        or self.gate.components() is not None
                        or (self.peer_id == 0 and self.fork is not None
                            and self.reconcile is None)):
                    # train past the target while a span is active or a
                    # fork is unresolved: the span clock IS the local
                    # round, so stopping would freeze the peer in the
                    # partition
                    self._train_once()
                else:
                    time.sleep(0.05)  # waiting for shutdown or merges
        except DurabilityError as e:
            # the ladder's last rung: exit with its own code, never go on
            # committing state that could not be made durable
            logger.error("%s", e)
            self._write_report(status="undurable")
            return DurabilityError.EXIT_CODE
        finally:
            # a short drain so a last enqueued frame is not cut off
            # mid-stream by close
            self.transport.flush_sends(timeout_s=2.0)
            self.transport.close()
            self._deadline_timer.cancel()
            if self._resmon is not None:
                self._resmon.stop_sampling()
        self._write_report(status="ok")
        return 0

    # ---------------------------------------------------------------- report

    def _write_report(self, status: str):
        """Atomic (tmp + rename) report write. ``"running"`` is the
        periodic partial flush; any other status is terminal, closes the
        event stream (run.end + flush) and wins over later rewrites."""
        with self._report_lock:
            if self._report_terminal:
                return
            if status != "running":
                self._report_terminal = True
            self._write_report_locked(status)

    def _chain_ok(self, status: str) -> Optional[bool]:  # guarded-by: _report_lock
        if self.chain is None:
            return None
        # the full re-hash runs on terminal writes only
        if status != "running" or self._chain_ok_cache is None:
            self._chain_ok_cache = self.chain.verify_chain() == -1
        return self._chain_ok_cache

    def _write_report_locked(self, status: str):  # guarded-by: _report_lock
        from bcfl_tpu_torch.ops import registry

        self._report_round = self.local_round
        self._report_version = self.version
        staleness = [a["staleness"] for m in self.merges for a in m.arrivals]
        latencies = [a["latency_s"] for m in self.merges for a in m.arrivals]
        tstats = self.transport.stats()
        report = {
            "peer": self.peer_id,
            "peers": self.peers,
            "status": status,
            "pid": os.getpid(),
            "incarnation": self.transport.epoch,
            "resumed": self._resumed,
            "device": str(self.device),
            "final_version": int(self.version),
            "local_rounds": int(self.local_round),
            "merges": [dataclasses.asdict(m) for m in self.merges],
            "solo_merges": sum(1 for m in self.merges if m.solo),
            "degraded_merges": sum(1 for m in self.merges if m.degraded),
            "below_quorum_events": self._below_quorum_events,
            "buffer_shed": self._buffer_shed,
            "adopted_versions": self.adopted,
            "staleness_values": staleness,
            "arrival_latency_s": latencies,
            "transport": tstats,
            "send_failures": tstats["send_failures"],
            "dropped_by_gate": tstats["dropped_by_gate"],
            "fork": self.fork,
            "reconcile": self.reconcile,
            # the byzantine-tolerance surfaces: the per-peer tracker, the
            # tracker as restored (trust as hex), and the adversary's
            # injection counts (exactly zero with the lane off)
            "reputation": (self.rep.report()
                           if self.rep is not None else None),
            "restored_reputation": self._restored_rep,
            "byzantine": (self.byz.stats() if self.byz is not None
                          else {"armed": False, "injected": {},
                                "total": 0}),
            "restored_from_version": (self._restored or {}).get("version"),
            # the restore's seconds and the digests of the trainable and
            # residual this incarnation restored onto its device
            "restored": self._restored,
            # why this peer bootstrapped and from whom it repaired
            "bootstrap_reason": self._bootstrap_reason,
            "repaired": self._repaired,
            "checkpoints": self._ckpt_saves,
            "chain_len": len(self.chain) if self.chain is not None else None,
            "chain_head": self._head(),
            "chain_ok": self._chain_ok(status),
            "final_eval": getattr(self, "_final_eval", None),
            "events": self.events_path,
            "wall_s": time.time() - self._t0,
            # the kernels this process launched (K4/K5 under the codec)
            # and the device's peak memory
            "kernel_launches": registry.launch_counts(),
            "phases": self.clock.summary(),
            "peak_gb": peak_gb(self.device),
            # the event stream's flushes (the resource lane's events-seam
            # counter; counted only while the lane is armed)
            "events_flushes": getattr(self, "_events_flush_n", 0),
        }
        report.update(self._report_extra())
        path = os.path.join(self.run_dir, f"report_peer{self.peer_id}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(report, f, indent=2)
        os.replace(tmp, path)
        telemetry.emit("report.flush", status=status)
        if status != "running":
            # run.end marks the stream cleanly closed; the flush makes it
            # durable on the os._exit watchdog paths too
            telemetry.emit("run.end", status=status,
                           version=int(self.version),
                           local_rounds=int(self.local_round))
        telemetry.flush()


def peer_main(argv=None) -> int:
    """Entry point of one peer process (``python -m bcfl_tpu_torch.dist``);
    ends the process with the run's exit code."""
    import argparse

    ap = argparse.ArgumentParser(prog="bcfl_tpu_torch.dist")
    ap.add_argument("--config", required=True,
                    help="path to the supervisor-written FedConfig JSON")
    ap.add_argument("--peer-id", type=int, required=True)
    ap.add_argument("--ports", required=True,
                    help="comma-separated listen ports, one per peer")
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest intact checkpoint of this "
                         "peer's run-dir checkpoints and rejoin")
    ap.add_argument("--bootstrap", action="store_true",
                    help="with --resume: if no usable checkpoint survives, "
                         "repair from a live peer over verified STATE_SYNC "
                         "instead of failing loudly")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--threads", type=int, default=None,
                    help="cap the peer's CPU threads (torch.set_num_threads)")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format=f"[peer {args.peer_id}] %(levelname)s %(message)s")
    if args.threads:
        torch.set_num_threads(args.threads)

    from bcfl_tpu_torch.dist.launch import cfg_from_json

    with open(args.config) as f:
        cfg = cfg_from_json(f.read())
    ports = [int(p) for p in args.ports.split(",")]
    runtime_cls = PeerRuntime
    if cfg.dist.dispatch == "gossip":
        from bcfl_tpu_torch.dist.gossip import GossipPeerRuntime

        runtime_cls = GossipPeerRuntime
    try:
        rt = runtime_cls(cfg, args.peer_id, ports, args.run_dir,
                         device=args.device, resume=args.resume,
                         bootstrap=args.bootstrap)
        rc = rt.run()
    except ResumeError as e:
        # "durable state unusable and repair not authorized": an operator
        # decision, not a crash
        logger.error("%s", e)
        rc = ResumeError.EXIT_CODE
    except DurabilityError as e:
        logger.error("%s", e)
        rc = DurabilityError.EXIT_CODE
    telemetry.flush()
    # the report and the event stream are on disk: leave without the
    # interpreter's teardown, which can abort (SIGABRT) while daemon
    # sender/intake threads and the CUDA runtime still hold resources
    logging.shutdown()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
