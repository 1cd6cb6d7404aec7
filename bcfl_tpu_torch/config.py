"""Configuration: port of ``bcfl_tpu/config.py`` (``PartitionConfig``,
``TopologyConfig``, ``LedgerConfig``, ``FedConfig``; the codec config
lives in :mod:`bcfl_tpu_torch.compression.codecs` as in JAX).

``FedConfig`` holds the fields the ported slices run, with the JAX
package's names, types and defaults (the fault plan, reputation, robust
aggregation, checkpoint, LoRA and cohort fields included), plus the
switches of features the port does not have yet, and one field of its
own, ``num_layers``, a depth cut at the model's full width. A value the slice does
not support raises ``ValueError`` naming the field and saying it is "not
ported yet" — the port never silently runs something other than what was
asked for.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from bcfl_tpu_torch.compression.codecs import CompressionConfig
from bcfl_tpu_torch.faults.plan import FaultPlan
from bcfl_tpu_torch.reputation.lifecycle import ReputationConfig


@dataclasses.dataclass(frozen=True)
class PartitionConfig:
    """How each client selects its local train/test subset (same fields,
    defaults and checks as the JAX ``PartitionConfig``).

    ``iid``: every client draws ``iid_samples`` random examples, optionally
    afresh each round. ``contiguous`` (Non-IID): client ``k`` takes train
    ``[stride*k, stride*k + train_span)`` and either the trailing test slice
    (``test_mode='trailing'``) or the shared ``[0, test_span)``
    (``test_mode='fixed'``)."""

    kind: str = "iid"  # "iid" | "contiguous"
    iid_samples: int = 100
    iid_test_samples: Optional[int] = None  # default: same as iid_samples
    resample_each_round: bool = False
    stride: int = 300
    train_span: int = 240
    test_span: int = 60
    test_mode: str = "trailing"  # "trailing" | "fixed"

    def __post_init__(self):
        if self.kind not in ("iid", "contiguous"):
            raise ValueError(f"unknown partition kind: {self.kind!r}")
        if self.test_mode not in ("trailing", "fixed"):
            raise ValueError(f"unknown test_mode: {self.test_mode!r}")
        if self.kind == "contiguous":
            if self.train_span > self.stride:
                raise ValueError(
                    f"train_span {self.train_span} > stride {self.stride}: "
                    "client slices would overlap")
            if (self.test_mode == "trailing"
                    and self.train_span + self.test_span > self.stride):
                raise ValueError(
                    f"train_span+test_span "
                    f"{self.train_span + self.test_span} > stride "
                    f"{self.stride}: trailing test slice would overlap the "
                    "next client's train slice")


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    """P2P network model and anomaly gating (the JAX ``TopologyConfig``:
    same fields and defaults)."""

    anomaly_filter: Optional[str] = None  # None|"pagerank"|"dbscan"|"zscore"|"community"
    # bandwidth matrix source: "reference" = the notebooks' fixed 10-node
    # graph (10 clients only), "random" = sampled in [bw_low, bw_high] mbps
    bandwidth: str = "reference"
    bw_low: float = 88.0
    bw_high: float = 496.0
    # gossip mixing coefficient for ring gossip (serverless mode)
    gossip_alpha: float = 0.5
    gossip_steps: int = 1  # ring-gossip rounds per federated round


@dataclasses.dataclass(frozen=True)
class LedgerConfig:
    """The hash-chained weight ledger (the JAX ``LedgerConfig``: same
    fields and defaults). ``use_native`` selects the C++ SHA-256 core
    (:mod:`bcfl_tpu_torch.native`, g++ at first use); without a toolchain
    the ledger hashes with ``hashlib``, with identical digests."""

    enabled: bool = False
    use_native: bool = True
    # ledger-entry payload size (bytes) for communication accounting: the
    # reference models the blockchain payload as 0.043 GB vs the 0.4036 GB
    # full model (MT notebook cell 27 vs 23)
    entry_payload_bytes: int = 46_170_898


def parse_lora_ranks(spec: str) -> Tuple[int, ...]:
    """Parse a ``lora_ranks`` spec ("2,4,8") into a tuple of positive ints.
    The spec is cycled over the stacked client axis: client ``i`` trains at
    ``spec[i % len(spec)]``. Raises with the offending spec on bad input."""
    try:
        ranks = tuple(int(tok) for tok in spec.split(","))
    except ValueError:
        raise ValueError(
            f"lora_ranks must be comma-separated positive ints "
            f"(e.g. '2,4,8'), got {spec!r}")
    if not ranks or any(r <= 0 for r in ranks):
        raise ValueError(
            f"lora_ranks entries must all be > 0, got {spec!r}")
    return ranks


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """(The JAX ``DistConfig``: same fields, defaults and checks.)
    Multi-host async P2P runtime knobs (``FedConfig.runtime='dist'``,
    RUNTIME.md). Each peer is a real OS process owning a slice of the
    clients; update exchange is length-prefixed TCP over loopback/DCN
    carrying the configured codec's wire format plus ledger fingerprint
    digests; aggregation is FedBuff-style buffered async with MEASURED
    (arrival-order) staleness. All timeouts are hard deadlines — a hung
    peer fails the run instead of wedging it (the harness reaps it)."""

    peers: int = 2
    host: str = "127.0.0.1"
    # first listen port; peer p listens on base_port + p. 0 = the spawner
    # picks free ports and passes them down (dist.harness.run_dist, CLI)
    base_port: int = 0
    # merge target at a component leader, in DISTINCT sending peers (each
    # update carries its sender's whole client slice; several updates from
    # one sender count once toward the target and collapse into one vote
    # under a robust aggregator — the "f of k" arithmetic is over peers).
    # 0 = 1: merge on every arrival — the pure-async setting, and the one
    # that makes the measured staleness distribution non-degenerate. Must
    # be <= peers.
    buffer: int = 0
    # leader-side cap on waiting for the buffer to fill: merge whatever
    # arrived once this many seconds pass since the first buffered update
    # (a departed peer must not stall every future merge)
    buffer_timeout_s: float = 20.0
    # peer-process watchdog: no observable progress (no message, no local
    # round) for this long -> the peer exits nonzero instead of wedging
    idle_timeout_s: float = 120.0
    # hard wall deadline for one peer process; the in-process watchdog
    # enforces it even if the supervisor died
    peer_deadline_s: float = 600.0
    # checkpoint every N adopted/produced global versions (0 = off); the
    # crash/rejoin path restores from the newest one
    checkpoint_every_versions: int = 1
    # checkpoint retention: keep only the newest K committed rounds on
    # disk (0 = keep everything). Removal of older rounds is ordered
    # strictly AFTER the new round's commit+fsync, so a crash mid-GC can
    # only ever leave EXTRA rounds, never fewer than K usable ones.
    checkpoint_keep_last: int = 0
    # --- self-healing transport policy (RUNTIME.md "Delivery contract") ---
    # every logical send retries failed attempts with exponential backoff
    # (base * 2^k, capped at retry_max_s, deterministically jittered) up to
    # send_retries RE-tries, all under the per-destination send_deadline_s
    # wall budget — at-least-once delivery, made safe by the receiver's
    # per-sender (from, msg_id) dedup window
    send_retries: int = 4
    retry_base_s: float = 0.05
    retry_max_s: float = 2.0
    send_deadline_s: float = 20.0
    # circuit-breaker failure detector: consecutive send-attempt failures
    # move a peer REACHABLE -> SUSPECT (suspect_after) -> DOWN
    # (down_after); any success snaps it back to REACHABLE. While DOWN the
    # circuit is open — sends are skipped except one probe per
    # probe_interval_s, so a recovered peer is re-detected without paying
    # a connect timeout on every message
    suspect_after: int = 2
    down_after: int = 6
    probe_interval_s: float = 2.0
    # --- failure-detection mode (RUNTIME.md "Timing contract") ---
    # "phi" (default) = adaptive phi-accrual-style estimator: per-peer
    # inbound-interval EWMA + variance feed a CONTINUOUS suspicion level
    # phi (monotone in silence, snapped back by any liveness evidence);
    # suspect/down become thresholds on phi and send deadlines adapt per
    # destination from measured RTT/throughput (floor/ceiling clamped
    # below). "fixed" = the consecutive-counter detector above with the
    # static send_deadline_s — bit-compatible with pre-gray-failure
    # replays (the knob the existing dist_chaos legs pin).
    detector: str = "phi"
    # phi thresholds: suspicion grows by 1 per consecutive failed send
    # attempt plus the peer's silence beyond its adaptive expected window
    # (so the defaults grade like suspect_after=2 / down_after=6 under
    # pure failures, while pure silence also accrues — the gray-failure
    # signal the fixed counter is blind to)
    phi_suspect: float = 2.0
    phi_down: float = 6.0
    # clamp on the adaptive expected-silence window (EWMA mean + 3 sigma
    # of inbound intervals): the floor keeps a chatty link from making
    # sub-second silences suspicious, the ceiling bounds how long an
    # unheard-from peer can stay unsuspected
    phi_window_floor_s: float = 5.0
    phi_window_ceil_s: float = 120.0
    # clamp on the adaptive per-destination send deadline (measured RTT
    # headroom + frame_bytes / measured throughput). floor bounds how
    # aggressive a fast link's deadline may get; ceiling bounds how long
    # a limping link can hold a send. detector="fixed" ignores both and
    # uses send_deadline_s verbatim.
    deadline_floor_s: float = 2.0
    deadline_ceil_s: float = 120.0
    # assumed link throughput (bytes/s) before any measurement exists:
    # the size-proportional term of the adaptive deadline divides by this
    # until real throughput samples arrive, so a first-contact 32 MB
    # frame gets a budget that scales with its size instead of starving
    # under a latency-tuned constant
    min_bandwidth_bps: float = 1_048_576.0
    # gossip hedging: when a sampled neighbor's phi crosses this
    # threshold at dispatch time, the peer re-draws a seeded replacement
    # neighbor (detector="phi" only; the draw is replayable — see
    # bcfl_tpu_torch.dist.gossip.HEDGE_LANE)
    gossip_hedge_phi: float = 2.0
    # receiver-side per-sender dedup window (message ids); ids at or below
    # (newest seen - window) are treated as duplicates and dropped
    dedup_window: int = 1024
    # bounded inbox: a flooding (or chaos-duplicated) peer cannot grow a
    # leader's queue without bound — overflow REFUSES the newest frame
    # (no ack, dedup id un-recorded, counted in transport stats
    # `inbox_overflow`), so the sender's retry can still deliver it once
    # the inbox drains — at-least-once survives a full inbox
    inbox_max: int = 1024
    # partial-report cadence: peers rewrite their report_peer*.json every
    # N local rounds (and on every adopted/produced version, at startup,
    # and on SIGTERM) with status="running" — a SIGKILLed or stalled peer
    # leaves a current partial report instead of nothing. 0 disables the
    # periodic rewrites (startup/terminal writes remain).
    report_every_rounds: int = 5
    # quorum degradation: the FedBuff leader's buffer target counts only
    # component peers the detector does NOT hold DOWN (merges recorded as
    # degraded while any are), and below this reachable fraction of the
    # component the leader refuses to advance the global at all (the idle
    # watchdog bounds that wait)
    quorum_frac: float = 0.5
    # --- comms/compute overlap (RUNTIME.md §4, PERF.md) ---
    # pipeline=True (default) overlaps communication with computation:
    # update sends and global broadcasts go through per-destination sender
    # WORKERS (the round loop enqueues and immediately starts the next
    # local round; retries/backoff/detector feeding run in the worker),
    # and the leader drains arrivals on an INTAKE thread into a
    # double-buffered FedBuff buffer (merge/verify consumes a swapped-out
    # buffer while intake keeps filling the standby one). False = the
    # serial loop: sends and intake inline in the round loop.
    pipeline: bool = True
    # bounded per-destination handoff queue depth for the sender workers:
    # when a destination is slower than the round loop, enqueue BLOCKS
    # after this many frames (back-pressure) instead of buffering
    # model-sized trees without bound
    pipeline_depth: int = 2
    # periodic host-resource sampling (metrics.ResourceMonitor sampling
    # mode): every this-many seconds each peer emits a catalogued
    # `resource` telemetry event (RSS, windowed CPU%) so the live
    # monitor's health series can track drift across a long soak.
    # 0.0 (default) = off; ignored when telemetry is off.
    resource_sample_s: float = 0.0
    # --- dispatch mode (RUNTIME.md "Gossip dispatch") ---
    # "leader" = the FedBuff path above: min reachable id owns the merge,
    # the robust votes, and the reputation clock for its component.
    # "gossip" = leaderless epidemic exchange (bcfl_tpu_torch.dist.gossip): every
    # peer samples seeded neighbors per local round, pushes its full state,
    # and merges arrivals with a commutative version-vector rule — no
    # privileged process, elastic membership (dist.membership).
    dispatch: str = "leader"
    # gossip neighbors contacted per local round (epidemic fan-out, or the
    # ring successor count under gossip_topology="ring")
    gossip_fanout: int = 2
    # neighbor-sampling topology: "epidemic" draws gossip_fanout live peers
    # from a PRNG keyed (seed, round, peer) — replayable; "ring" takes the
    # next gossip_fanout successors around the sorted live view
    gossip_topology: str = "epidemic"
    # HELLO beacon cadence (seconds): each peer periodically hellos one
    # sampled neighbor and any peer answers with a state+chain sync — the
    # steady-state resync that makes join/leave mid-run continuous
    gossip_hello_interval_s: float = 5.0

    def __post_init__(self):
        if self.peers < 2:
            raise ValueError(
                f"runtime='dist' needs >= 2 peers, got {self.peers}")
        if self.buffer < 0 or self.buffer > self.peers:
            raise ValueError(
                f"dist buffer {self.buffer} must be in [0, peers="
                f"{self.peers}] (it counts buffered PEER updates)")
        for name in ("buffer_timeout_s", "idle_timeout_s",
                     "peer_deadline_s", "retry_base_s", "retry_max_s",
                     "send_deadline_s", "probe_interval_s"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be > 0")
        if self.send_retries < 0:
            raise ValueError(
                f"send_retries must be >= 0, got {self.send_retries}")
        if self.suspect_after < 1:
            raise ValueError(
                f"suspect_after must be >= 1, got {self.suspect_after}")
        if self.down_after < self.suspect_after:
            raise ValueError(
                f"down_after {self.down_after} must be >= suspect_after "
                f"{self.suspect_after} (a peer is SUSPECT before DOWN)")
        if self.detector not in ("phi", "fixed"):
            raise ValueError(
                f"dist detector must be 'phi' or 'fixed', got "
                f"{self.detector!r}")
        for name in ("phi_suspect", "phi_window_floor_s",
                     "deadline_floor_s", "min_bandwidth_bps",
                     "gossip_hedge_phi"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be > 0")
        if self.phi_down < self.phi_suspect:
            raise ValueError(
                f"phi_down {self.phi_down} must be >= phi_suspect "
                f"{self.phi_suspect} (a peer is SUSPECT before DOWN)")
        if self.phi_window_ceil_s < self.phi_window_floor_s:
            raise ValueError(
                f"phi_window_ceil_s {self.phi_window_ceil_s} must be >= "
                f"phi_window_floor_s {self.phi_window_floor_s}")
        if self.deadline_ceil_s < self.deadline_floor_s:
            raise ValueError(
                f"deadline_ceil_s {self.deadline_ceil_s} must be >= "
                f"deadline_floor_s {self.deadline_floor_s}")
        for name in ("dedup_window", "inbox_max"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")
        if self.report_every_rounds < 0:
            raise ValueError(
                f"report_every_rounds must be >= 0, got "
                f"{self.report_every_rounds}")
        if self.checkpoint_keep_last < 0:
            raise ValueError(
                f"checkpoint_keep_last must be >= 0 (0 keeps all), got "
                f"{self.checkpoint_keep_last}")
        if not 0.0 < self.quorum_frac <= 1.0:
            raise ValueError(
                f"quorum_frac must be in (0, 1], got {self.quorum_frac}")
        if self.pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {self.pipeline_depth}")
        if self.resource_sample_s < 0:
            raise ValueError(
                f"resource_sample_s must be >= 0, got "
                f"{self.resource_sample_s}")
        if self.dispatch not in ("leader", "gossip"):
            raise ValueError(
                f"dist dispatch must be 'leader' or 'gossip', got "
                f"{self.dispatch!r}")
        if self.gossip_topology not in ("epidemic", "ring"):
            raise ValueError(
                f"gossip_topology must be 'epidemic' or 'ring', got "
                f"{self.gossip_topology!r}")
        if self.gossip_fanout < 1:
            raise ValueError(
                f"gossip_fanout must be >= 1, got {self.gossip_fanout}")
        if self.dispatch == "gossip" and self.gossip_fanout >= self.peers:
            raise ValueError(
                f"gossip_fanout {self.gossip_fanout} must be < peers "
                f"{self.peers} (a peer cannot gossip to more neighbors "
                "than exist besides itself)")
        if self.gossip_hello_interval_s <= 0:
            raise ValueError(
                f"gossip_hello_interval_s must be > 0, got "
                f"{self.gossip_hello_interval_s}")


def _plan(c) -> FaultPlan:
    return c.faults if c.faults is not None else FaultPlan()


# --- runtime capability table (the JAX package's RUNTIME_CAPS) -------------
# Each row is ``(feature, active, {runtime: verdict})``: ``active(cfg)``
# says whether the feature is requested, ``True`` means the runtime
# supports it, and a string is the rejection reason raised at config time,
# JAX's verbatim, on both runtimes.
# JAX's "pod-spanning mesh" and "buffer donation" rows are left out: the
# port's config has no such fields.
RUNTIME_CAPS: Tuple = (
    ("serverless gossip mode",
     lambda c: c.mode == "serverless",
     {"local": True,
      "dist": "the dist runtime's serverless analogue is the leaderless "
              "dispatch, not the local ring-gossip diffusion — use "
              "mode='server' with dist.dispatch='gossip'"}),
    ("simulated-clock sync rounds",
     lambda c: c.sync == "sync",
     {"local": True,
      "dist": "runtime='dist' IS the real-clock async runtime (RUNTIME.md); "
              "set sync='async' — there is no synchronous barrier to run"}),
    ("simulated-clock async (sync='async')",
     lambda c: c.sync == "async",
     {"local": True, "dist": True}),
    ("faithful host-sequential mode",
     lambda c: c.faithful,
     {"local": True,
      "dist": "faithful mode mutates ONE shared model host-sequentially; "
              "peers on different hosts cannot share that model"}),
    ("cohort registry sampling",
     lambda c: c.registry_size > 0,
     {"local": True,
      "dist": "registry sampling re-deals the client set per round; a "
              "peer's client slice is its persistent identity (data, "
              "ledger keys, checkpoints)"}),
    ("tensor parallelism (tp > 1)",
     lambda c: c.tp > 1,
     {"local": True,
      "dist": "each peer builds a single-host client mesh; inner tp "
              "sharding across peers is not implemented"}),
    ("sequence parallelism (sp > 1)",
     lambda c: c.sp > 1,
     {"local": True,
      "dist": "each peer builds a single-host client mesh; inner sp "
              "sharding across peers is not implemented"}),
    ("fused multi-round dispatch",
     lambda c: c.rounds_per_dispatch > 1,
     {"local": True,
      "dist": "every peer round ends at the transport (send/receive is "
              "host work by construction); there is nothing to fuse "
              "across"}),
    ("anomaly filter",
     lambda c: c.topology.anomaly_filter is not None,
     {"local": True,
      "dist": "anomaly filters gate on the SIMULATED latency graph; the "
              "dist runtime measures real transport and has no global "
              "per-round view to filter"}),
    ("reputation lifecycle",
     lambda c: c.reputation.enabled,
     {"local": True, "dist": True}),  # dist: the per-PEER tracker fed by
    # wire evidence (reputation/dist.py); quarantine refusals are post-ack
    # drops and transitions commit to the ledger
    ("robust aggregators",
     lambda c: c.aggregator != "mean",
     {"local": True, "dist": True}),  # dist: the robust rules over the
    # buffered ARRIVAL set (dist/robust.py), with the buffer preconditions
    # checked below (trimmed_mean/median need buffer >= 3, krum
    # buffer >= 2f+3)
    ("communication compression",
     lambda c: c.compression.enabled,
     {"local": True, "dist": True}),
    ("hash-chained ledger",
     lambda c: c.ledger.enabled,
     {"local": True, "dist": True}),
    ("chaos: transport partition",
     lambda c: _plan(c).partitions,
     {"local": True, "dist": True}),  # dist: enforced at the socket, the
    # groups name PEERS; each component forks the ledger chain
    ("chaos: stragglers",
     lambda c: _plan(c).straggler_prob > 0,
     {"local": True, "dist": True}),  # dist: a REAL pre-send sleep
    ("chaos: client dropout",
     lambda c: _plan(c).dropout_prob > 0,
     {"local": True,
      "dist": "per-round dropout is a mask over a global stacked round; "
              "dist peers have no global round to mask — not implemented"}),
    ("chaos: transport corruption / flaky bursts",
     lambda c: _plan(c).corrupts,
     {"local": True,
      "dist": "per-client corruption scales act on the engine's stacked "
              "in-graph transport stage, which dist rounds never run; use "
              "the wire lane instead (wire_corrupt_prob flips real frame "
              "bytes in flight; the frame CRC and the ledger verify path "
              "catch them)"}),
    ("chaos: wire faults (drop/dup/reorder/delay/corrupt)",
     lambda c: _plan(c).wire_enabled,
     {"local": "the local engine has no socket boundary to inject at — "
               "the wire lane acts on real TCP frames in the dist "
               "transport (PeerTransport); use corrupt_prob for the "
               "simulated-transport analogue",
      "dist": True}),  # injected at the socket (dist/transport.py)
    ("chaos: byzantine peers",
     lambda c: _plan(c).byz_enabled,
     {"local": "byzantine behaviors forge the dist update exchange's wire "
               "headers and payloads (stale lineage, digest forgeries, "
               "per-destination equivocation); the local engine exchanges "
               "none of those — use corrupt_prob/flaky_* for the "
               "simulated in-graph analogue",
      "dist": True}),  # injected above the wire (dist/byzantine.py)
    ("chaos: churn",
     lambda c: _plan(c).churns,
     {"local": True,
      "dist": "peer-level churn is the crash/rejoin path (kill and "
              "restart a peer process; scripts/dist_async.py --kill-peer "
              "drives it), not a mask schedule"}),
    ("chaos: host crash",
     lambda c: _plan(c).crash_at_round is not None,
     {"local": True,
      "dist": "kill the peer PROCESS instead (scripts/dist_async.py "
              "--kill-peer): a real crash is the thing itself, not a "
              "simulated one"}),
    ("chaos: storage faults",
     lambda c: _plan(c).storage_enabled,
     {"local": "the storage lane damages a peer's durable checkpoint/"
               "ledger state at the post-commit seam and exercises the "
               "scrub + STATE_SYNC repair path; the local engine has no "
               "per-peer durable state or peers to repair from — dist "
               "only",
      "dist": True}),  # injected after the checkpoint commit; the startup
    # scrub detects it, a chain-verified STATE_SYNC transfer repairs it
    ("chaos: limp faults (gray failures)",
     lambda c: _plan(c).limp_enabled,
     {"local": "the limp lane stalls a PEER's train seam and throttles "
               "its real TCP links, graded by the adaptive failure "
               "detector and w_slow down-weighting — the local engine "
               "has neither a wire nor a detector; use straggler_prob "
               "for the simulated-clock analogue",
      "dist": True}),  # stall at the train seam, direction-keyed
    # throttle in the transport, SIGSTOP pauses through the harness
    ("chaos: resource faults (ENOSPC/EMFILE)",
     lambda c: _plan(c).resource_enabled,
     {"local": "the resource lane fails a peer's durable writes "
               "(checkpoint commit, ledger append, event flush) and "
               "grades the emergency-GC → telemetry-shed → exit ladder; "
               "the local engine has no per-peer durable-write seams — "
               "dist only",
      "dist": True}),  # drawn per (seam, counter, peer) at the durable
    # write seams
    ("communication compression under gossip dispatch",
     lambda c: c.compression.enabled and c.dist.dispatch == "gossip",
     {"local": True,
      "dist": "the codec wire encodes DELTAS against a shared adopted "
              "base version; gossip peers merge concurrently with no "
              "common base to delta against — use compress='none'"}),
    ("krum under gossip dispatch",
     lambda c: c.aggregator == "krum" and c.dist.dispatch == "gossip",
     {"local": True,
      "dist": "krum selects ONE vote from a population; over a gossip "
              "peer's tiny neighbor arrival set the selection guarantee "
              "is vacuous and the merge would just adopt one neighbor "
              "verbatim — use trimmed_mean or median"}),
    ("chaos: transport partition under gossip dispatch",
     lambda c: _plan(c).partitions and c.dist.dispatch == "gossip",
     {"local": True, "dist": True}),  # dist: healed leaderlessly (the
    # gate component bounds the neighbor draws and the merge, HELLO
    # probes and version-vector merges absorb the other side at the heal)
    ("per-round central eval",
     lambda c: c.eval_every != 0,
     {"local": True,
      "dist": "per-round central eval would serialize the async runtime "
              "behind the leader; set eval_every=0 — the leader "
              "evaluates the final global once at shutdown"}),
    ("LoRA adapter exchange",
     lambda c: c.lora_rank > 0 or bool(c.lora_ranks),
     {"local": True, "dist": True}),  # dist: the trainable tree IS the
    # adapter tree, so update and broadcast frames, the leader's
    # refingerprint, the robust merge's votes, the byzantine seam and the
    # HELLO/checkpoint resync all carry adapter-scale payloads; the frozen
    # base never crosses the wire
    ("heterogeneous LoRA ranks",
     lambda c: bool(c.lora_ranks)
     and len(set(parse_lora_ranks(c.lora_ranks))) > 1,
     {"local": True,
      "dist": "each dist peer compiles round programs over its own client "
              "slice; the rank-aware padded aggregation (RBLA) is defined "
              "over the single-process stacked client axis — use a uniform "
              "lora_rank"}),
)


def capability_table(cfg: "FedConfig") -> Tuple[Tuple[str, bool, object], ...]:
    """The resolved ``(feature, active, verdict)`` rows for ``cfg``'s
    runtime: ``verdict`` is True (supported) or the rejection reason."""
    return tuple((feature, bool(active(cfg)), verdicts[cfg.runtime])
                 for feature, active, verdicts in RUNTIME_CAPS)


#: (field, is-unsupported predicate) — each raises "not ported yet"
_NOT_PORTED = (
    ("local_epochs", lambda c: c.local_epochs != 1),
    ("rounds_per_dispatch", lambda c: c.rounds_per_dispatch > 1),
)


@dataclasses.dataclass(frozen=True)
class FedConfig:
    # --- experiment identity ---
    name: str = "fed"
    seed: int = 42

    # --- data ---
    dataset: str = "synthetic"
    text_col: str = "text"
    label_col: str = "labels"
    num_labels: int = 2
    seq_len: int = 128
    batch_size: int = 32
    vocab_size: int = 8192  # hash-tokenizer vocab
    tokenizer: str = "hash"

    # --- task / model ---
    task: str = "classification"
    model: str = "tiny-bert"
    # the model's layer count: 0 = its catalog depth; > 0 builds that many
    # encoder/decoder layers at the model's own width (a depth cut; not
    # with hf_checkpoint, whose depth is the checkpoint's)
    num_layers: int = 0
    hf_checkpoint: Optional[str] = None
    lora_rank: int = 0  # 0 = full fine-tune; > 0 = LoRA adapters
    # per-client LoRA ranks for a heterogeneous fleet ("2,4,8", cycled over
    # the clients; RBLA aggregation). Exclusive with lora_rank, which it
    # canonicalizes to max(spec). "" = uniform
    lora_ranks: str = ""
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # None = the model family's default (encoders: dense attention); True
    # forces flash attention at every length, False dense
    use_flash: Optional[bool] = None
    # recompute each encoder layer's activations in the backward
    remat: bool = False
    # tensor-parallel shards per client: tp > 1 builds a 2-D (clients, tp)
    # mesh and splits the frozen base megatron-style over its inner
    # devices (LoRA only; bcfl_tpu_torch.parallel.tp_linear)
    tp: int = 1
    # sequence-parallel shards per client: sp > 1 builds a 2-D
    # (clients, seq) mesh and rides exact ring attention over its inner
    # devices (bcfl_tpu_torch.parallel.sp)
    sp: int = 1

    # --- federated topology ---
    runtime: str = "local"
    mode: str = "server"
    sync: str = "sync"
    num_clients: int = 4
    num_rounds: int = 2
    # cohort mode: a registry of this many clients (data partition, PRNG
    # streams, fault schedules, reputation and error-feedback residuals
    # keyed by registry id), of which a seeded sampler draws
    # ``sample_clients`` (0 = num_clients) onto the stacked axis each
    # round; 0 = off
    registry_size: int = 0
    sample_clients: int = 0
    # clients stacked per client shard: > 0 pins the mesh to exactly
    # sample_clients / cohort_size client shards (each reserving tp or sp
    # devices) instead of the largest-divisor default; the engine refuses
    # a pin its devices cannot meet. Must divide the sampled cohort size.
    cohort_size: int = 0
    local_epochs: int = 1
    max_local_batches: Optional[int] = None
    rounds_per_dispatch: int = 1
    weighted_agg: bool = True  # example-weighted FedAvg
    # aggregation rule at every point that consumes the whole stacked
    # client view (server FedAvg, the consensus/partition/async collapse,
    # the serverless exact mean):
    #   mean         — the reference's (example-)weighted FedAvg
    #   trimmed_mean — drop the ceil(aggregator_trim * k) highest and lowest
    #                  values per coordinate
    #   median       — coordinate-wise median
    #   krum         — adopt the client with the least summed distance to
    #                  its nearest neighbours (f = ceil(aggregator_trim * k))
    # the robust rules treat weights as a participation mask
    aggregator: str = "mean"
    aggregator_trim: float = 0.2
    # the reference's serverless semantics: clients train one shared model
    # in turn and the snapshots are averaged (serverless mode, sync)
    faithful: bool = False

    # --- optimizer (fresh AdamW lr=5e-5 each round) ---
    learning_rate: float = 5e-5
    optimizer: str = "adamw"  # "adamw" | "sgd"
    max_grad_norm: float = 0.0  # 0 = off; optax's clip_by_global_norm

    # --- async scheduling ---
    async_buffer: int = 0  # aggregate when this many clients arrived (0 = num_clients)
    staleness_decay: float = 0.5  # weight = decay ** staleness
    # server step size along the staleness-weighted mean client delta
    # (FedBuff-style buffered aggregation)
    async_server_lr: float = 1.0

    # --- sub-configs ---
    partition: PartitionConfig = dataclasses.field(
        default_factory=PartitionConfig)
    topology: TopologyConfig = dataclasses.field(
        default_factory=TopologyConfig)
    ledger: LedgerConfig = dataclasses.field(default_factory=LedgerConfig)
    #: fault-injection plan (the local lanes); the default injects
    #: nothing, and None is accepted as no plan
    faults: Optional[FaultPlan] = dataclasses.field(
        default_factory=FaultPlan)
    #: peer-lifecycle reputation (off by default)
    reputation: ReputationConfig = dataclasses.field(
        default_factory=ReputationConfig)
    compression: CompressionConfig = dataclasses.field(
        default_factory=CompressionConfig)
    # multi-process P2P runtime knobs (runtime="dist" only)
    dist: DistConfig = dataclasses.field(default_factory=DistConfig)

    # --- event telemetry (per-process JSONL streams) ---
    #   None  = the dist runtime streams into its run dir, the local
    #           engine emits nothing,
    #   "off" = disabled everywhere,
    #   path  = stream into this directory on both runtimes.
    telemetry_dir: Optional[str] = None
    # deterministic sampling rate in [0, 1] for the high-rate transport
    # events; invariant-grade events are never sampled
    telemetry_sample: float = 1.0

    # --- checkpoint / metrics ---
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0  # rounds; 0 = off
    # evaluate every Nth round (the final round always evaluates); 0 = never
    eval_every: int = 1
    max_eval_batches: Optional[int] = None

    def __post_init__(self):
        if self.num_layers < 0:
            raise ValueError(
                f"num_layers must be >= 0 (0 = the model's own depth), got "
                f"{self.num_layers}")
        if self.num_layers and self.hf_checkpoint:
            raise ValueError(
                "num_layers cuts a catalog model's depth; an hf_checkpoint "
                "brings its own")
        if self.lora_ranks:
            spec = parse_lora_ranks(self.lora_ranks)
            if self.lora_rank > 0:
                raise ValueError(
                    "set lora_ranks OR lora_rank, not both: lora_ranks is "
                    "the per-client spec and canonicalizes lora_rank to "
                    "max(spec)")
            # canonicalized first, so every `lora_rank > 0` switch sees
            # the fleet's max rank
            object.__setattr__(self, "lora_rank", max(spec))
        if self.runtime not in ("local", "dist"):
            raise ValueError(f"unknown runtime: {self.runtime!r}")
        if self.mode not in ("server", "serverless"):
            raise ValueError(f"unknown mode: {self.mode!r}")
        if self.sync not in ("sync", "async"):
            raise ValueError(f"unknown sync: {self.sync!r}")
        # the one capability check (RUNTIME_CAPS): every requested feature
        # is supported on this runtime or rejected here with its reason
        for feature, active, verdict in capability_table(self):
            if active and verdict is not True:
                raise ValueError(
                    f"{feature} is not supported on runtime="
                    f"{self.runtime!r}: {verdict}")
        if self.runtime == "dist":
            self._check_dist_lanes()
        if not 0.0 <= self.telemetry_sample <= 1.0:
            raise ValueError(
                f"telemetry_sample must be in [0, 1], got "
                f"{self.telemetry_sample}")
        if self.task not in ("classification", "causal_lm"):
            raise ValueError(f"unknown task: {self.task!r}")
        if self.aggregator not in ("mean", "trimmed_mean", "median", "krum"):
            raise ValueError(
                "aggregator must be mean/trimmed_mean/median/krum, "
                f"got {self.aggregator!r}")
        for field in ("param_dtype", "compute_dtype"):
            if getattr(self, field) not in ("float32", "bfloat16", "float16"):
                raise ValueError(
                    f"{field} must be float32/bfloat16/float16, "
                    f"got {getattr(self, field)!r}")
        if self.num_clients < 1 or self.num_rounds < 1:
            raise ValueError("num_clients and num_rounds must be >= 1")
        if self.eval_every < 0:
            raise ValueError(f"eval_every must be >= 0, got {self.eval_every}")
        if self.tp < 1 or self.sp < 1:
            raise ValueError(f"tp/sp must be >= 1, got {self.tp}/{self.sp}")
        if self.tp > 1 and self.sp > 1:
            raise ValueError("pick ONE inner mesh axis per run: tp or sp")
        if self.sp > 1 and self.seq_len % self.sp:
            raise ValueError(
                f"seq_len {self.seq_len} must be divisible by sp={self.sp} "
                "(ring attention shards the sequence into sp equal blocks)")
        if self.tp > 1 and self.lora_rank <= 0:
            raise ValueError(
                "tp > 1 tensor-shards the FROZEN base and keeps per-client "
                "LoRA adapters; set lora_rank > 0 (full fine-tune is 1-D "
                "clients-only)")
        if self.async_buffer < 0:
            raise ValueError(
                f"async_buffer must be >= 0, got {self.async_buffer}")
        if self.async_buffer > self.num_clients:
            # an oversized buffer can never fill
            raise ValueError(
                f"async_buffer {self.async_buffer} > num_clients "
                f"{self.num_clients}: the buffer could never fill (use 0 "
                "for 'aggregate when everyone arrived')")
        if not 0.0 <= self.aggregator_trim < 0.5:
            # >= 0.5 would trim every client (2t >= k) / assume a Byzantine
            # majority, which no aggregation rule can survive
            raise ValueError(
                f"aggregator_trim must be in [0, 0.5), got "
                f"{self.aggregator_trim}")
        plan = self.faults if self.faults is not None else FaultPlan()
        self._check_lora_and_cohort(plan)
        if plan.corrupts and self.faithful:
            raise ValueError(
                "FaultPlan corruption (incl. flaky bursts) models transport "
                "of the parallel paths' stacked updates; faithful "
                "(host-sequential) mode has no transport stage — use the "
                "tamper_hook shim there")
        if plan.partitions and self.runtime == "local":
            # partitioned rounds aggregate per component over the stacked
            # split-phase flow; paths with no per-component form raise
            # rather than aggregate across a partition that should exist
            if self.sync == "async":
                raise ValueError(
                    "chaos partition is not implemented for sync='async': "
                    "the buffered FedBuff merge has one global arrival "
                    "queue, and per-component queues would be a different "
                    "algorithm, not a fault model")
            if self.faithful:
                raise ValueError(
                    "chaos partition is not implemented for faithful "
                    "(host-sequential) mode — clients share ONE model, so "
                    "there is nothing to partition")
            if self.mode == "serverless" and self.topology.gossip_steps > 0:
                raise ValueError(
                    "chaos partition with ring-gossip diffusion "
                    "(gossip_steps > 0) would need a per-component ring — "
                    "a mesh reshape the fault model forbids; use "
                    "gossip_steps=0 (exact mean) for partitioned "
                    "serverless runs")
        if self.aggregator != "mean" and self.faithful:
            # the faithful path averages snapshots with a plain weighted
            # sum; running it under a robust-aggregator label would fake
            # Byzantine protection
            raise ValueError(
                f"aggregator={self.aggregator!r} is not implemented for "
                "faithful (host-sequential) mode — it always aggregates "
                "with the reference's plain mean")
        if self.compression.enabled and self.faithful:
            # the faithful path mutates ONE shared model in turn: no
            # per-client update crosses a wire to compress
            raise ValueError(
                f"compress={self.compression.kind!r} is not implemented for "
                "faithful (host-sequential) mode — it exchanges no update "
                "trees to compress")
        for field, unsupported in _NOT_PORTED:
            if unsupported(self):
                value = self
                for part in field.split("."):
                    value = getattr(value, part)
                raise ValueError(
                    f"{field}={value!r} on runtime={self.runtime!r} is not "
                    "ported yet: bcfl_tpu_torch runs server FedAvg, "
                    "serverless ring gossip and buffered async with the "
                    "anomaly filter, the ledger, the local fault plan, "
                    "robust aggregation, reputation, checkpoints, LoRA and "
                    "cohort sampling, and the multi-process runtime's "
                    "leadered and gossip dispatch (LoRA adapters and Llama "
                    "included) with partitions, the ledger fork and heal, "
                    "peer checkpoints, crash/rejoin, the storage lane and "
                    "state sync, the robust merge, per-peer reputation and "
                    "the byzantine, wire, limp and resource lanes (see "
                    "ROADMAP.md for the port's queue)")

    def _check_dist_lanes(self) -> None:
        """JAX's dist-only checks: the client split, the fault plan's peer
        ids, the storage lane's preconditions and the robust rules'
        buffer preconditions."""
        plan = _plan(self)
        if self.num_clients % self.dist.peers:
            raise ValueError(
                f"num_clients {self.num_clients} must split evenly "
                f"over {self.dist.peers} peers (each peer owns a "
                "fixed client slice)")
        if plan.partitions and plan.partition_groups:
            bad = [i for g in plan.partition_groups for i in g
                   if i >= self.dist.peers]
            if bad:
                raise ValueError(
                    f"dist partition_groups name PEERS; ids {bad} are "
                    f">= peers={self.dist.peers}")
        if plan.partitions and plan.partition_count > self.dist.peers:
            raise ValueError(
                f"dist partition_count {plan.partition_count} "
                f"> peers {self.dist.peers}")
        if plan.byz_enabled:
            bad = [p for p in plan.byz_peers if p >= self.dist.peers]
            if bad:
                raise ValueError(
                    f"byz_peers name PEERS; ids {bad} are >= peers="
                    f"{self.dist.peers}")
            if len(plan.byz_peers) >= self.dist.peers:
                raise ValueError(
                    "byz_peers lists EVERY peer: an all-adversarial "
                    "federation has no honest majority for any rule "
                    "to defend — leave at least one peer honest")
        if plan.storage_enabled:
            self._check_storage_lane(plan)
        if plan.limp_enabled and plan.limp_peers:
            bad = [p for p in plan.limp_peers if p >= self.dist.peers]
            if bad:
                raise ValueError(
                    f"limp_peers name PEERS; ids {bad} are >= peers="
                    f"{self.dist.peers}")
        if plan.resource_enabled and plan.resource_peers:
            bad = [p for p in plan.resource_peers if p >= self.dist.peers]
            if bad:
                raise ValueError(
                    f"resource_peers name PEERS; ids {bad} are >= "
                    f"peers={self.dist.peers}")
        if self.aggregator != "mean":
            self._check_robust_buffer()

    def _check_robust_buffer(self) -> None:
        """The robust rules' declared preconditions on the merge buffer
        (the arrival set is the rule's population), from the same source
        as the runtime's ``robust_degraded`` threshold."""
        from bcfl_tpu_torch.dist.robust import MIN_ORDER_VOTES, krum_min_buffer

        if self.dist.dispatch == "gossip":
            # gossip has no leader buffer: the rule's population is a
            # peer's arrival set, at most its neighbors plus itself (krum
            # is refused by the caps table)
            if self.dist.gossip_fanout + 1 < MIN_ORDER_VOTES:
                raise ValueError(
                    f"aggregator={self.aggregator!r} under "
                    f"dispatch='gossip' needs gossip_fanout >= "
                    f"{MIN_ORDER_VOTES - 1} (got "
                    f"{self.dist.gossip_fanout}): the rule's "
                    "population is a peer's neighbor arrival set "
                    "plus itself, and an order statistic over < "
                    f"{MIN_ORDER_VOTES} votes excludes nothing")
        eff = self.dist.buffer or 1
        if (self.aggregator in ("trimmed_mean", "median")
                and self.dist.dispatch != "gossip"):
            if eff < MIN_ORDER_VOTES:
                raise ValueError(
                    f"aggregator={self.aggregator!r} on "
                    f"runtime='dist' needs dist.buffer >= "
                    f"{MIN_ORDER_VOTES} (got {eff}): the rule's "
                    "population is the buffered arrival set, and "
                    f"an order statistic over < {MIN_ORDER_VOTES} "
                    "votes excludes nothing")
        if self.aggregator == "krum":
            need = krum_min_buffer(eff, self.aggregator_trim)
            if eff < need:
                raise ValueError(
                    f"aggregator='krum' on runtime='dist' needs "
                    f"dist.buffer >= 2f+3 = {need} for f = "
                    f"ceil(aggregator_trim * buffer) "
                    f"(got buffer {eff}): below that the "
                    "classical selection guarantee is vacuous")

    def _check_storage_lane(self, plan: FaultPlan) -> None:
        if plan.storage_peers:
            bad = [p for p in plan.storage_peers if p >= self.dist.peers]
            if bad:
                raise ValueError(
                    f"storage_peers name PEERS; ids {bad} are >= "
                    f"peers={self.dist.peers}")
        for srv, req in (plan.sync_tamper or ()):
            if srv >= self.dist.peers or req >= self.dist.peers:
                raise ValueError(
                    f"sync_tamper pair ({srv}, {req}) names PEERS; "
                    f"ids must be < peers={self.dist.peers}")
        if not self.dist.checkpoint_every_versions:
            raise ValueError(
                "the storage fault lane injects at the checkpoint "
                "commit seam; checkpoint_every_versions=0 never "
                "writes one, so the lane would silently never "
                "fire — enable checkpointing or drop the lane")
        if not self.ledger.enabled:
            raise ValueError(
                "the storage lane's repair path authenticates "
                "STATE_SYNC transfers against the hash chain "
                "(commitment rows + verify_segment); without "
                "ledger.enabled there is no root of trust to "
                "verify a transfer against — enable the ledger "
                "or drop the lane")

    def _check_lora_and_cohort(self, plan: FaultPlan) -> None:
        """The JAX package's rejections of heterogeneous ranks and of cohort
        mode, with its reasons."""
        if self.lora_ranks and len(set(parse_lora_ranks(self.lora_ranks))) > 1:
            if self.aggregator != "mean":
                raise ValueError(
                    f"aggregator={self.aggregator!r} does not compose with "
                    "heterogeneous lora_ranks: order statistics have no "
                    "sound definition over structural zero padding (a "
                    "low-rank client's padded coordinate would vote an "
                    "exact 0 into every trim/median/krum decision) — use "
                    "aggregator='mean' (the rank-aware RBLA rule)")
            if self.mode != "server":
                raise ValueError(
                    "heterogeneous lora_ranks require mode='server': ring "
                    "gossip mixes whole neighbor trees, and the rank-aware "
                    "padded aggregation (RBLA) has no per-edge ring form")
            if self.faithful:
                raise ValueError(
                    "heterogeneous lora_ranks are not implemented for "
                    "faithful (host-sequential) mode — it averages host-"
                    "side with the reference's plain mean, which would "
                    "dilute low-rank clients' padded coordinates")
            if self.registry_size > 0:
                raise ValueError(
                    "heterogeneous lora_ranks do not compose with registry "
                    "sampling: ranks are cycled over the FIXED stacked "
                    "client slots, while sampling re-deals which registry "
                    "client sits in each slot every round — a client's "
                    "rank would change under it")
        for field in ("registry_size", "sample_clients", "cohort_size"):
            if getattr(self, field) < 0:
                raise ValueError(
                    f"{field} must be >= 0, got {getattr(self, field)}")
        if self.registry_size == 0 and (self.sample_clients
                                        or self.cohort_size):
            raise ValueError(
                "sample_clients/cohort_size have no effect without "
                "registry_size > 0 (they shape the sampled cohort of a "
                "client registry) — the same fail-loudly stance as the "
                "codec sub-flags")
        if self.registry_size == 0:
            return
        active = self.sample_clients or self.num_clients
        if active > self.registry_size:
            raise ValueError(
                f"sampled cohort {active} > registry_size "
                f"{self.registry_size}: cannot draw without replacement")
        if self.cohort_size and active % self.cohort_size:
            raise ValueError(
                f"cohort_size {self.cohort_size} must divide the sampled "
                f"cohort size {active} (it is the per-device stack of the "
                "cohort mesh)")
        if self.mode != "server":
            raise ValueError(
                "registry sampling requires mode='server': serverless "
                "peers carry persistent per-client params, which a "
                "registry >> cohort cannot keep resident (the stacked "
                "tree IS the peer state)")
        if self.sync != "sync":
            raise ValueError(
                "registry sampling is not implemented for sync='async': "
                "the simulated network clock tracks per-client "
                "completion/staleness for a FIXED client set, and a "
                "per-round cohort would redefine that state each round")
        if self.faithful:
            raise ValueError(
                "registry sampling is not implemented for faithful "
                "(host-sequential) mode")
        if plan.partitions:
            raise ValueError(
                "chaos partition does not compose with registry "
                "sampling: components are defined over the full client "
                "set, and a per-round cohort would dissolve them")

    @property
    def lora_rank_spec(self) -> Optional[Tuple[int, ...]]:
        """Parsed ``lora_ranks`` tuple, or None when unset (uniform rank)."""
        return parse_lora_ranks(self.lora_ranks) if self.lora_ranks else None

    @property
    def client_lora_ranks(self) -> Optional[Tuple[int, ...]]:
        """Per-client rank assignment: the spec cycled over the stacked
        client axis (length ``num_clients``), or None when uniform."""
        spec = self.lora_rank_spec
        if spec is None:
            return None
        return tuple(spec[i % len(spec)] for i in range(self.num_clients))

    def replace(self, **kw) -> "FedConfig":
        if self.lora_ranks and "lora_rank" not in kw:
            # lora_rank holds max(spec) after canonicalization; passing it
            # back with the spec would read as both being set
            kw["lora_rank"] = 0
        return dataclasses.replace(self, **kw)
