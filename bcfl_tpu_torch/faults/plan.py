"""Config-driven fault injection: port of ``bcfl_tpu/faults/plan.py``, the
local engine's lanes.

:class:`FaultPlan` is one seeded, deterministic, config-level schedule of
the failures the local engine is stressed with:

- **dropout**: per-round Bernoulli client dropout, composed into the
  participation mask like an anomaly-filter exclusion (dropped clients
  carry weight 0);
- **stragglers**: per-round simulated-clock delays, fed into
  :meth:`bcfl_tpu_torch.topology.graph.LatencyGraph.info_passing_time` and
  added to the async engine's per-client completion clock;
- **corruption**: in-flight update corruption, per-round per-client
  additive scales applied to the *transported* copy of each update. With
  the ledger on, commit fingerprints are taken before transport and
  verification after, so corrupted clients fail authentication; without
  it, the robust aggregators (``FedConfig.aggregator``) are the defense.
  With a codec on, the transported quantity is the compressed payload and
  the scales perturb its float parts;
- **crash**: the engine raises :class:`SimulatedCrash` at the start of a
  chosen round; ``run(resume=True)`` must reproduce the uninterrupted run
  bit for bit;
- **partition**: the clients split into isolated connected components for
  a span of rounds (``partition_groups`` or a seeded ``partition_count``
  split); each component aggregates on its own, and the components
  reconcile through the configured aggregator on heal;
- **churn**: permanent leave (``churn_leave``) and late join
  (``churn_join``) as per-round alive masks;
- **flaky**: per-client intermittent corruption bursts over
  ``flaky_burst_len``-round windows, the repeat-offender input of
  reputation quarantine.

Every draw comes from ``np.random.default_rng((seed, lane, round))`` with
the JAX package's lane numbers, so the schedules are the JAX package's bit
for bit. The JAX plan's lanes for its multi-process runtime draw here too,
over numpy generators keyed as JAX keys them:

- **wire** (:meth:`FaultPlan.wire_actions`): per transmission attempt,
  drop / duplicate / reorder-hold / delay-jitter / byte-corruption,
  injected at the socket by :class:`bcfl_tpu_torch.dist.transport.WireChaos`;
- **byzantine** (:meth:`FaultPlan.byz_action`, :meth:`FaultPlan.byz_rng`),
  consumed by :class:`bcfl_tpu_torch.dist.byzantine.ByzantineAdversary`;
- **storage** (:meth:`FaultPlan.storage_action`,
  :meth:`FaultPlan.sync_tamper_action`), damage at rest after a commit;
- **limp** (:meth:`FaultPlan.limp_action`, :meth:`FaultPlan.limp_throttle`):
  peers slow but alive, a stall at the train seam and a direction-keyed
  link throttle (:class:`bcfl_tpu_torch.dist.transport.LimpChaos`);
- **resource** (:meth:`FaultPlan.resource_action`): ENOSPC/EMFILE at a
  durable-write seam (:data:`RESOURCE_SEAMS`), answered by the runtime's
  GC -> shed -> exit ladder.

The local engine refuses the dist-only lanes with JAX's reasons.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np


class SimulatedCrash(RuntimeError):
    """Raised by the engine when a :class:`FaultPlan` schedules a host
    crash; ``round`` is where the run died."""

    def __init__(self, round_idx: int):
        super().__init__(
            f"FaultPlan injected a host crash at round {round_idx}")
        self.round = round_idx


# fault lanes (the JAX package's numbers): each fault class draws from its
# own stream, so enabling one never perturbs another's schedule
_LANE_DROPOUT = 1
_LANE_STRAGGLER = 2
_LANE_CORRUPT = 3
_LANE_PARTITION = 4
_LANE_FLAKY = 5
_LANE_WIRE = 6
_LANE_BYZ = 7
_LANE_STORAGE = 8
_LANE_LIMP = 9
_LANE_RESOURCE = 10

# the dist-only lanes' vocabularies (JAX's canonical orders)
BYZ_BEHAVIORS = ("scale", "sign_flip", "garbage", "replay", "digest_forge",
                 "equivocate")
STORAGE_CLASSES = ("torn", "payload_flip", "meta_flip", "truncate",
                   "delete", "ledger", "rollback")
RESOURCE_CLASSES = ("enospc", "emfile")
# the durable-write seams the dist runtime consults the resource lane at,
# in canonical index order (the index keys the draw)
RESOURCE_SEAMS = ("checkpoint", "ledger", "events")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Deterministic per-round fault schedule. The all-defaults plan
    injects nothing (``enabled`` is False).

    ``*_rounds`` fields restrict a fault class to a round tuple (None =
    every round); probabilities are per-client Bernoulli draws from the
    seeded stream."""

    seed: int = 0
    # client dropout: each client independently sits the round out
    dropout_prob: float = 0.0
    dropout_rounds: Optional[Tuple[int, ...]] = None
    # stragglers: affected clients finish `straggler_delay_s` late
    straggler_prob: float = 0.0
    straggler_delay_s: float = 30.0
    straggler_rounds: Optional[Tuple[int, ...]] = None
    # transport corruption: affected clients' shipped updates arrive with
    # `corrupt_scale` added to every float element
    corrupt_prob: float = 0.0
    corrupt_scale: float = 1e6
    corrupt_rounds: Optional[Tuple[int, ...]] = None
    # host crash at the START of this round; a run that restored a
    # checkpoint does not re-fire it (one host failure)
    crash_at_round: Optional[int] = None
    # network partition during `partition_rounds`: explicit groups (every
    # unlisted client forms one extra component) or a seeded
    # `partition_count`-way split, constant for the whole plan
    partition_rounds: Optional[Tuple[int, ...]] = None
    partition_groups: Optional[Tuple[Tuple[int, ...], ...]] = None
    partition_count: int = 0
    # churn: ((client, round), ...); a leaver is gone from its round on, a
    # late joiner absent before its round
    churn_leave: Optional[Tuple[Tuple[int, int], ...]] = None
    churn_join: Optional[Tuple[Tuple[int, int], ...]] = None
    # flaky peers: `flaky_clients` plus a seeded `flaky_frac` draw corrupt
    # transport with `flaky_scale` for whole `flaky_burst_len`-round
    # windows, each window bad with `flaky_on_prob`
    flaky_clients: Optional[Tuple[int, ...]] = None
    flaky_frac: float = 0.0
    flaky_burst_len: int = 3
    flaky_on_prob: float = 0.5
    flaky_scale: float = 1e6
    # --- the JAX plan's dist-only lanes. Wire: per-attempt drop / dup /
    # reorder-hold (`wire_reorder_hold_s` at the receiver) / delay jitter
    # (uniform [0, wire_delay_s)) / byte corruption, `wire_rounds` bounding
    # the sender's wire clock. Byzantine: `byz_peers` act per (peer, round)
    # with probability `byz_prob`, drawing one of `byz_behaviors`;
    # `byz_scale` is the scale/garbage magnitude, `byz_rounds` bounds the
    # lane to a span of the adversary's local-round clock. Storage: damage
    # at rest per (peer, version). Limp: `limp_peers` stall their train
    # seam `limp_stall_s` and, with `limp_throttle_bps` > 0, pace their
    # links per direction (`limp_oneway`: outbound only). Resource:
    # ENOSPC/EMFILE per (seam, write counter, peer) ---
    wire_drop_prob: float = 0.0
    wire_dup_prob: float = 0.0
    wire_reorder_prob: float = 0.0
    wire_reorder_hold_s: float = 0.25
    wire_delay_prob: float = 0.0
    wire_delay_s: float = 0.2
    wire_corrupt_prob: float = 0.0
    wire_rounds: Optional[Tuple[int, ...]] = None
    byz_peers: Optional[Tuple[int, ...]] = None
    byz_behaviors: Tuple[str, ...] = BYZ_BEHAVIORS
    byz_prob: float = 1.0
    byz_scale: float = 25.0
    byz_rounds: Optional[Tuple[int, ...]] = None
    storage_peers: Optional[Tuple[int, ...]] = None
    storage_prob: float = 0.0
    storage_classes: Tuple[str, ...] = STORAGE_CLASSES
    storage_delete_last: int = 1
    storage_rounds: Optional[Tuple[int, ...]] = None
    sync_tamper: Optional[Tuple[Tuple[int, int], ...]] = None
    limp_peers: Optional[Tuple[int, ...]] = None
    limp_prob: float = 0.0
    limp_stall_s: float = 2.0
    limp_throttle_bps: float = 0.0
    limp_oneway: bool = False
    limp_rounds: Optional[Tuple[int, ...]] = None
    resource_peers: Optional[Tuple[int, ...]] = None
    resource_prob: float = 0.0
    resource_classes: Tuple[str, ...] = RESOURCE_CLASSES
    resource_rounds: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        for name in ("dropout_prob", "straggler_prob", "corrupt_prob",
                     "wire_drop_prob", "wire_dup_prob", "wire_reorder_prob",
                     "wire_delay_prob", "wire_corrupt_prob", "byz_prob",
                     "storage_prob", "limp_prob", "resource_prob"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        if self.straggler_delay_s < 0:
            raise ValueError(
                f"straggler_delay_s must be >= 0, got {self.straggler_delay_s}")
        if not np.isfinite(self.corrupt_scale):
            raise ValueError("corrupt_scale must be finite (NaN/Inf would "
                             "poison the fingerprint comparison itself)")
        for name in ("dropout_rounds", "straggler_rounds", "corrupt_rounds"):
            r = getattr(self, name)
            if r is not None and not isinstance(r, tuple):
                raise ValueError(
                    f"{name} must be a tuple of round indices (hashable — "
                    f"the plan lives inside the frozen FedConfig), got "
                    f"{type(r).__name__}")
        if self.crash_at_round is not None and self.crash_at_round < 0:
            raise ValueError(
                f"crash_at_round must be >= 0, got {self.crash_at_round}")
        self._check_partition()
        self._check_churn()
        self._check_flaky()
        self._check_wire()
        self._check_byz()
        self._check_storage()
        self._check_limp()
        self._check_resource()

    def _check_partition(self):
        if self.partition_groups is not None:
            if not (isinstance(self.partition_groups, tuple) and all(
                    isinstance(g, tuple) for g in self.partition_groups)):
                raise ValueError(
                    "partition_groups must be a tuple of client-index "
                    "tuples (hashable — the plan lives inside the frozen "
                    "FedConfig)")
            if not self.partition_groups:
                raise ValueError("partition_groups must name at least one "
                                 "component (unlisted clients form one "
                                 "extra component; the effective count is "
                                 "validated against the client count by "
                                 "FaultInjector)")
            flat = [c for g in self.partition_groups for c in g]
            if len(flat) != len(set(flat)) or any(c < 0 for c in flat):
                raise ValueError(
                    "partition_groups must be disjoint non-negative client "
                    f"indices, got {self.partition_groups}")
        if self.partition_count < 0 or self.partition_count == 1:
            raise ValueError(
                f"partition_count must be 0 (off) or >= 2, got "
                f"{self.partition_count}")
        if self.partition_groups is not None and self.partition_count:
            raise ValueError("give partition_groups OR partition_count, "
                             "not both")
        if self.partitions and self.partition_rounds is None:
            raise ValueError(
                "a partition plan needs partition_rounds (the span of "
                "rounds the mesh stays split)")
        if self.partition_rounds is not None:
            if not isinstance(self.partition_rounds, tuple):
                raise ValueError("partition_rounds must be a tuple of round "
                                 "indices")
            if not self.partition_rounds:
                raise ValueError(
                    "partition_rounds is empty: the partition would "
                    "silently never fire (check the span bounds)")
            if not self.partitions:
                raise ValueError(
                    "partition_rounds without partition_groups or "
                    "partition_count would silently never partition")

    def _check_churn(self):
        for name in ("churn_leave", "churn_join"):
            sched = getattr(self, name)
            if sched is None:
                continue
            if not (isinstance(sched, tuple)
                    and all(isinstance(e, tuple) and len(e) == 2
                            and e[0] >= 0 and e[1] >= 0 for e in sched)):
                raise ValueError(
                    f"{name} must be a tuple of (client, round) pairs of "
                    f"non-negative ints, got {sched!r}")
            if len({c for c, _ in sched}) != len(sched):
                raise ValueError(f"{name} lists a client twice: {sched!r}")
        if self.churn_leave and self.churn_join:
            j = dict((c, r) for c, r in self.churn_join)
            for c, r in self.churn_leave:
                if c in j and j[c] >= r:
                    raise ValueError(
                        f"client {c} would join at round {j[c]} after "
                        f"leaving at round {r}; churn is permanent")

    def _check_flaky(self):
        if self.flaky_clients is not None and not isinstance(
                self.flaky_clients, tuple):
            raise ValueError("flaky_clients must be a tuple of client "
                             "indices")
        if not 0.0 <= self.flaky_frac <= 1.0:
            raise ValueError(
                f"flaky_frac must be in [0, 1], got {self.flaky_frac}")
        if not 0.0 <= self.flaky_on_prob <= 1.0:
            raise ValueError(
                f"flaky_on_prob must be in [0, 1], got {self.flaky_on_prob}")
        if self.flaky_burst_len < 1:
            raise ValueError(
                f"flaky_burst_len must be >= 1, got {self.flaky_burst_len}")
        if not np.isfinite(self.flaky_scale):
            raise ValueError("flaky_scale must be finite (same fingerprint-"
                             "poisoning concern as corrupt_scale)")

    def _check_wire(self):
        for name in ("wire_reorder_hold_s", "wire_delay_s"):
            v = getattr(self, name)
            if v < 0 or not np.isfinite(v):
                raise ValueError(f"{name} must be finite and >= 0, got {v}")
        if self.wire_rounds is not None:
            if not isinstance(self.wire_rounds, tuple):
                raise ValueError("wire_rounds must be a tuple of round "
                                 "indices (hashable — the plan lives inside "
                                 "the frozen FedConfig)")
            if not self.wire_rounds:
                raise ValueError(
                    "wire_rounds is empty: the wire lane would silently "
                    "never fire (check the span bounds)")
            if not self.wire_enabled:
                raise ValueError(
                    "wire_rounds without any wire_*_prob > 0 would "
                    "silently never inject a wire fault")

    def _check_byz(self):
        if self.byz_peers is not None:
            if not (isinstance(self.byz_peers, tuple)
                    and all(isinstance(p, int) and p >= 0
                            for p in self.byz_peers)):
                raise ValueError(
                    "byz_peers must be a tuple of non-negative peer ids "
                    "(hashable — the plan lives inside the frozen "
                    "FedConfig)")
            if len(set(self.byz_peers)) != len(self.byz_peers):
                raise ValueError(
                    f"byz_peers lists a peer twice: {self.byz_peers!r}")
        if not (isinstance(self.byz_behaviors, tuple) and self.byz_behaviors):
            raise ValueError("byz_behaviors must be a non-empty tuple")
        bad = [b for b in self.byz_behaviors if b not in BYZ_BEHAVIORS]
        if bad:
            raise ValueError(
                f"unknown byzantine behaviors {bad}; known: "
                f"{BYZ_BEHAVIORS}")
        if not np.isfinite(self.byz_scale):
            raise ValueError("byz_scale must be finite (NaN/Inf would "
                             "poison the very aggregates the robust merge "
                             "is graded on tolerating)")
        if self.byz_rounds is not None:
            if not isinstance(self.byz_rounds, tuple):
                raise ValueError("byz_rounds must be a tuple of round "
                                 "indices (hashable — the plan lives "
                                 "inside the frozen FedConfig)")
            if not self.byz_rounds:
                raise ValueError(
                    "byz_rounds is empty: the byzantine lane would "
                    "silently never fire (check the span bounds)")
            if not self.byz_enabled:
                raise ValueError(
                    "byz_rounds without byz_peers would silently never "
                    "inject an adversarial behavior")
        if self.byz_peers is not None and self.byz_prob <= 0.0:
            raise ValueError(
                "byz_peers with byz_prob=0 would silently never act — "
                "the exact vacuous-pass this lane must not have")

    def _check_storage(self):
        if self.storage_peers is not None:
            if not (isinstance(self.storage_peers, tuple)
                    and all(isinstance(p, int) and p >= 0
                            for p in self.storage_peers)):
                raise ValueError(
                    "storage_peers must be a tuple of non-negative peer ids "
                    "(hashable — the plan lives inside the frozen "
                    "FedConfig)")
            if len(set(self.storage_peers)) != len(self.storage_peers):
                raise ValueError(
                    f"storage_peers lists a peer twice: {self.storage_peers!r}")
            if self.storage_prob <= 0.0:
                raise ValueError(
                    "storage_peers with storage_prob=0 would silently never "
                    "damage anything — the exact vacuous-pass this lane "
                    "must not have")
        if not (isinstance(self.storage_classes, tuple)
                and self.storage_classes):
            raise ValueError("storage_classes must be a non-empty tuple")
        bad = [c for c in self.storage_classes if c not in STORAGE_CLASSES]
        if bad:
            raise ValueError(
                f"unknown storage damage classes {bad}; known: "
                f"{STORAGE_CLASSES}")
        if self.storage_delete_last < 1:
            raise ValueError(
                f"storage_delete_last must be >= 1, got "
                f"{self.storage_delete_last}")
        if self.storage_rounds is not None:
            if not isinstance(self.storage_rounds, tuple):
                raise ValueError("storage_rounds must be a tuple of version "
                                 "indices (hashable — the plan lives inside "
                                 "the frozen FedConfig)")
            if not self.storage_rounds:
                raise ValueError(
                    "storage_rounds is empty: the storage lane would "
                    "silently never fire (check the span bounds)")
            if self.storage_prob <= 0.0:
                raise ValueError(
                    "storage_rounds without storage_prob > 0 would "
                    "silently never damage a checkpoint")
        if self.sync_tamper is not None:
            if not (isinstance(self.sync_tamper, tuple)
                    and all(isinstance(e, tuple) and len(e) == 2
                            and isinstance(e[0], int) and isinstance(e[1], int)
                            and e[0] >= 0 and e[1] >= 0 and e[0] != e[1]
                            for e in self.sync_tamper)):
                raise ValueError(
                    "sync_tamper must be a tuple of distinct-id (server, "
                    f"requester) peer pairs, got {self.sync_tamper!r}")
            if len(set(self.sync_tamper)) != len(self.sync_tamper):
                raise ValueError(
                    f"sync_tamper lists a pair twice: {self.sync_tamper!r}")

    def _check_limp(self):
        if self.limp_peers is not None:
            if not (isinstance(self.limp_peers, tuple)
                    and all(isinstance(p, int) and p >= 0
                            for p in self.limp_peers)):
                raise ValueError(
                    "limp_peers must be a tuple of non-negative peer ids "
                    "(hashable — the plan lives inside the frozen "
                    "FedConfig)")
            if len(set(self.limp_peers)) != len(self.limp_peers):
                raise ValueError(
                    f"limp_peers lists a peer twice: {self.limp_peers!r}")
            if self.limp_prob <= 0.0:
                raise ValueError(
                    "limp_peers with limp_prob=0 would silently never limp "
                    "— the exact vacuous-pass this lane must not have")
        for name in ("limp_stall_s", "limp_throttle_bps"):
            v = getattr(self, name)
            if v < 0 or not np.isfinite(v):
                raise ValueError(f"{name} must be finite and >= 0, got {v}")
        if (self.limp_prob > 0 and self.limp_stall_s <= 0
                and self.limp_throttle_bps <= 0):
            raise ValueError(
                "limp_prob > 0 with limp_stall_s=0 and limp_throttle_bps=0 "
                "injects nothing — the exact silent no-op this lane must "
                "not have")
        if self.limp_rounds is not None:
            if not isinstance(self.limp_rounds, tuple):
                raise ValueError("limp_rounds must be a tuple of round "
                                 "indices (hashable — the plan lives inside "
                                 "the frozen FedConfig)")
            if not self.limp_rounds:
                raise ValueError(
                    "limp_rounds is empty: the limp lane would silently "
                    "never fire (check the span bounds)")
            if self.limp_prob <= 0.0:
                raise ValueError(
                    "limp_rounds without limp_prob > 0 would silently "
                    "never limp a peer")

    def _check_resource(self):
        if self.resource_peers is not None:
            if not (isinstance(self.resource_peers, tuple)
                    and all(isinstance(p, int) and p >= 0
                            for p in self.resource_peers)):
                raise ValueError(
                    "resource_peers must be a tuple of non-negative peer "
                    "ids (hashable — the plan lives inside the frozen "
                    "FedConfig)")
            if len(set(self.resource_peers)) != len(self.resource_peers):
                raise ValueError(
                    f"resource_peers lists a peer twice: "
                    f"{self.resource_peers!r}")
            if self.resource_prob <= 0.0:
                raise ValueError(
                    "resource_peers with resource_prob=0 would silently "
                    "never fail a write — the exact vacuous-pass this lane "
                    "must not have")
        if not (isinstance(self.resource_classes, tuple)
                and self.resource_classes):
            raise ValueError("resource_classes must be a non-empty tuple")
        bad = [c for c in self.resource_classes if c not in RESOURCE_CLASSES]
        if bad:
            raise ValueError(
                f"unknown resource failure classes {bad}; known: "
                f"{RESOURCE_CLASSES}")
        if self.resource_rounds is not None:
            if not isinstance(self.resource_rounds, tuple):
                raise ValueError("resource_rounds must be a tuple of write-"
                                 "counter indices (hashable — the plan "
                                 "lives inside the frozen FedConfig)")
            if not self.resource_rounds:
                raise ValueError(
                    "resource_rounds is empty: the resource lane would "
                    "silently never fire (check the span bounds)")
            if self.resource_prob <= 0.0:
                raise ValueError(
                    "resource_rounds without resource_prob > 0 would "
                    "silently never fail a durable write")

    # ------------------------------------------------------------------ query

    @property
    def enabled(self) -> bool:
        return (self.dropout_prob > 0 or self.straggler_prob > 0
                or self.corrupt_prob > 0 or self.crash_at_round is not None
                or self.partitions or self.churns or self.flaky_enabled
                or self.wire_enabled or self.byz_enabled
                or self.storage_enabled or self.limp_enabled
                or self.resource_enabled)

    @property
    def partitions(self) -> bool:
        return (self.partition_groups is not None
                or self.partition_count >= 2)

    @property
    def churns(self) -> bool:
        return bool(self.churn_leave) or bool(self.churn_join)

    @property
    def flaky_enabled(self) -> bool:
        return bool(self.flaky_clients) or self.flaky_frac > 0

    @property
    def wire_enabled(self) -> bool:
        return (self.wire_drop_prob > 0 or self.wire_dup_prob > 0
                or self.wire_reorder_prob > 0 or self.wire_delay_prob > 0
                or self.wire_corrupt_prob > 0)

    @property
    def byz_enabled(self) -> bool:
        return bool(self.byz_peers)

    @property
    def storage_enabled(self) -> bool:
        return self.storage_prob > 0 or bool(self.sync_tamper)

    @property
    def limp_enabled(self) -> bool:
        return self.limp_prob > 0

    @property
    def resource_enabled(self) -> bool:
        return self.resource_prob > 0

    @property
    def corrupts(self) -> bool:
        # flaky IS transport corruption (burst-scheduled)
        return self.corrupt_prob > 0 or self.flaky_enabled

    def _rng(self, lane: int, rnd: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, lane, rnd))

    def _due(self, rounds: Optional[Tuple[int, ...]], rnd: int) -> bool:
        return rounds is None or rnd in rounds

    # ------------------------------------------------------------- per-round

    def dropout_keep(self, rnd: int, num_clients: int) -> Optional[np.ndarray]:
        """[C] float 0/1 keep-mask (0 = the client sits the round out), or
        None when dropout is not scheduled for ``rnd``."""
        if self.dropout_prob <= 0 or not self._due(self.dropout_rounds, rnd):
            return None
        draw = self._rng(_LANE_DROPOUT, rnd).random(num_clients)
        return (draw >= self.dropout_prob).astype(np.float32)

    def straggler_delays(self, rnd: int,
                         num_clients: int) -> Optional[np.ndarray]:
        """[C] float seconds of extra completion delay, or None when no
        client straggles in ``rnd``."""
        if self.straggler_prob <= 0 or not self._due(self.straggler_rounds,
                                                     rnd):
            return None
        draw = self._rng(_LANE_STRAGGLER, rnd).random(num_clients)
        delays = np.where(draw < self.straggler_prob,
                          self.straggler_delay_s, 0.0)
        return delays.astype(np.float64) if delays.any() else None

    def transport_scales(self, rnd: int,
                         num_clients: int) -> Optional[np.ndarray]:
        """[C] float32 additive transport-corruption scales (0 = clean), or
        None when no corruption is scheduled for ``rnd``."""
        if self.corrupt_prob <= 0 or not self._due(self.corrupt_rounds, rnd):
            return None
        draw = self._rng(_LANE_CORRUPT, rnd).random(num_clients)
        row = np.where(draw < self.corrupt_prob, self.corrupt_scale, 0.0)
        return row.astype(np.float32) if row.any() else None

    def should_crash(self, rnd: int) -> bool:
        return self.crash_at_round is not None and rnd == self.crash_at_round

    def partition_components(
            self, rnd: int,
            num_clients: int) -> Optional[Tuple[Tuple[int, ...], ...]]:
        """The round's connected components as client-index tuples, or None
        when the clients are whole this round. The assignment is constant
        for the whole plan, so a multi-round span keeps stable
        components."""
        if not self.partitions or self.partition_rounds is None:
            return None
        if rnd not in self.partition_rounds:
            return None
        if self.partition_groups is not None:
            groups = [list(g) for g in self.partition_groups]
            covered = {c for g in groups for c in g}
            rest = [c for c in range(num_clients) if c not in covered]
            if rest:
                # clients the spec doesn't mention form their own component
                groups.append(rest)
            return tuple(tuple(g) for g in groups if g)
        count = min(self.partition_count, num_clients)
        perm = self._rng(_LANE_PARTITION, 0).permutation(num_clients)
        groups = [sorted(int(c) for c in perm[i::count])
                  for i in range(count)]
        return tuple(tuple(g) for g in groups)

    def churn_alive(self, rnd: int,
                    num_clients: int) -> Optional[np.ndarray]:
        """[C] float 0/1 alive-mask (0 = left, or not yet joined), or None
        when no churn is scheduled. Monotone per client."""
        if not self.churns:
            return None
        alive = np.ones((num_clients,), np.float32)
        for c, r in (self.churn_join or ()):
            if c < num_clients and rnd < r:
                alive[c] = 0.0
        for c, r in (self.churn_leave or ()):
            if c < num_clients and rnd >= r:
                alive[c] = 0.0
        return alive

    def flaky_set(self, num_clients: int) -> np.ndarray:
        """[C] bool: which clients are flaky (explicit list + seeded
        fraction draw; constant for the whole plan)."""
        flaky = np.zeros((num_clients,), bool)
        for c in (self.flaky_clients or ()):
            if c < num_clients:
                flaky[c] = True
        if self.flaky_frac > 0:
            draw = self._rng(_LANE_FLAKY, 0).random(num_clients)
            flaky |= draw < self.flaky_frac
        return flaky

    def flaky_scales(self, rnd: int,
                     num_clients: int) -> Optional[np.ndarray]:
        """[C] float32 additive corruption scales from the flaky lane (0 =
        clean), or None when no flaky client bursts this round. Each
        ``flaky_burst_len``-round window is bad per flaky client with
        ``flaky_on_prob``, so an offender corrupts for ``burst_len``
        consecutive rounds."""
        if not self.flaky_enabled:
            return None
        flaky = self.flaky_set(num_clients)
        if not flaky.any():
            return None
        window = rnd // self.flaky_burst_len
        # window draws come from (seed, FLAKY, 1 + window): offset by 1 so
        # they never collide with the flaky-set draw at (seed, FLAKY, 0)
        draw = self._rng(_LANE_FLAKY, 1 + window).random(num_clients)
        row = np.where(flaky & (draw < self.flaky_on_prob),
                       self.flaky_scale, 0.0)
        return row.astype(np.float32) if row.any() else None

    def wire_actions(self, rnd: int, src: int, dst: int, msg_id: int,
                     attempt: int = 0) -> Optional[dict]:
        """Socket-level fault draw for one transmission attempt of message
        ``(src, dst, msg_id)`` while the sender's wire clock reads ``rnd``
        (its local round). None when the lane is off or not due, else
        ``{"drop", "dup", "reorder_s", "delay_s", "corrupt",
        "corrupt_pos"}``: lose the attempt, send a second clean copy,
        hold it at the receiver, sleep before sending, flip payload bytes
        after the CRC at the fractions ``corrupt_pos``. ``attempt`` is in
        the key, so a retry re-rolls its fate; the same coordinates always
        replay the same fault."""
        if not self.wire_enabled or not self._due(self.wire_rounds, rnd):
            return None
        rng = self._wire_rng(rnd, src, dst, msg_id, attempt)
        draw = rng.random(5)
        delay = 0.0
        if self.wire_delay_prob > 0 and draw[3] < self.wire_delay_prob:
            delay = float(rng.random() * self.wire_delay_s)
        return {
            "drop": bool(draw[0] < self.wire_drop_prob),
            "dup": bool(draw[1] < self.wire_dup_prob),
            "reorder_s": (self.wire_reorder_hold_s
                          if draw[2] < self.wire_reorder_prob else 0.0),
            "delay_s": delay,
            "corrupt": bool(draw[4] < self.wire_corrupt_prob),
            "corrupt_pos": tuple(float(x) for x in rng.random(4)),
        }

    def _wire_rng(self, rnd: int, src: int, dst: int, msg_id: int,
                  attempt: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed, _LANE_WIRE, rnd, src, dst, msg_id, attempt))

    def storage_action(self, version: int, peer: int) -> Optional[dict]:
        """Durable-state damage draw for one freshly committed checkpoint
        of ``peer`` at ``version`` (its global-version clock): None when
        the state stays intact, else ``{"cls": <one of storage_classes>,
        "frac": <byte-offset fraction in [0, 1)>, "delete_last":
        storage_delete_last}``. The same ``(seed, version, peer)`` always
        draws the same damage; the runtime applies it after the commit."""
        if self.storage_prob <= 0:
            return None
        if self.storage_peers is not None and peer not in self.storage_peers:
            return None
        if not self._due(self.storage_rounds, version):
            return None
        rng = np.random.default_rng(
            (self.seed, _LANE_STORAGE, version, peer))
        if rng.random() >= self.storage_prob:
            return None
        pick = int(rng.integers(len(self.storage_classes)))
        return {"cls": self.storage_classes[pick],
                "frac": float(rng.random()),
                "delete_last": int(self.storage_delete_last)}

    def byz_action(self, rnd: int, peer: int) -> Optional[dict]:
        """Adversarial-behavior draw for one update of ``peer`` while its
        local-round clock reads ``rnd``: None when the peer is honest, the
        lane is off, the span is not due or the ``byz_prob`` draw says
        "behave this round", else ``{"behavior": <one of byz_behaviors>,
        "scale": byz_scale}``. The same ``(seed, rnd, peer)`` always draws
        the same behavior; the payload noise comes from :meth:`byz_rng`,
        keyed by the same coordinates plus the destination."""
        if not self.byz_enabled or peer not in self.byz_peers:
            return None
        if not self._due(self.byz_rounds, rnd):
            return None
        rng = np.random.default_rng((self.seed, _LANE_BYZ, rnd, peer))
        if rng.random() >= self.byz_prob:
            return None
        pick = int(rng.integers(len(self.byz_behaviors)))
        return {"behavior": self.byz_behaviors[pick],
                "scale": float(self.byz_scale)}

    def byz_rng(self, rnd: int, peer: int, dst: int) -> np.random.Generator:
        """Noise stream of one (adversary, round, destination) payload
        mutation: keyed by the destination, so equivocation ships
        different bytes to different receivers, and the same coordinates
        always replay the same bytes."""
        return np.random.default_rng(
            (self.seed, _LANE_BYZ, rnd, peer, dst, 1))

    def sync_tamper_action(self, server: int, requester: int,
                           serial: int) -> Optional[dict]:
        """In-flight tamper draw for one state transfer ``server`` is about
        to serve ``requester`` (``serial`` counts that pair's serves from
        0). Only the first serve of a listed pair is tampered, so the
        requester refuses it and adopts the clean retry. Returns
        ``{"frac": <byte-offset fraction to flip>}`` or None."""
        if not self.sync_tamper or serial != 0:
            return None
        if (server, requester) not in self.sync_tamper:
            return None
        rng = np.random.default_rng(
            (self.seed, _LANE_STORAGE, server, requester, 1))
        return {"frac": float(rng.random())}

    def limp_action(self, rnd: int, peer: int) -> Optional[dict]:
        """Gray-failure draw for one round of ``peer`` while its local
        round reads ``rnd``: None at full speed, else ``{"stall_s": <train
        seam sleep>, "throttle_bps": <link rate this round, 0 =
        unthrottled>}``. The throttle is consumed per direction through
        :meth:`limp_throttle`."""
        if not self.limp_enabled:
            return None
        if self.limp_peers is not None and peer not in self.limp_peers:
            return None
        if not self._due(self.limp_rounds, rnd):
            return None
        rng = np.random.default_rng((self.seed, _LANE_LIMP, rnd, peer))
        if rng.random() >= self.limp_prob:
            return None
        return {"stall_s": float(self.limp_stall_s),
                "throttle_bps": float(self.limp_throttle_bps)}

    def limp_throttle(self, rnd: int, src: int, dst: int) -> Optional[float]:
        """The byte rate the ``src -> dst`` direction is degraded to while
        the sender's clock reads ``rnd``, or None when it is healthy. Keyed
        by the ORDERED pair, so A->B can limp while B->A stays healthy;
        with ``limp_oneway`` only a limp peer's outbound side is
        eligible."""
        if not self.limp_enabled or self.limp_throttle_bps <= 0:
            return None
        if not self._due(self.limp_rounds, rnd):
            return None
        if not (self._is_limp_peer(src)
                or (not self.limp_oneway and self._is_limp_peer(dst))):
            return None
        rng = np.random.default_rng(
            (self.seed, _LANE_LIMP, rnd, src, dst, 1))
        if rng.random() >= self.limp_prob:
            return None
        return float(self.limp_throttle_bps)

    def _is_limp_peer(self, peer: int) -> bool:
        return self.limp_peers is None or peer in self.limp_peers

    def resource_action(self, seam: str, counter: int,
                        peer: int) -> Optional[dict]:
        """Durable-write failure draw for one write at ``seam`` (a
        :data:`RESOURCE_SEAMS` name) while that seam's counter reads
        ``counter`` (checkpoint: the version; ledger: the chain length;
        events: the flush sequence). None when the write proceeds, else
        ``{"cls": <one of resource_classes>, "depth": 1 | 2 | 3}``: the
        fault clears after emergency GC (1), after the telemetry shed (2),
        or survives both (3, the peer exits with the durability code)."""
        if not self.resource_enabled:
            return None
        if (self.resource_peers is not None
                and peer not in self.resource_peers):
            return None
        if not self._due(self.resource_rounds, counter):
            return None
        seam_idx = RESOURCE_SEAMS.index(seam)  # an unknown seam fails loud
        rng = np.random.default_rng(
            (self.seed, _LANE_RESOURCE, seam_idx, counter, peer))
        if rng.random() >= self.resource_prob:
            return None
        pick = int(rng.integers(len(self.resource_classes)))
        depth = 1 + int(rng.integers(3))
        return {"cls": self.resource_classes[pick], "depth": depth}


class FaultInjector:
    """Binds a :class:`FaultPlan` to one engine run (fixed client count)
    and carries the two legacy corruption hooks:

    - ``host_tamper``: ``(rnd, host_stacked) -> tree``, byte-level
      tampering of host trees; forces the full byte-hash ledger flow;
    - ``fused_tamper``: ``(rnd) -> [C] scales or None``, corruption of
      fused multi-round dispatches (``rounds_per_dispatch > 1``): the
      chunk's transport stage adds the scales after each client's
      fingerprint is committed. A round it asks to corrupt that runs the
      per-round path raises in the engine.
    """

    def __init__(self, plan: Optional[FaultPlan], num_clients: int,
                 host_tamper: Optional[Callable] = None,
                 fused_tamper: Optional[Callable] = None):
        self.plan = plan if plan is not None else FaultPlan()
        self.num_clients = int(num_clients)
        self.host_tamper = host_tamper
        self.fused_tamper = fused_tamper
        if self.plan.corrupts and host_tamper is not None:
            raise ValueError(
                "FaultPlan corruption and the legacy tamper_hook are two "
                "transport models for the same updates — pick one (the "
                "tamper_hook shim exists only for byte-level host tampering)")
        p = self.plan
        if p.partition_groups is not None:
            bad = [c for g in p.partition_groups for c in g
                   if c >= self.num_clients]
            if bad:
                raise ValueError(
                    f"partition_groups name clients {bad} but the run has "
                    f"only {self.num_clients} clients")
            covered = {c for g in p.partition_groups for c in g}
            rest = self.num_clients - len(covered)
            if len(p.partition_groups) + (1 if rest else 0) < 2:
                raise ValueError(
                    "partition_groups split nothing: the spec covers every "
                    f"client in {len(p.partition_groups)} component(s) and "
                    "leaves no unlisted clients to form another — a "
                    "partition needs >= 2 effective components")
        if p.partition_count > self.num_clients:
            raise ValueError(
                f"partition_count {p.partition_count} > num_clients "
                f"{self.num_clients}: components would be empty")
        for name in ("churn_leave", "churn_join", "flaky_clients"):
            sched = getattr(p, name) or ()
            ids = [e[0] if isinstance(e, tuple) else e for e in sched]
            bad = [c for c in ids if c >= self.num_clients]
            if bad:
                raise ValueError(
                    f"{name} names clients {bad} but the run has only "
                    f"{self.num_clients} clients")

    # per-round delegates (client count already bound)
    def dropout_keep(self, rnd: int) -> Optional[np.ndarray]:
        return self.plan.dropout_keep(rnd, self.num_clients)

    def straggler_delays(self, rnd: int) -> Optional[np.ndarray]:
        return self.plan.straggler_delays(rnd, self.num_clients)

    def transport_scales(self, rnd: int) -> Optional[np.ndarray]:
        """Per-round Bernoulli corruption plus flaky bursts, summed: one
        call site decides "is corruption scheduled" for the round."""
        base = self.plan.transport_scales(rnd, self.num_clients)
        flaky = self.plan.flaky_scales(rnd, self.num_clients)
        if flaky is None:
            return base
        if base is None:
            return flaky
        return (base + flaky).astype(np.float32)

    def partition_components(self, rnd: int):
        return self.plan.partition_components(rnd, self.num_clients)

    def churn_alive(self, rnd: int) -> Optional[np.ndarray]:
        return self.plan.churn_alive(rnd, self.num_clients)

    def should_crash(self, rnd: int) -> bool:
        return self.plan.should_crash(rnd)

    def blocks_fusion(self) -> bool:
        """Any scheduled plan fault forces the per-round path: dropout,
        churn and partition perturb the mask or the topology, stragglers
        and crashes need the host's clock and loop between rounds, and the
        plan's corruption (flaky bursts included) runs the per-round
        transport stage. The ``fused_tamper`` shim does not block fusion:
        the fused chunk is where it acts."""
        return self.plan.enabled
