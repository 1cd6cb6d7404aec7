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
for bit. Of the JAX plan's lanes for its multi-process runtime, the
storage lane draws here (:meth:`FaultPlan.storage_action`,
:meth:`FaultPlan.sync_tamper_action`; the peer runtime consumes them).
The wire, byzantine, limp and resource lanes carry their fields with JAX's
names and defaults, so a config can name them, but they draw nothing and
the config refuses an armed one ("not ported yet" on ``runtime="dist"``,
JAX's own reason on ``"local"``).
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
_LANE_STORAGE = 8

# the dist-only lanes' vocabularies (JAX's canonical orders)
BYZ_BEHAVIORS = ("scale", "sign_flip", "garbage", "replay", "digest_forge",
                 "equivocate")
STORAGE_CLASSES = ("torn", "payload_flip", "meta_flip", "truncate",
                   "delete", "ledger", "rollback")
RESOURCE_CLASSES = ("enospc", "emfile")


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
    # --- the JAX plan's dist-only lanes (fields only, see the module
    # docstring): wire faults, byzantine peers, storage damage, limp
    # (gray failure) and resource (ENOSPC/EMFILE) faults ---
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
        self._check_storage()

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

    # ------------------------------------------------------------------ query

    @property
    def enabled(self) -> bool:
        return (self.dropout_prob > 0 or self.straggler_prob > 0
                or self.corrupt_prob > 0 or self.crash_at_round is not None
                or self.partitions or self.churns or self.flaky_enabled)

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


class FaultInjector:
    """Binds a :class:`FaultPlan` to one engine run (fixed client count)
    and carries the two legacy corruption hooks:

    - ``host_tamper``: ``(rnd, host_stacked) -> tree``, byte-level
      tampering of host trees; forces the full byte-hash ledger flow;
    - ``fused_tamper``: ``(rnd) -> [C] scales or None``, corruption of
      fused multi-round dispatches. The port runs every round on the
      per-round path, so a round it asks to corrupt raises in the engine.
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
