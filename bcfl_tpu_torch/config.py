"""Configuration: port of ``bcfl_tpu/config.py`` (``PartitionConfig``,
``TopologyConfig``, ``LedgerConfig``, ``FedConfig``; the codec config
lives in :mod:`bcfl_tpu_torch.compression.codecs` as in JAX).

``FedConfig`` holds the fields the ported slices run, with the JAX
package's names, types and defaults (the fault plan, reputation, robust
aggregation, checkpoint, LoRA and cohort fields included), plus the
switches of features the port does not have yet. A value the slice does
not support raises ``ValueError`` naming the field and saying it is "not
ported yet" — the port never silently runs something other than what was
asked for. ``cohort_size`` pins mesh devices in JAX; on the port's one
card it accepts only 0 and the whole sampled cohort.
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
    fields and defaults). ``use_native`` selects the JAX package's C++
    SHA-256 core; the port hashes with ``hashlib`` (identical digests) and
    its native core is ROADMAP.md's tokenizer-and-native item, so the field
    has no effect yet."""

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


#: (field, is-unsupported predicate) — each raises "not ported yet"
_NOT_PORTED = (
    ("runtime", lambda c: c.runtime != "local"),
    ("tokenizer", lambda c: c.tokenizer != "hash"),
    ("hf_checkpoint", lambda c: c.hf_checkpoint is not None),
    ("tp", lambda c: c.tp > 1),
    ("sp", lambda c: c.sp > 1),
    ("local_epochs", lambda c: c.local_epochs != 1),
    ("rounds_per_dispatch", lambda c: c.rounds_per_dispatch > 1),
    # the flash kernels have bf16 and float32 instances only
    ("compute_dtype", lambda c: c.compute_dtype == "float16"
     and bool(c.use_flash)),
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
    tp: int = 1
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
    # clients stacked per device. In JAX it pins the mesh to
    # sample_clients / cohort_size devices; the port runs on one card, so
    # only 0 and the whole cohort (one device) are accepted
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

    # --- checkpoint / metrics ---
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0  # rounds; 0 = off
    # evaluate every Nth round (the final round always evaluates); 0 = never
    eval_every: int = 1
    max_eval_batches: Optional[int] = None

    def __post_init__(self):
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
                    f"{field}={value!r} is not ported yet: bcfl_tpu_torch "
                    "runs server FedAvg, serverless ring gossip and "
                    "buffered async with the anomaly filter, the ledger, "
                    "the local fault plan, robust aggregation, reputation, "
                    "checkpoints, LoRA and cohort sampling (see ROADMAP.md "
                    "for the port's queue)")

    def _check_lora_and_cohort(self, plan: FaultPlan) -> None:
        """The JAX package's rejections of heterogeneous ranks and of cohort
        mode, with its reasons; plus ``cohort_size`` on one card."""
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
        if self.cohort_size and self.cohort_size != active:
            # JAX pins the mesh to active / cohort_size devices; the port
            # has one card
            raise ValueError(
                f"cohort_size {self.cohort_size} needs "
                f"{active // self.cohort_size} devices for a {active}-client "
                "cohort, have 1")
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
