"""Configuration: port of ``bcfl_tpu/config.py`` (``PartitionConfig``,
``TopologyConfig``, ``LedgerConfig``, ``FedConfig``; the codec config
lives in :mod:`bcfl_tpu_torch.compression.codecs` as in JAX).

``FedConfig`` holds the fields the ported slices run, with the JAX
package's names, types and defaults (the fault plan, reputation, robust
aggregation and checkpoint fields included), plus the switches of features
the port does not have yet. A value the slice does not support raises ``ValueError``
naming the field and saying it is "not ported yet" — the port never
silently runs something other than what was asked for.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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


#: (field, is-unsupported predicate) — each raises "not ported yet"
_NOT_PORTED = (
    ("runtime", lambda c: c.runtime != "local"),
    ("task", lambda c: c.task != "classification"),
    ("tokenizer", lambda c: c.tokenizer != "hash"),
    ("hf_checkpoint", lambda c: c.hf_checkpoint is not None),
    ("lora_rank", lambda c: c.lora_rank > 0),
    ("tp", lambda c: c.tp > 1),
    ("sp", lambda c: c.sp > 1),
    ("local_epochs", lambda c: c.local_epochs != 1),
    ("rounds_per_dispatch", lambda c: c.rounds_per_dispatch > 1),
    ("registry_size", lambda c: c.registry_size > 0),
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
    lora_rank: int = 0
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
    # cohort sampling (the JAX package's registry of clients); 0 = off
    registry_size: int = 0
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
                    "the local fault plan, robust aggregation, reputation "
                    "and checkpoints (see ROADMAP.md for the port's queue)")

    def replace(self, **kw) -> "FedConfig":
        return dataclasses.replace(self, **kw)
