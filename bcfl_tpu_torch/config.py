"""Configuration: port of ``bcfl_tpu/config.py`` (``PartitionConfig``,
``FedConfig``; the codec config lives in
:mod:`bcfl_tpu_torch.compression.codecs` as in JAX).

``FedConfig`` holds the fields the ported slice runs, with the JAX
package's names and defaults, plus the switches of features the port does
not have yet. A value the slice does not support raises ``ValueError``
naming the field and saying it is "not ported yet" — the port never
silently runs something other than what was asked for.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from bcfl_tpu_torch.compression.codecs import CompressionConfig


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
class LedgerConfig:
    """The hash-chained ledger switch (the ledger is not ported yet)."""

    enabled: bool = False


#: (field, is-unsupported predicate) — each raises "not ported yet"
_NOT_PORTED = (
    ("runtime", lambda c: c.runtime != "local"),
    ("mode", lambda c: c.mode != "server"),
    ("sync", lambda c: c.sync != "sync"),
    ("task", lambda c: c.task != "classification"),
    ("tokenizer", lambda c: c.tokenizer != "hash"),
    ("hf_checkpoint", lambda c: c.hf_checkpoint is not None),
    ("lora_rank", lambda c: c.lora_rank > 0),
    ("use_flash", lambda c: bool(c.use_flash)),
    ("remat", lambda c: c.remat),
    ("tp", lambda c: c.tp > 1),
    ("sp", lambda c: c.sp > 1),
    ("aggregator", lambda c: c.aggregator != "mean"),
    ("optimizer", lambda c: c.optimizer != "adamw"),
    ("max_grad_norm", lambda c: c.max_grad_norm > 0),
    ("local_epochs", lambda c: c.local_epochs != 1),
    ("rounds_per_dispatch", lambda c: c.rounds_per_dispatch > 1),
    ("ledger.enabled", lambda c: c.ledger.enabled),
    ("faults", lambda c: c.faults is not None),
    ("checkpoint_dir", lambda c: c.checkpoint_dir is not None),
    ("param_dtype", lambda c: c.param_dtype != "float32"),
    ("compute_dtype", lambda c: c.compute_dtype not in ("float32",
                                                        "bfloat16")),
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
    use_flash: Optional[bool] = None
    remat: bool = False
    tp: int = 1
    sp: int = 1

    # --- federated topology ---
    runtime: str = "local"
    mode: str = "server"
    sync: str = "sync"
    num_clients: int = 4
    num_rounds: int = 2
    local_epochs: int = 1
    max_local_batches: Optional[int] = None
    rounds_per_dispatch: int = 1
    weighted_agg: bool = True  # example-weighted FedAvg
    aggregator: str = "mean"

    # --- optimizer (fresh AdamW lr=5e-5 each round) ---
    learning_rate: float = 5e-5
    optimizer: str = "adamw"
    max_grad_norm: float = 0.0

    # --- sub-configs ---
    partition: PartitionConfig = dataclasses.field(
        default_factory=PartitionConfig)
    ledger: LedgerConfig = dataclasses.field(default_factory=LedgerConfig)
    #: fault-injection plan; None injects nothing (faults are not ported)
    faults: Optional[Any] = None
    compression: CompressionConfig = dataclasses.field(
        default_factory=CompressionConfig)

    # --- checkpoint / metrics ---
    checkpoint_dir: Optional[str] = None
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
        for field, unsupported in _NOT_PORTED:
            if unsupported(self):
                value = self
                for part in field.split("."):
                    value = getattr(value, part)
                raise ValueError(
                    f"{field}={value!r} is not ported yet: bcfl_tpu_torch "
                    "runs server-mode synchronous FedAvg only (see "
                    "ROADMAP.md for the port's queue)")

    def replace(self, **kw) -> "FedConfig":
        return dataclasses.replace(self, **kw)
