"""Config serialization for peer processes: port of
``bcfl_tpu/dist/launch.py``.

The supervisor holds one :class:`FedConfig`; each peer process must
rebuild it exactly (same seed, same codec, same fault plan: every digest
and schedule derives from it), so the config crosses the process boundary
as JSON of the dataclass tree. Tuples become JSON lists; the rebuild
re-tuples the fault plan's fields (the frozen plan needs hashable
members)."""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict

from bcfl_tpu_torch.compression import CompressionConfig
from bcfl_tpu_torch.config import (
    DistConfig,
    FedConfig,
    LedgerConfig,
    PartitionConfig,
    TopologyConfig,
)
from bcfl_tpu_torch.faults import FaultPlan
from bcfl_tpu_torch.reputation import ReputationConfig


def cfg_to_json(cfg: FedConfig) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2, sort_keys=True)


def _tupleize(v: Any) -> Any:
    if isinstance(v, list):
        return tuple(_tupleize(x) for x in v)
    return v


def _rebuild(cls, data: Dict) -> Any:
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - fields
    if unknown:
        raise ValueError(f"{cls.__name__} JSON has unknown fields {unknown} "
                         "(config written by a newer build?)")
    return cls(**data)


def cfg_from_json(s: str) -> FedConfig:
    data = json.loads(s)
    data["partition"] = _rebuild(PartitionConfig, data["partition"])
    data["topology"] = _rebuild(TopologyConfig, data["topology"])
    data["ledger"] = _rebuild(LedgerConfig, data["ledger"])
    if data["faults"] is not None:
        data["faults"] = _rebuild(FaultPlan, {
            k: _tupleize(v) for k, v in data["faults"].items()})
    data["reputation"] = _rebuild(ReputationConfig, data["reputation"])
    data["compression"] = _rebuild(CompressionConfig, data["compression"])
    data["dist"] = _rebuild(DistConfig, data["dist"])
    if data.get("lora_ranks"):
        # lora_rank was canonicalized to max(lora_ranks) at construction;
        # passing both back would be refused (JAX's rebuild fails here)
        data["lora_rank"] = 0
    return _rebuild(FedConfig, data)
