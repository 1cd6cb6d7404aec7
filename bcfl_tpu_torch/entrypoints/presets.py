"""Config presets: port of the server-mode rows of
``bcfl_tpu/entrypoints/presets.py``.

- ``server_iid_medical``: the reference's ``server_iid_medical_
  transcirptions.py`` row: biobert-base, 40 labels, 5 clients, 20 rounds,
  IID 500 examples per client;
- ``smoke``: the JAX package's 2-client, 2-round tiny-bert scale-down, run
  in server mode. (The JAX ``smoke`` preset is serverless, which is not
  ported yet.)
"""

from __future__ import annotations

from typing import Dict, List

from bcfl_tpu_torch.config import FedConfig, PartitionConfig


def build_presets() -> Dict[str, FedConfig]:
    return {
        "server_iid_medical": FedConfig(
            name="server_iid_medical", model="biobert-base",
            dataset="medical_transcriptions", num_labels=40, mode="server",
            num_clients=5, num_rounds=20,
            partition=PartitionConfig(kind="iid", iid_samples=500)),
        "smoke": FedConfig(
            name="smoke", model="tiny-bert", dataset="synthetic",
            num_labels=2, mode="server", weighted_agg=False, num_clients=2,
            num_rounds=2, seq_len=64, max_local_batches=2,
            partition=PartitionConfig(kind="iid", iid_samples=64)),
    }


def get_preset(name: str) -> FedConfig:
    presets = build_presets()
    if name not in presets:
        raise KeyError(f"unknown preset {name!r}; have {sorted(presets)}")
    return presets[name]


def list_presets() -> List[str]:
    return sorted(build_presets())
