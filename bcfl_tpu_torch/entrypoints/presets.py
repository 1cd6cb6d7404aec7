"""Config presets: port of ``bcfl_tpu/entrypoints/presets.py`` (the
reference scripts as named ``FedConfig`` rows, with the JAX fields).

``hf=True`` seeds every preset but ``smoke`` from its model's HF
checkpoint and tokenizer (``_HF``): this needs ``transformers`` and the
checkpoint on disk (a hub cache, or no network). Without it the presets
build the same architecture with a fresh init. The ``imdb``, ``covid`` and ``cancer`` datasets come from the
HF hub; offline, or without the ``datasets`` library, they load as
synthetic stand-ins with the same label space, named
``<name>:synthetic-standin``, as in JAX.
"""

from __future__ import annotations

from typing import Dict, List

from bcfl_tpu_torch.config import (FedConfig, LedgerConfig, PartitionConfig,
                                   TopologyConfig)


_HF = {
    "albert-base": "albert-base-v2",
    "biobert-base": "dmis-lab/biobert-v1.1",
    "bert-base": "bert-base-uncased",
    "clinical-bert": "emilyalsentzer/Bio_ClinicalBERT",
}


def build_presets(hf: bool = False) -> Dict[str, FedConfig]:
    p: Dict[str, FedConfig] = {}

    # ---- server case (Flower-simulation scripts -> mode="server") ----
    p["server_iid_imdb"] = FedConfig(
        name="server_iid_imdb", model="biobert-base", dataset="imdb",
        num_labels=2, mode="server", num_clients=20, num_rounds=20,
        partition=PartitionConfig(kind="iid", iid_samples=100))
    p["server_noniid_imdb"] = FedConfig(
        name="server_noniid_imdb", model="albert-base", dataset="imdb",
        num_labels=2, mode="server", num_clients=20, num_rounds=20,
        partition=PartitionConfig(
            kind="contiguous", stride=300, train_span=240, test_span=60,
            test_mode="trailing"))
    p["server_iid_medical"] = FedConfig(
        name="server_iid_medical", model="biobert-base",
        dataset="medical_transcriptions", num_labels=40, mode="server",
        num_clients=5, num_rounds=20,
        partition=PartitionConfig(kind="iid", iid_samples=500))
    p["server_noniid_medical"] = FedConfig(
        name="server_noniid_medical", model="biobert-base",
        dataset="medical_transcriptions", num_labels=40, mode="server",
        num_clients=10, num_rounds=20,
        partition=PartitionConfig(
            kind="contiguous", stride=500, train_span=400, test_span=400,
            test_mode="fixed"))

    # ---- serverless case (manual round loops -> mode="serverless") ----
    p["serverless_iid_imdb"] = FedConfig(
        name="serverless_iid_imdb", model="albert-base", dataset="imdb",
        num_labels=2, mode="serverless", weighted_agg=False, num_clients=10,
        num_rounds=20,
        partition=PartitionConfig(kind="iid", iid_samples=100,
                                  resample_each_round=True))
    p["serverless_noniid_imdb"] = FedConfig(
        name="serverless_noniid_imdb", model="albert-base", dataset="imdb",
        num_labels=2, mode="serverless", weighted_agg=False, num_clients=10,
        num_rounds=20,
        partition=PartitionConfig(
            kind="contiguous", stride=300, train_span=240, test_span=60,
            test_mode="trailing"))
    p["serverless_iid_medical"] = FedConfig(
        name="serverless_iid_medical", model="biobert-base",
        dataset="medical_transcriptions", num_labels=40, mode="serverless",
        weighted_agg=False, num_clients=20, num_rounds=20,
        partition=PartitionConfig(kind="iid", iid_samples=500,
                                  resample_each_round=True))
    p["serverless_noniid_medical"] = FedConfig(
        name="serverless_noniid_medical", model="biobert-base",
        dataset="medical_transcriptions", num_labels=40, mode="serverless",
        weighted_agg=False, num_clients=10, num_rounds=20,
        partition=PartitionConfig(
            kind="contiguous", stride=500, train_span=400, test_span=400,
            test_mode="fixed"))
    p["serverless_covid_iid"] = FedConfig(
        name="serverless_covid_iid", model="albert-base", dataset="covid",
        num_labels=41, mode="serverless", weighted_agg=False,
        num_clients=10, num_rounds=20,
        partition=PartitionConfig(kind="iid", iid_samples=500,
                                  resample_each_round=True))
    p["serverless_cancer_iid"] = FedConfig(
        name="serverless_cancer_iid", model="albert-base", dataset="cancer",
        num_labels=41, mode="serverless", weighted_agg=False,
        num_clients=10, num_rounds=20,
        partition=PartitionConfig(kind="iid", iid_samples=500,
                                  resample_each_round=True))
    p["serverless_cancer_biobert"] = FedConfig(
        name="serverless_cancer_biobert", model="biobert-base",
        dataset="cancer", num_labels=41, mode="serverless",
        weighted_agg=False, num_clients=10, num_rounds=20,
        partition=PartitionConfig(kind="iid", iid_samples=500,
                                  resample_each_round=True))

    # ---- BC-FL: hash-chained ledger + PageRank gating + async gossip ----
    p["bcfl_async_pagerank"] = FedConfig(
        name="bcfl_async_pagerank", model="albert-base", dataset="imdb",
        num_labels=2, mode="serverless", sync="async", weighted_agg=False,
        num_clients=10, num_rounds=20, async_buffer=4,
        partition=PartitionConfig(kind="iid", iid_samples=100,
                                  resample_each_round=True),
        topology=TopologyConfig(anomaly_filter="pagerank"),
        ledger=LedgerConfig(enabled=True))
    # smoke: the reference's NUM_CLIENTS=2/NUM_ROUNDS=2 scale-down,
    # serverless
    p["smoke"] = FedConfig(
        name="smoke", model="tiny-bert", dataset="synthetic", num_labels=2,
        mode="serverless", weighted_agg=False, num_clients=2, num_rounds=2,
        seq_len=64, max_local_batches=2,
        partition=PartitionConfig(kind="iid", iid_samples=64))
    if hf:
        p = {k: (c if k == "smoke" else c.replace(
                 hf_checkpoint=_HF[c.model], tokenizer=_HF[c.model]))
             for k, c in p.items()}
    return p


def get_preset(name: str, hf: bool = False) -> FedConfig:
    presets = build_presets(hf)
    if name not in presets:
        raise KeyError(f"unknown preset {name!r}; have {sorted(presets)}")
    return presets[name]


def list_presets() -> List[str]:
    return sorted(build_presets())


# the reference's worker sweep: ``for NUM_CLIENTS in [5, 10, 20]``
# (serverless_cancer_biobert_allclients.py:41)
SWEEP_CLIENTS = [5, 10, 20]
