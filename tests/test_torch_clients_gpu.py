"""PyTorch port (``bcfl_tpu_torch``): the clients axis on the card.

A tiny bert-style engine run (tiny-bert, flash attention at every length,
bf16 compute, ``int8+topk``, the ledger, 2 rounds) with its client shards
on ``[cuda:0] * 4`` (four shards sharing one card) equals the same run on
``[cuda:0]`` bit for bit, as ``chip_smoke.py``'s path (z) holds it
(``chip_smoke.clients_axis_pair``): the global (server) or stacked
(serverless) tree, every round's payload, the ledger head, the per-client
stats and evaluation, and the launches of K1-K5; those launches are also
counted exactly here (K4 once a round, K2 and K3 rounds x clients x steps
x layers). Server FedAvg with 4 clients (4 shards of 1) and serverless
gossip with 10 clients (2 shards of 5). On a host with four or more cards
(skipped below four), the same runs on ``[cuda:0, cuda:1, cuda:2,
cuda:3]`` equal them too, each shard's clients issued to its own card.

The tests marked ``gpu`` skip without a card. This file imports neither
JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_clients_gpu.py
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from bcfl_tpu_torch.compression import CompressionConfig
from bcfl_tpu_torch.config import FedConfig, LedgerConfig
from bcfl_tpu_torch.fed import client_step as cs
from bcfl_tpu_torch.models import get_config

ROUNDS, STEPS = 2, 2

CASES = {
    "server-4-clients": dict(mode="server", num_clients=4),
    "serverless-10-clients": dict(mode="serverless", num_clients=10),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the client shards' kernels run "
                    "only on the card)")
    return torch.device("cuda", 0)


@pytest.fixture
def four_cards(cuda_device):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs (client shards on separate "
                    "cards)")
    return [torch.device("cuda", i) for i in range(4)]


def _smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _cfg(**kw):
    return FedConfig(name="clients-axis-gpu", model="tiny-bert",
                     dataset="synthetic", num_labels=2, num_rounds=ROUNDS,
                     seq_len=64, batch_size=8, max_local_batches=STEPS,
                     vocab_size=512, eval_every=1, use_flash=True,
                     compression=CompressionConfig(kind="int8+topk"),
                     ledger=LedgerConfig(enabled=True), **kw)


def _pair(monkeypatch, cfg, devices):
    """``chip_smoke.clients_axis_pair`` (which raises on any difference)
    with the shard devices every sharded call ran on; the exact launch
    counts checked."""
    seen = []
    run_sharded = cs.run_sharded

    def recording(sh, inputs):
        seen.append(list(sh.devices))
        return run_sharded(sh, inputs)

    monkeypatch.setattr(cs, "run_sharded", recording)
    smoke = _smoke()
    out = smoke.clients_axis_pair(cfg, smoke.nvidia_smi_line(),
                                  "clients axis gpu test", devices)
    launches = out["one"][0]
    assert out["many"][0] == launches and min(launches.values()) > 0
    assert launches["int8_quantize"] == ROUNDS
    layers = get_config(cfg.model).num_layers
    want = ROUNDS * cfg.num_clients * STEPS * layers
    assert launches["flash_bwd_dkv"] == launches["flash_bwd_dq"] == want
    return seen


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_four_shards_on_one_card_equal_one_shard(monkeypatch, cuda_device,
                                                 case):
    cfg = _cfg(**CASES[case])
    seen = _pair(monkeypatch, cfg, [cuda_device] * 4)
    shards = 4 if cfg.num_clients == 4 else 2
    assert seen and all(d == [cuda_device] * shards for d in seen)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_shards_on_four_cards_equal_one_shard(monkeypatch, four_cards, case):
    cfg = _cfg(**CASES[case])
    seen = _pair(monkeypatch, cfg, four_cards)
    shards = 4 if cfg.num_clients == 4 else 2
    assert seen and all(d == four_cards[:shards] for d in seen)
