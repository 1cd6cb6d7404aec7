"""PyTorch port (``bcfl_tpu_torch``): the clients axis on the card.

A tiny bert-style engine run (tiny-bert, flash attention at every length,
bf16 compute, ``int8+topk``, the ledger, 2 rounds) with its client shards
on ``[cuda:0] * 4`` (four shards sharing one card) equals the same run on
``[cuda:0]`` bit for bit, as ``chip_smoke.py``'s path (z) holds it
(``chip_smoke.clients_axis_pair``): the global (server) or stacked
(serverless) tree, every round's payload, the ledger head, the per-client
stats and evaluation, K1-K3 launched as often and K4, K5 once per shard
(each shard encodes its own rows); those launches are also counted
exactly here (K4 once a round per shard, K2 and K3 rounds x clients x
steps x layers), and in server mode only the payload rows and the stats
of shards 1 and up land on the lead. Server FedAvg with 4 clients (4
shards of 1) and serverless gossip with 10 clients (2 shards of 5). On a
host with four or more cards (skipped below four), the same runs on
``[cuda:0, cuda:1, cuda:2, cuda:3]`` equal them too, each shard's clients
and codec issued to its own card. On a host with two or more cards,
K4 and K5 launched on card 1 equal their plain versions there, and the
codec's uniforms drawn on card 1 equal card 0's.

A 2-D ``(clients, tp)`` mesh trains every row as a client shard: a tiny
Llama LoRA engine at ``tp=2`` (4 clients, flash at every length, K1-K3
once per head shard) on ``[cuda:0] * 4`` (2 rows of 2 sharing the card)
and, on a host with four or more cards, on ``[cuda:0, ..., cuda:3]``
(row 1 on cards 2 and 3) equals the same run on one row (``[cuda:0] * 2``,
``[cuda:0, cuda:1]``) bit for bit, every row's model split over its own
row's cards.

The tests marked ``gpu`` skip without a card. This file imports neither
JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_clients_gpu.py
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from bcfl_tpu_torch.compression import CompressionConfig, payload_nbytes
from bcfl_tpu_torch.core import prng
from bcfl_tpu_torch.config import FedConfig, LedgerConfig
from bcfl_tpu_torch.fed import client_step as cs
from bcfl_tpu_torch.models import get_config
from bcfl_tpu_torch.ops import codec_kernels as ck
from bcfl_tpu_torch.parallel import tp_linear

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
def second_card(cuda_device):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs (a client shard's codec on a "
                    "card other than 0)")
    return torch.device("cuda", 1)


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
    base = dict(name="clients-axis-gpu", model="tiny-bert",
                dataset="synthetic", num_labels=2, num_rounds=ROUNDS,
                seq_len=64, batch_size=8, max_local_batches=STEPS,
                vocab_size=512, eval_every=1, use_flash=True,
                compression=CompressionConfig(kind="int8+topk"),
                ledger=LedgerConfig(enabled=True))
    base.update(kw)
    return FedConfig(**base)


def _pair(monkeypatch, cfg, devices, one=None):
    """``chip_smoke.clients_axis_pair`` (which raises on any difference)
    of ``devices`` against ``one`` (default ``[cuda:0]``) with the shard
    devices every sharded call ran on, the exact launch counts checked;
    under ``tp`` every client shard's model is split over its own row."""
    seen = []
    run_sharded, build_programs = cs.run_sharded, cs.build_programs

    def recording(sh, inputs, *args):
        seen.append(list(sh.devices))
        return run_sharded(sh, inputs, *args)

    def checked(model, mesh, *args, **kw):
        progs = build_programs(model, mesh, *args, **kw)
        for s, body in enumerate(progs.local_train.bodies):
            m = next(c.cell_contents for c in body.__closure__
                     if isinstance(c.cell_contents, torch.nn.Module))
            for sh in tp_linear.split_layers(m).values():
                assert sh.devices == mesh.row_devices(s)
        return progs

    monkeypatch.setattr(cs, "run_sharded", recording)
    monkeypatch.setattr(cs, "build_programs", checked)
    smoke = _smoke()
    out = smoke.clients_axis_pair(cfg, smoke.nvidia_smi_line(),
                                  "clients axis gpu test", devices, one=one)
    launches, shards = out["one"][0], out["shards"]
    assert shards == len(seen[-1]) > 1 and min(launches.values()) > 0
    assert out["many"][0] == {
        k: v * (shards if k in smoke.SHARD_CODEC_OPS else 1)
        for k, v in launches.items()}
    assert launches["int8_quantize"] == ROUNDS
    layers = get_config(cfg.model).num_layers
    # under tp, once per head shard
    want = ROUNDS * cfg.num_clients * STEPS * layers * cfg.tp
    assert launches["flash_bwd_dkv"] == launches["flash_bwd_dq"] == want
    if cfg.mode == "server":
        # no post-train tree leaves its shard: payload rows and stats
        others = cfg.num_clients - cfg.num_clients // shards
        wire = payload_nbytes(cfg.compression, out["template"])
        for moved in out["many"][3]:
            assert moved["to_lead"] == others * (wire + 3 * 4)
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


#: a tiny Llama LoRA engine at tp=2: 4 clients, 2 rows of 2 on 4 devices
TP = dict(mode="server", num_clients=4, model="tiny-llama", lora_rank=2,
          tp=2)


@pytest.mark.gpu
def test_tp_rows_on_one_card_equal_one_row(monkeypatch, cuda_device):
    seen = _pair(monkeypatch, _cfg(**TP), [cuda_device] * 4,
                 one=[cuda_device] * 2)
    assert seen and all(d == [cuda_device] * 2 for d in seen)


@pytest.mark.gpu
def test_tp_rows_on_four_cards_equal_one_row(monkeypatch, four_cards):
    seen = _pair(monkeypatch, _cfg(**TP), four_cards, one=four_cards[:2])
    assert seen and all(d == [four_cards[0], four_cards[2]] for d in seen)


@pytest.mark.gpu
def test_codec_kernels_on_a_second_card(second_card):
    """K4 (its block count read per device) and K5 launched on card 1, at
    shapes of one client's rows, equal their plain versions there bit for
    bit, and count their launches."""
    gen = torch.Generator(device=second_card)
    gen.manual_seed(5)
    x = torch.randn((7, 100_003), generator=gen, device=second_card)
    before = ck.TOPK_SELECT.launches
    got = ck.TOPK_SELECT(x, k=5001)
    want = ck.topk_select_ref(x, k=5001)
    gs = [torch.randn(sh, generator=gen, device=second_card)
          for sh in ((1, 1172, 256), (1, 3, 7))]
    us = [torch.rand(g.shape, generator=gen, device=second_card) for g in gs]
    before4 = ck.INT8_QUANTIZE.launches
    q = ck.INT8_QUANTIZE(gs, us, stochastic=True)
    q_ref = ck.int8_quantize_grids_ref(gs, us, stochastic=True)
    torch.cuda.synchronize(second_card)
    assert ck.TOPK_SELECT.launches == before + 1
    assert ck.INT8_QUANTIZE.launches == before4 + 1
    for a, b in list(zip(got, want)) + [
            t for pair in zip(q, q_ref) for t in zip(*pair)]:
        assert a.device == second_card and torch.equal(a, b)


@pytest.mark.gpu
def test_uniforms_drawn_on_a_second_card_equal_card_0s(second_card):
    """A client shard draws its rows of the codec's uniforms on its own
    card (``codecs.row_uniforms``): the draw there equals card 0's."""
    draw = prng.codec_uniforms(3, 1)
    for i, shape in enumerate(((4, 1172, 256), (4, 3, 7), (10, 41, 256))):
        a = draw(i, shape, torch.device("cuda", 0))
        b = draw(i, shape, second_card)
        assert torch.equal(a, b.to(a.device)), shape
