"""PyTorch port (``bcfl_tpu_torch``): the codec stage on each client shard.

On a clients mesh of more than one shard with a codec, each shard runs the
sender's side of the exchange on its own device
(``fed/client_step.py::Sender``, JAX's ``_compress_stage`` under
``P('clients')``): the delta, the rank clip, the error-feedback add, K5
then K4, the decode and the new residual, whose rows stay on the shard's
device between rounds. Only the payload rows and the stats cross to the
lead device (with the post-train trees where they are the round's state);
transport, ledger, decode, the mean, the mix and the async merge stay
there. Here the devices are the CPU named four times:

- every mode (server FedAvg, with transport corruption and with
  heterogeneous LoRA ranks, serverless gossip, BC-FL async, a LoRA cohort
  of a 16-client registry, a partitioned round) on ``[cpu] * 4`` equals
  ``[cpu]`` bit for bit over 3 rounds with ``int8+topk``, stochastic
  rounding, error feedback and the ledger (trees, every round's payload,
  ledger head, records, the gathered residual), and so do 10 clients on
  4 devices (2 shards of 5); the codec ran once a shard a round over that
  shard's rows and never over the whole stack;
- in server mode with a codec no post-train tree reaches the lead: the
  bytes landing from shards 1-3 are their payload rows and stats, where
  without a codec they are the trees;
- a 4-shard run crashed mid-run and resumed on 4 shards, and on 1, ends
  with the uninterrupted run's bits;
- ``row_uniforms`` gives rows of the whole stack's draw, and the engine's
  residual splits to the shards and gathers back in client order.
"""

import dataclasses

import pytest
import torch

import test_torch_clients_axis as ca
from bcfl_tpu_torch.compression import CompressionConfig
from bcfl_tpu_torch.compression import codecs as cc
from bcfl_tpu_torch.core import prng
from bcfl_tpu_torch.faults import FaultPlan, SimulatedCrash
from bcfl_tpu_torch.fed import client_step as cs
from bcfl_tpu_torch.fed.engine import FedEngine

ROUNDS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # as in test_torch_clients_axis.py: workers must not oversubscribe
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

MODES = {
    **ca.MODES,
    "server-corrupt": dict(mode="server", faults=FaultPlan(
        seed=3, corrupt_prob=0.4)),
    "lora-hetero-ranks": dict(mode="server", model="tiny-llama",
                              lora_ranks="2,4,4,2", task="causal_lm"),
    "partitioned": dict(mode="server", faults=FaultPlan(
        partition_groups=((0, 1), (2, 3)), partition_rounds=(1,))),
    "ten-clients-gossip": dict(mode="serverless", num_clients=10),
}


def _tapped_run(monkeypatch, cfg, devices):
    """``cfg`` through the engine on ``devices``, every ``compress_stage``
    call's row count recorded per round."""
    calls = []
    stage = cs.compress_stage

    def recording(comp, new_t, *args, **kwargs):
        calls.append(next(iter(new_t.values())).shape[0])
        return stage(comp, new_t, *args, **kwargs)

    monkeypatch.setattr(cs, "compress_stage", recording)
    run = ca._run(cfg, devices)
    monkeypatch.setattr(cs, "compress_stage", stage)
    return run, calls


@pytest.mark.parametrize("case", list(MODES), ids=list(MODES))
def test_every_mode_encodes_on_its_shards_bit_for_bit(monkeypatch, case):
    cfg = ca._cfg(num_rounds=ROUNDS, **MODES[case])
    one, calls1 = _tapped_run(monkeypatch, cfg, ["cpu"])
    four, calls4 = _tapped_run(monkeypatch, cfg, ["cpu"] * 4)
    ca._assert_same_runs(one, four)
    C = one[0].C
    sh = four[0].local_train
    shards, per = len(sh.bodies), sh.per_device
    assert shards * per == C and shards > 1
    # one encode of the whole stack a round on one shard; on the mesh one
    # per shard over its own rows, never one over the whole stack
    assert calls1 == [C] * ROUNDS
    assert calls4 == [per] * (shards * ROUNDS)
    assert four[2].ef_residual is not None
    assert len(four[0]._ef_rows) == shards


@pytest.mark.parametrize("kind", ["int8+topk", "none"])
def test_server_mode_lands_payload_rows_only(monkeypatch, kind):
    cfg = ca._cfg(num_rounds=2, eval_every=0,
                  compression=CompressionConfig(kind=kind))
    eng = FedEngine(cfg, devices=["cpu"] * 4)
    landed = []
    exchange = FedEngine._exchange_updates

    def recording(self, rnd, new_t, *args, **kwargs):
        landed.append(new_t)
        return exchange(self, rnd, new_t, *args, **kwargs)

    monkeypatch.setattr(FedEngine, "_exchange_updates", recording)
    eng.run()
    sh = eng.local_train
    others = cfg.num_clients - sh.per_device  # the clients of shards 1-3
    per_client = (eng._wire_bytes_per_client if kind != "none"
                  else eng._raw_bytes_per_client)
    stats = 3 * 4  # [loss*n, correct, n] float32
    assert sh.traffic["to_lead"] == cfg.num_rounds * others * (
        per_client + stats)
    # out: the global once a shard, and each client's batch rows
    batch = sum(v[0].numel() * v[0].element_size()
                for v in eng._round_batches(0)[0].values())
    shards = len(sh.bodies) - 1
    assert sh.traffic["to_shards"] == cfg.num_rounds * (
        shards * eng._raw_bytes_per_client + others * batch)
    assert eng.eval_one.traffic is sh.traffic  # one tally a round
    if kind != "none":
        assert landed == [None] * cfg.num_rounds
    else:
        assert all(t is not None for t in landed)


@pytest.mark.parametrize("shards", [4, 1])
def test_four_shard_checkpoint_resumes_on_four_or_one(tmp_path, shards):
    cfg = ca._cfg(num_rounds=ROUNDS, eval_every=0)
    ref = FedEngine(cfg, devices=["cpu"] * 4).run()
    crash = cfg.replace(
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1,
        faults=dataclasses.replace(cfg.faults or FaultPlan(),
                                   crash_at_round=2))
    with pytest.raises(SimulatedCrash):
        FedEngine(crash, devices=["cpu"] * 4).run()
    eng = FedEngine(crash, devices=["cpu"] * shards)
    res = eng.run(resume=True)
    assert [r.round for r in res.metrics.rounds] == [2]
    assert len(eng._ef_rows) == shards
    for p, x in ref.trainable.items():
        assert ca._same(res.trainable[p], x), p
    for p, x in ref.ef_residual.items():
        assert ca._same(res.ef_residual[p], x), p
    assert res.ledger.head == ref.ledger.head
    a, b = ref.metrics.rounds[2], res.metrics.rounds[0]
    assert (a.train_loss, a.local_acc, a.auth, a.mask) == (
        b.train_loss, b.local_acc, b.auth, b.mask)


def test_row_uniforms_are_rows_of_the_whole_draw():
    draw = prng.codec_uniforms(7, 2)
    whole = draw(3, (10, 5, 16), torch.device("cpu"))
    rows = cc.row_uniforms(draw, 10, 5, 10)
    assert torch.equal(rows(3, (5, 5, 16), torch.device("cpu")), whole[5:])
    # a shorter draw is not those rows: the numbers follow the shape
    assert not torch.equal(draw(3, (5, 5, 16), torch.device("cpu")),
                           whole[5:])
    assert cc.row_uniforms(None, 10, 0, 5) is None


def test_residual_splits_to_shards_and_gathers_in_client_order():
    cfg = ca._cfg(num_clients=6, num_rounds=1)
    eng = FedEngine(cfg, devices=["cpu"] * 4)
    sh = eng.local_train
    assert len(sh.bodies) == 3 and sh.per_device == 2
    tree = {"a": torch.arange(6 * 4, dtype=torch.float64).reshape(6, 4),
            "b": torch.arange(6, dtype=torch.float32)}
    eng.set_ef_residual(tree)
    assert [r["a"].shape[0] for r in eng._ef_rows] == [2, 2, 2]
    assert all(r["a"].dtype == torch.float32 for r in eng._ef_rows)
    assert torch.equal(eng._ef_rows[1]["b"], tree["b"][2:4])
    back = eng.ef_residual()
    assert torch.equal(back["a"], tree["a"].float())
    assert torch.equal(back["b"], tree["b"])
    eng.set_ef_residual(None)
    assert eng.ef_residual() is None
    # a Sender needs a mesh of more than one shard
    one = FedEngine(cfg.replace(num_rounds=1), devices=["cpu"])
    assert one._sender(0) is None
    with pytest.raises(ValueError, match="more than one shard"):
        cs.train_clients(one.local_train, one.trainable0,
                         one._round_batches(0)[0], [None] * 6,
                         sender=cs.Sender(one._comp, []))


@pytest.mark.parametrize("body", ["server_round", "gossip_round"])
def test_round_bodies_encode_on_their_shards(monkeypatch, body):
    """``build_programs``' round bodies (``server_round``, and
    ``gossip_round`` through ``FedPrograms``) on a 4-device mesh: the
    codec runs once a shard over its own row, and the new global or mixed
    stack, the payload and the residual equal the one-device run's."""
    from bcfl_tpu_torch.core import mesh as tmesh
    from bcfl_tpu_torch.fed.synthetic import synthetic_round_inputs
    from bcfl_tpu_torch.models import build
    from bcfl_tpu_torch.models.bert import init_params
    from bcfl_tpu_torch.models.convert import trainable_tree

    comp = CompressionConfig(kind="int8+topk")
    stage = cs.compress_stage
    outs = {}
    for n in (1, 4):
        calls = []

        def recording(comp, new_t, *args, **kwargs):
            calls.append(next(iter(new_t.values())).shape[0])
            return stage(comp, new_t, *args, **kwargs)

        monkeypatch.setattr(cs, "compress_stage", recording)
        model = build("tiny-bert", num_labels=2, vocab_size=512,
                      dtype=torch.float32, dropout_rate=0.0)
        init_params(model, prng.generator("cpu", 7))
        mesh = tmesh.client_mesh(4, [torch.device("cpu")] * n)
        progs = cs.build_programs(model, mesh, compression=comp)
        batches, w, gens = synthetic_round_inputs(mesh, 2, 4, 16,
                                                  vocab_size=512)
        g = trainable_tree(model)
        resid = cc.zero_residual(g, 4)
        uniforms = prng.codec_uniforms(7, 0)
        if body == "server_round":
            out = cs.server_round(progs.local_train, comp, g, batches, w,
                                  gens, resid, uniforms)
        else:
            out = progs.gossip_round(cs.broadcast(g, 4), batches, w, gens,
                                     resid, uniforms)
        outs[n] = out, calls
    (one, calls1), (four, calls4) = outs[1], outs[4]
    assert calls1 == [4] and calls4 == [1] * 4
    for a, b in ((one.global_t, four.global_t), (one.resid, four.resid)):
        assert a.keys() == b.keys()
        for p in a:
            assert ca._same(b[p], a[p]), p
    for p, parts in one.payload.items():
        for k, x in parts.items():
            assert ca._same(four.payload[p][k], x), (p, k)
    assert ca._same(four.stats, one.stats)
