"""PyTorch port (``bcfl_tpu_torch``): the stacked per-client state on the
client shards.

On a clients mesh of more than one shard the serverless, async and
partitioned rounds keep their stacked ``[C, ...]`` state as each shard's
rows on its own device (``fed/client_step.py::Stacked``), as JAX keeps the
stack sharded over its mesh's ``clients`` axis: the clients train from
their rows where they are, each shard decodes its own payload rows, the
ring gossip mixes each shard's rows with two halo rows a step copied from
its neighbours' shards, and only what one reduction over the client axis
reads lands on the lead device. Here the devices are the CPU named four
times:

- every mode equals the one-shard run of the same configuration bit for
  bit over 3 rounds, on 4 shards of 1 client and on 2 shards of 5 (10
  clients on 4 devices), with ``int8+topk``, error feedback and the ledger
  unless named: serverless gossip at ``gossip_steps`` 1 and 2, and at 0
  with ``trimmed_mean``; serverless without a codec (the ledger on); a
  corrupted wire, with and without the codec; serverless in fused
  chunks of 2, with and without the codec; BC-FL async; a serverless
  partition span and its heal; a server partition span of tiny-llama
  LoRA at heterogeneous ranks (RBLA's mean); the gathered stack, the
  consensus, every round's payload, the residual, the ledger head and
  the records;
- a serverless chunk of 2 under ``fused_tamper`` on 4 shards equals 1
  shard bit for bit, the device's auth rows included;
- a 4-shard serverless run crashed mid-run and resumed on 4 shards, and on
  1, ends with the uninterrupted run's bits (stack and consensus), and
  the checkpoint holds the one-shard run's ``[C, ...]`` bytes;
- ``Sharded.traffic`` of a codec gossip round that nothing observes: no
  stack row lands on the lead and none is staged from it; what crosses is
  the payload rows (and stats) to the lead, the batches and mask rows out,
  and 2 x ``steps`` halo rows a shard shard to shard; an evaluated round
  lands the stack once, for the consensus, and its local evaluation
  stages no row;
- a shard whose decode or ring mix fails raises with its shard named;
- the lazy consensus: a round whose weights are all zero, evaluated, gives
  the eager one-shard run's consensus, collapsed once instead of every
  round;
- the port's serverless gossip on 4 CPU devices against JAX's
  ``FedEngine`` on 4 of the conftest's virtual CPU devices, at the
  tolerances of the server-mode parity test of
  ``tests/test_torch_clients_axis.py``.
"""

import dataclasses
import filecmp

import numpy as np
import pytest
import torch

import test_torch_clients_axis as ca
from bcfl_tpu_torch.compression import CompressionConfig
from bcfl_tpu_torch.config import TopologyConfig
from bcfl_tpu_torch.data import client_batches
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


def _partition(C):
    half = tuple(range(C // 2))
    return FaultPlan(partition_groups=(half, tuple(range(C // 2, C))),
                     partition_rounds=(1,))


MODES = {
    "gossip-steps-1": dict(mode="serverless"),
    "gossip-steps-2": dict(mode="serverless",
                           topology=TopologyConfig(gossip_steps=2)),
    "steps-0-trimmed-mean": dict(mode="serverless", aggregator="trimmed_mean",
                                 topology=TopologyConfig(gossip_steps=0)),
    "no-codec": dict(mode="serverless",
                     compression=CompressionConfig(kind="none")),
    # a corrupted wire: each shard decodes its rows of the transported
    # payload, and the ledger fails the corrupted clients
    "corrupt-wire": dict(mode="serverless",
                         faults=FaultPlan(corrupt_prob=0.3)),
    # the transport runs on each shard's rows; the ledger fingerprints
    # them landed, transported again there
    "no-codec-corrupt-wire": dict(
        mode="serverless", compression=CompressionConfig(kind="none"),
        faults=FaultPlan(corrupt_prob=0.3)),
    "fused-chunk-of-2": dict(mode="serverless", rounds_per_dispatch=2,
                             eval_every=2),
    # the chunk's fingerprints of an uncompressed stack read it landed
    "no-codec-fused-chunk-of-2": dict(
        mode="serverless", rounds_per_dispatch=2, eval_every=2,
        compression=CompressionConfig(kind="none")),
    "bcfl-async": dict(mode="serverless", sync="async", async_buffer=2),
    # round 1 partitioned, round 2 heals
    "partition-and-heal": dict(mode="serverless",
                               topology=TopologyConfig(gossip_steps=0)),
    # a server partition span carries the stack too; RBLA's mean (LoRA at
    # heterogeneous ranks, server mode only) takes its fallback's rank
    # dims that no participant holds, so its consensus is not lazy
    "lora-hetero-ranks-partition": dict(
        mode="server", model="tiny-llama", task="causal_lm"),
}


def _cfg(case, clients):
    kw = dict(MODES[case], num_clients=clients, num_rounds=ROUNDS)
    if case.startswith("partition") or case.startswith("lora"):
        kw["faults"] = _partition(clients)
    if case.startswith("lora"):
        kw["lora_ranks"] = ",".join(["2", "4"] * (clients // 2))
    if clients > 4:
        kw["max_local_batches"] = 1
    return ca._cfg(**kw)


def _run(cfg, devices, **engine_kw):
    """``cfg`` through the engine on ``devices`` with every round's payload,
    per-client stats and a fused chunk's device auth rows captured:
    ``(engine, taps, result)``."""
    eng = FedEngine(cfg, devices=devices, **engine_kw)
    taps = {"payloads": [], "stats": [], "kept": [], "device_auth": []}
    check, to_rec, evaluate, read = (eng._check_payload, eng._stats_to_rec,
                                     eng._maybe_eval, eng._read_chunk)

    def tap_read(out):
        rows = read(out)
        taps["device_auth"].extend(rows.get("auth", np.zeros(0)).tolist())
        return rows

    def tap_eval(rnd, rec, trainable, stacked):
        # the form the stacked state had at each round's end
        taps["kept"].append(type(stacked).__name__)
        return evaluate(rnd, rec, trainable, stacked)

    def tap_payload(payload):
        taps["payloads"].append({p: {k: v.clone() for k, v in parts.items()}
                                 for p, parts in payload.items()})
        return check(payload)

    def tap_stats(rnd, st):
        taps["stats"].append(torch.as_tensor(np.asarray(
            st.double() if isinstance(st, torch.Tensor) else st)))
        return to_rec(rnd, st)

    eng._check_payload, eng._stats_to_rec = tap_payload, tap_stats
    eng._maybe_eval, eng._read_chunk = tap_eval, tap_read
    return eng, taps, eng.run()


def _assert_same_runs(one, four):
    """The four-shard run against the one-shard run: the consensus, the
    gathered stack, every round's payload, the per-client stats, the
    residual, the ledger and every field of every record but the walls."""
    (e1, t1, r1), (e4, t4, r4) = one, four
    assert len(e4.local_train.bodies) > 1 == len(e1.local_train.bodies)
    assert t4["kept"] == [k.replace("dict", "Stacked")
                          for k in t1["kept"]]
    assert "Stacked" in t4["kept"]
    for p, x in r1.trainable.items():
        assert ca._same(r4.trainable[p], x), p
    _assert_same_stacks(r1.stacked, r4.stacked)
    codec = e1._comp is not None
    assert len(t1["payloads"]) == len(t4["payloads"]) == (
        len(r1.metrics.rounds) if codec else 0)
    for a, b in zip(t1["payloads"], t4["payloads"]):
        assert a.keys() == b.keys()
        for p in a:
            for k in a[p]:
                assert ca._same(b[p][k], a[p][k]), (p, k)
    assert t1["device_auth"] == t4["device_auth"]
    assert len(t1["stats"]) == len(t4["stats"]) == len(r1.metrics.rounds)
    for a, b in zip(t1["stats"], t4["stats"]):
        assert ca._same(b, a)
    if codec:
        for p, x in r1.ef_residual.items():
            assert ca._same(r4.ef_residual[p], x), p
    assert r1.ledger.to_json() == r4.ledger.to_json()
    assert r1.ledger.head == r4.ledger.head
    rec1 = [dataclasses.asdict(r) for r in r1.metrics.rounds]
    rec4 = [dataclasses.asdict(r) for r in r4.metrics.rounds]
    for a, b in zip(rec1, rec4):
        for k in ("wall_s", "wall_chunk_s"):
            a.pop(k), b.pop(k)
        assert a == b


def _assert_same_stacks(a, b):
    a, b = cs.gathered(a), cs.gathered(b)
    if a is None or b is None:
        assert a is b
        return
    assert list(a) == list(b)
    for p, x in a.items():
        assert ca._same(b[p], x), p


@pytest.mark.parametrize("clients", [4, 10], ids=["4-shards-of-1",
                                                  "2-shards-of-5"])
@pytest.mark.parametrize("case", list(MODES), ids=list(MODES))
def test_every_stacked_mode_on_shards_equals_one_shard(case, clients):
    cfg = _cfg(case, clients)
    one = _run(cfg, ["cpu"])
    four = _run(cfg, ["cpu"] * 4)
    _assert_same_runs(one, four)
    e4, r4 = four[0], four[2]
    sh = e4.local_train
    assert len(sh.bodies) == (4 if clients == 4 else 2)
    if cfg.mode == "server":  # the span's heal returned to a global
        assert r4.stacked is None
        return
    assert len(r4.stacked.rows) == len(sh.bodies)
    for s, rows in enumerate(r4.stacked.rows):
        assert all(x.shape[0] == sh.per_device for x in rows.values()), s
    if case.startswith("partition") or case.startswith("lora"):
        assert r4.metrics.rounds[1].partition is not None
        assert r4.metrics.rounds[2].healed
    if "fused" in case:
        assert [r.fused for r in r4.metrics.rounds] == [True, True, False]
    if "corrupt" in case:  # the wire did corrupt, and the ledger saw it
        assert any(0.0 in r.auth for r in r4.metrics.rounds)


@pytest.mark.parametrize("comp", ["int8+topk", "none"])
def test_fused_tamper_chunk_on_four_shards_equals_one_shard(comp):
    """A serverless chunk of 2 under ``fused_tamper`` (client 2 in round
    1): the device's auth rows, the records' auth, the ledger head, the
    gathered stack and the consensus on four CPU shards equal one
    shard's bit for bit, and exactly the corrupted client fails."""
    C = 4

    def tamper(rnd):
        return (np.array([0.0, 0.0, 1e6, 0.0], np.float32)
                if rnd == 1 else None)

    cfg = ca._cfg(mode="serverless", num_rounds=2, rounds_per_dispatch=2,
                  eval_every=2, compression=CompressionConfig(kind=comp))
    runs = []
    for devices in (["cpu"], ["cpu"] * C):
        with pytest.warns(DeprecationWarning):
            runs.append(_run(cfg, devices, fused_tamper=tamper))
    _assert_same_runs(*runs)
    want = [[1.0] * C, [1.0, 1.0, 0.0, 1.0]]
    (_, t4, r4) = runs[1]
    assert [r.auth for r in r4.metrics.rounds] == want == t4["device_auth"]
    assert [r.fused for r in r4.metrics.rounds] == [True, True]
    assert r4.ledger.verify_chain() == -1


@pytest.mark.parametrize("shards", [4, 1])
def test_four_shard_stack_resumes_on_four_or_one(tmp_path, shards):
    cfg = ca._cfg(mode="serverless", num_rounds=ROUNDS, eval_every=0)
    ref = FedEngine(cfg, devices=["cpu"] * 4).run()
    one_dir, crash_dir = tmp_path / "one", tmp_path / "crash"
    FedEngine(cfg.replace(checkpoint_dir=str(one_dir), checkpoint_every=1),
              devices=["cpu"]).run()
    crash = cfg.replace(
        checkpoint_dir=str(crash_dir), checkpoint_every=1,
        faults=FaultPlan(crash_at_round=2))
    with pytest.raises(SimulatedCrash):
        FedEngine(crash, devices=["cpu"] * 4).run()
    # the four shards' checkpoint holds the one-shard run's bytes
    name = "round_000001"
    cmp = filecmp.dircmp(crash_dir / name, one_dir / name)
    assert cmp.left_list == cmp.right_list and not cmp.diff_files
    _, mismatch, errors = filecmp.cmpfiles(
        crash_dir / name, one_dir / name, cmp.left_list, shallow=False)
    assert not mismatch and not errors
    eng = FedEngine(crash, devices=["cpu"] * shards)
    res = eng.run(resume=True)
    assert [r.round for r in res.metrics.rounds] == [2]
    assert isinstance(res.stacked, cs.Stacked) == (shards > 1)
    for p, x in ref.trainable.items():
        assert ca._same(res.trainable[p], x), p
    _assert_same_stacks(ref.stacked, res.stacked)
    for p, x in ref.ef_residual.items():
        assert ca._same(res.ef_residual[p], x), p
    assert res.ledger.head == ref.ledger.head
    a, b = ref.metrics.rounds[2], res.metrics.rounds[0]
    assert (a.train_loss, a.local_acc, a.auth, a.mask) == (
        b.train_loss, b.local_acc, b.auth, b.mask)


class _Boom(RuntimeError):
    pass


@pytest.mark.parametrize("stage", ["decode", "mix"])
def test_a_failing_shard_names_itself(monkeypatch, stage):
    """A shard whose decode or ring mix fails raises with its shard named;
    nothing regathers the stack on the lead device instead."""
    cfg = ca._cfg(mode="serverless", num_rounds=1)
    eng = FedEngine(cfg, devices=["cpu"] * 4)
    calls = []
    target = "decode_recon" if stage == "decode" else "gossip_step_mix"
    fn = getattr(cs, target)
    # a decode a shard, a mix a leaf
    per_shard = 1 if stage == "decode" else len(eng.trainable0)

    def failing(*a, **k):
        calls.append(1)
        if len(calls) == 2 * per_shard + 1:  # shard 2's first call
            raise _Boom(f"shard 2's {stage} failed")
        return fn(*a, **k)

    monkeypatch.setattr(cs, target, failing)
    gathers = []
    gather = cs.Stacked.gather
    monkeypatch.setattr(cs.Stacked, "gather",
                        lambda self: gathers.append(1) or gather(self))
    with pytest.raises(_Boom) as err:
        eng.run()
    assert err.value.__notes__ == ["in client shard 2 on cpu"]
    assert not gathers


# ----------------------------------------------------------------- traffic


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree.values())


def _traffic_by_round(cfg):
    """The 4-shard run of ``cfg`` with ``Sharded.traffic`` read after each
    round (its evaluation and checkpoint included): per round, what moved
    in it."""
    eng = FedEngine(cfg, devices=["cpu"] * 4)
    marks = [dict(eng.local_train.traffic)]
    eng.run(on_round=lambda rec: marks.append(dict(eng.local_train.traffic)))
    return eng, [{k: b[k] - a[k] for k in b} for a, b in zip(marks,
                                                              marks[1:])]


@pytest.mark.parametrize("steps", [1, 2])
def test_an_unobserved_codec_round_moves_no_stack_row(steps):
    cfg = ca._cfg(mode="serverless", num_rounds=3, eval_every=0,
                  topology=TopologyConfig(gossip_steps=steps))
    eng, moved = _traffic_by_round(cfg)
    sh = eng.local_train
    shards, per, C = len(sh.bodies), sh.per_device, cfg.num_clients
    others = C - per  # the clients of shards 1-3
    row = _nbytes(eng.trainable0)
    batch = _nbytes({k: v[0] for k, v in eng._round_batches(1)[0].items()})
    stats, masks = 3 * 4, 3 * 4  # float32 [loss*n, correct, n]; 3 masks
    # round 1: nothing observes it (round 0 also broadcasts, round 2 is
    # the last and collapses the consensus)
    assert moved[1] == {
        "to_lead": others * (eng._wire_bytes_per_client + stats),
        "to_shards": others * (batch + masks),
        "shard_to_shard": 2 * steps * shards * row,
        # one process: nothing crosses a process boundary
        "process_sent": 0, "process_received": 0}
    # round 0: the stack's broadcast, the global once per other shard
    assert moved[0]["to_shards"] - moved[1]["to_shards"] == (
        (shards - 1) * row)
    # the last round lands the stack once, for the consensus
    assert moved[2]["to_lead"] - moved[1]["to_lead"] == others * row
    assert moved[2]["to_shards"] == moved[1]["to_shards"]


def test_an_evaluated_round_lands_the_stack_once_and_stages_no_row():
    cfg = ca._cfg(mode="serverless", num_rounds=2, eval_every=2)
    eng, moved = _traffic_by_round(cfg)
    sh = eng.local_train
    per, C = sh.per_device, cfg.num_clients
    others = C - per
    row = _nbytes(eng.trainable0)
    tb, _ = client_batches(eng.cache, eng.partitioner, C, 1, cfg.batch_size,
                           max_batches=cfg.max_local_batches, split="test")
    test_batch = sum(v[0].nbytes for v in tb.values())
    # round 1 against round 0, whose body moved the same bytes and which
    # also broadcast the global once per other shard
    extra = {k: moved[1][k] - moved[0][k] for k in moved[1]}
    assert extra == {
        # the stack once (the consensus), the evaluation's float32 stats
        "to_lead": others * (row + 3 * 4),
        # the test batches only: each client's row is on its shard
        "to_shards": others * test_batch - (len(sh.bodies) - 1) * row,
        "shard_to_shard": 0, "process_sent": 0, "process_received": 0}


# ------------------------------------------------------- lazy consensus


def test_lazy_consensus_of_an_all_zero_round_equals_the_eager_one(
        monkeypatch):
    """Round 1's weights are all zero and it is evaluated: its consensus
    is round 0's, which the four shards collapse only now (from round 0's
    stack, the round's start), once, where one shard collapses every
    round; both views are the same bits."""
    cfg = ca._cfg(mode="serverless", num_rounds=2, eval_every=2)
    collapse, calls = cs.collapse, []

    def counting(*a, **k):
        calls.append(1)
        return collapse(*a, **k)

    monkeypatch.setattr(cs, "collapse", counting)
    runs = {}
    for n in (1, 4):
        eng = FedEngine(cfg, devices=["cpu"] * n)
        part = eng._participation

        def zero_at_1(rnd, comps=None, part=part):
            gate = part(rnd, comps)
            if rnd == 1:
                gate = dict(gate, mask=np.zeros_like(gate["mask"]))
            return gate

        eng._participation = zero_at_1
        calls.clear()
        runs[n] = eng.run(), len(calls)
    (one, c1), (four, c4) = runs[1], runs[4]
    assert c1 == 2 and c4 == 1
    assert four.metrics.rounds[1].degraded and one.metrics.rounds[1].degraded
    for p, x in one.trainable.items():
        assert ca._same(four.trainable[p], x), p
    _assert_same_stacks(one.stacked, four.stacked)
    assert ([r.global_acc for r in one.metrics.rounds]
            == [r.global_acc for r in four.metrics.rounds])


# --------------------------------------------------- against JAX's mesh


def test_serverless_gossip_on_four_shards_matches_jax(monkeypatch):
    rounds = 2
    jres, teng, steps, _, _ = ca._against_jax(
        monkeypatch, dict(kind="int8+topk", topk_frac=1.0, stochastic=False),
        rounds, mode="serverless")
    tres = teng.run()
    assert isinstance(tres.stacked, cs.Stacked)
    for rj, rt in zip(jres.metrics.rounds, tres.metrics.rounds):
        for field in ("mask", "auth", "bytes_on_wire", "degraded"):
            assert getattr(rt, field) == getattr(rj, field), (rt.round, field)
        np.testing.assert_allclose(rt.train_loss, rj.train_loss, rtol=1e-4)
    assert tres.metrics.ledger["chain_ok"] == 1.0 == jres.metrics.ledger[
        "chain_ok"]
    assert len(tres.ledger) == len(jres.ledger) == 4 * rounds
    ca._assert_global_near_jax(jres, tres, steps, rounds)
