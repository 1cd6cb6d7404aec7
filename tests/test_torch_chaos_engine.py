"""PyTorch port (``bcfl_tpu_torch``): the engine under the fault plan, the
robust aggregators and reputation, beside the JAX engine.

Each case runs the JAX engine and the port's on the same configuration
from the JAX engine's initial parameters and batches, dropout off in both
(tiny-bert, float32 compute, no codec):

- server FedAvg under ``trimmed_mean`` with the ledger and reputation on:
  dropout, stragglers, transport corruption (the corrupted clients fail
  authentication), churn (a leave and a late join), and a two-component
  partition over rounds 1-2 that heals in round 3;
- serverless with the exact aggregate (``gossip_steps=0``) under
  ``median``, PageRank gating per component, a seeded two-way partition
  that heals, a flaky client driving reputation through quarantine and
  probation, and stragglers;
- server ``krum`` without the ledger, so corrupted updates reach the rule
  (at most ``f`` of them a round), with dropout.

The records (``mask``, ``dropped``, ``auth``, ``partition``, ``healed``,
``churn_alive``, ``reputation_state``, ``reputation_trust``,
``straggler_s``, ``anomalies``, ``degraded``, the information passing
times, bytes on the wire) equal the JAX engine's exactly, and so does the
reputation rollup; train losses agree at rtol 1e-4 and the final global
parameters within the tolerance of ``tests/test_torch_round.py`` per
round (``2 * lr * steps`` for every coordinate, all but 1e-4 of them
within 2e-6 at its learning rate of 5e-5, scaled with the learning rate).
"""

import numpy as np
import pytest
import torch

import jax

from bcfl_tpu.compression import codecs as jcc

STEPS, BATCH, SEQ = 1, 4, 16
LR = 5e-5
ATOL_NONE = 2e-6

RECORD_FIELDS = ("mask", "dropped", "auth", "partition", "healed",
                 "churn_alive", "reputation_state", "reputation_trust",
                 "straggler_s", "anomalies", "degraded",
                 "info_passing_sync_s", "info_passing_async_s",
                 "bytes_on_wire", "staleness", "async_alpha")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return {jcc._path_name(p): torch.from_numpy(np.array(x))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _configs(rounds, faults, reputation=None, ledger=False, topology=None,
             **kw):
    from bcfl_tpu.config import FedConfig as JCfg, LedgerConfig as JLed
    from bcfl_tpu.config import TopologyConfig as JTopo
    from bcfl_tpu.faults import FaultPlan as JPlan
    from bcfl_tpu.reputation import ReputationConfig as JRep
    from bcfl_tpu_torch.config import (FedConfig as TCfg, LedgerConfig as TLed,
                                       TopologyConfig as TTopo)
    from bcfl_tpu_torch.faults import FaultPlan as TPlan
    from bcfl_tpu_torch.reputation import ReputationConfig as TRep

    base = dict(name="chaos", model="tiny-bert", dataset="synthetic",
                num_labels=2, num_rounds=rounds, seq_len=SEQ,
                batch_size=BATCH, max_local_batches=STEPS, vocab_size=512,
                eval_every=0, compute_dtype="float32")
    base.update(kw)
    rep = reputation or {}
    topo = topology or {}
    j = JCfg(**base, faults=JPlan(**faults),
             reputation=JRep(enabled=bool(reputation), **rep),
             ledger=JLed(enabled=ledger, use_native=False),
             topology=JTopo(**topo))
    t = TCfg(**base, faults=TPlan(**faults),
             reputation=TRep(enabled=bool(reputation), **rep),
             ledger=TLed(enabled=ledger), topology=TTopo(**topo))
    return j, t


def run_pair(monkeypatch, jcfg, tcfg):
    """The JAX engine's run and the port's from the same start, batches and
    no dropout."""
    import bcfl_tpu.models as jmodels
    from bcfl_tpu.fed.engine import FedEngine as JEngine
    from bcfl_tpu_torch.fed.engine import FedEngine as TEngine

    build = jmodels.build
    monkeypatch.setattr(jmodels, "build",
                        lambda *a, **k: build(*a, dropout_rate=0.0, **k))
    jeng = JEngine(jcfg)
    teng = TEngine(tcfg, device="cpu")
    teng.trainable0 = _flat(jeng.trainable0)
    batches = {}

    def round_batches(rnd):
        if rnd not in batches:
            tree, n_ex = jeng._round_batches(rnd)
            batches[rnd] = ({k: torch.from_numpy(np.array(v))
                             for k, v in tree.items()}, np.asarray(n_ex))
        return batches[rnd]

    monkeypatch.setattr(teng, "_round_batches", round_batches)
    monkeypatch.setattr(teng, "_generators",
                        lambda rnd: [None] * tcfg.num_clients)
    return jeng.run(), teng.run()


def assert_same_records(jres, tres):
    assert len(tres.metrics.rounds) == len(jres.metrics.rounds)
    for rj, rt in zip(jres.metrics.rounds, tres.metrics.rounds):
        for field in RECORD_FIELDS:
            assert getattr(rt, field) == getattr(rj, field), (rt.round,
                                                              field)
        np.testing.assert_allclose(rt.train_loss, rj.train_loss, rtol=1e-4)
    assert tres.metrics.reputation == jres.metrics.reputation


def assert_params_close(jres, tres, rounds, lr=LR):
    # AdamW's step is lr * m / sqrt(v): the float32 noise it carries scales
    # with the learning rate, so the per-round atol does too
    atol = rounds * ATOL_NONE * lr / LR
    far = total = 0
    for p, x in _flat(jres.trainable).items():
        err = np.abs(tres.trainable[p].numpy() - x.numpy())
        assert err.max() <= rounds * 2 * lr * STEPS * 1.01, p
        if not p.endswith("/key/bias"):
            far += int((err > atol).sum())
            total += err.size
    assert far <= total * 1e-4, f"{far} of {total} coordinates past atol"


CASES = {
    "server-trimmed_mean": dict(
        rounds=5, mode="server", num_clients=4, aggregator="trimmed_mean",
        ledger=True, reputation=dict(quarantine_rounds=2),
        faults=dict(seed=3, dropout_prob=0.3, straggler_prob=0.5,
                    corrupt_prob=0.3, partition_groups=((0, 1), (2, 3)),
                    partition_rounds=(1, 2), churn_leave=((2, 4),),
                    churn_join=((3, 1),))),
    "serverless-median": dict(
        rounds=5, mode="serverless", num_clients=6, aggregator="median",
        ledger=True, reputation=dict(quarantine_rounds=1),
        topology=dict(anomaly_filter="pagerank", gossip_steps=0),
        faults=dict(seed=5, partition_count=2, partition_rounds=(1, 2),
                    flaky_clients=(4,), flaky_burst_len=2, flaky_on_prob=1.0,
                    straggler_prob=0.3, straggler_delay_s=3.0)),
    # krum selects by summed squared distances between whole updates; the
    # JAX package forms them as |a|^2 + |b|^2 - 2 a.b, which cancels at
    # the parameters' magnitude, the port from the differences. A learning
    # rate of 1e-3 puts the clients far enough apart that the JAX
    # package's rounding does not decide, so both select the same client.
    # The plan's seed keeps every round inside krum's guarantee
    # (1 <= corrupted <= f, k >= 2f + 3).
    "server-krum": dict(
        rounds=3, mode="server", num_clients=8, aggregator="krum",
        learning_rate=1e-3,
        faults=dict(seed=30, corrupt_prob=0.25, dropout_prob=0.15)),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_chaos_engine_matches_jax(monkeypatch, case):
    kw = dict(CASES[case])
    rounds = kw.pop("rounds")
    jcfg, tcfg = _configs(rounds, **kw)
    jres, tres = run_pair(monkeypatch, jcfg, tcfg)
    assert_same_records(jres, tres)
    assert_params_close(jres, tres, rounds, kw.get("learning_rate", LR))
    recs = tres.metrics.rounds
    if case == "server-trimmed_mean":
        # every lane fired: dropout, stragglers, auth failures, churn, the
        # span and its heal
        assert any(r.dropped for r in recs)
        assert any(r.straggler_s for r in recs)
        assert any(0.0 in r.auth for r in recs)
        assert [r.partition is not None for r in recs] == [
            False, True, True, False, False]
        assert [r.healed for r in recs] == [False, False, False, True, False]
        assert recs[0].churn_alive == [1.0, 1.0, 1.0, 0.0]
    elif case == "serverless-median":
        assert recs[3].healed and recs[1].partition is not None
        assert any(r.anomalies for r in recs[1:3])
        states = {s for r in recs for s in r.reputation_state}
        assert {"quarantined", "probation"} <= states
    else:
        # no ledger: the corrupted updates reached krum, which left them out
        for p, x in tres.trainable.items():
            assert bool(torch.isfinite(x).all()), p
        assert float(max(x.abs().max() for x in tres.trainable.values())) < 1e3


# ------------------------------------------------ the legacy tamper hooks


def _tamper_client(c):
    def tamper(rnd, host):
        out = {p: x.clone() for p, x in host.items()}
        p = sorted(out)[0]
        out[p][c].view(-1)[0] += 1.0
        return out
    return tamper


@pytest.mark.parametrize("kw", [
    dict(mode="server"), dict(mode="serverless"),
    dict(mode="serverless", faithful=True)],
    ids=["server", "serverless", "faithful"])
def test_tamper_hook_fails_exactly_the_tampered_client(kw):
    """``tamper_hook`` tampers the host trees the ledger hashes byte by
    byte (the full byte-hash flow): only the tampered client fails
    authentication and leaves the aggregate."""
    from bcfl_tpu_torch.config import FedConfig, LedgerConfig
    from bcfl_tpu_torch.fed.engine import FedEngine

    cfg = FedConfig(model="tiny-bert", num_clients=3, num_rounds=2,
                    seq_len=SEQ, batch_size=BATCH, max_local_batches=STEPS,
                    vocab_size=512, eval_every=0,
                    ledger=LedgerConfig(enabled=True), **kw)
    with pytest.warns(DeprecationWarning):
        eng = FedEngine(cfg, device="cpu", tamper_hook=_tamper_client(1))
    res = eng.run()
    assert [r.auth for r in res.metrics.rounds] == [[1.0, 0.0, 1.0]] * 2
    assert res.metrics.ledger["chain_ok"] == 1.0
    assert len(res.ledger) == 6


def test_tamper_hook_and_fused_tamper_guards():
    from bcfl_tpu_torch.compression import CompressionConfig
    from bcfl_tpu_torch.config import FedConfig
    from bcfl_tpu_torch.faults import FaultPlan
    from bcfl_tpu_torch.fed.engine import FedEngine

    cfg = FedConfig(model="tiny-bert", num_clients=3, num_rounds=1,
                    seq_len=SEQ, batch_size=BATCH, max_local_batches=STEPS,
                    vocab_size=512, eval_every=0)
    with pytest.warns(DeprecationWarning), pytest.raises(
            ValueError, match="compression enabled"):
        FedEngine(cfg.replace(compression=CompressionConfig(kind="int8")),
                  device="cpu", tamper_hook=_tamper_client(0))
    with pytest.warns(DeprecationWarning), pytest.raises(
            ValueError, match="pick one"):
        FedEngine(cfg.replace(faults=FaultPlan(corrupt_prob=0.5)),
                  device="cpu", tamper_hook=_tamper_client(0))
    with pytest.warns(DeprecationWarning):
        eng = FedEngine(cfg, device="cpu",
                        fused_tamper=lambda rnd: np.ones(3, np.float32))
    with pytest.raises(ValueError, match="per-round path"):
        eng.run()
