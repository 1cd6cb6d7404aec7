"""PyTorch port (``bcfl_tpu_torch``): the fused multi-round dispatch
(``rounds_per_dispatch > 1``).

A chunk of k rounds issues every round's device work with no read-back,
reads the chunk's stats (and, with the ledger, its commit and received
fingerprints and the device's auth) back in one transfer, and only then
builds the records, commits and authenticates the chain, evaluates and
checkpoints. The cases, each a twin of a JAX test
(``tests/test_engine.py``, ``tests/test_compression.py``,
``tests/test_fed_tp.py``):

- a clean fused run equals the per-round run of the same configuration bit
  for bit, in server and serverless mode, with and without ``int8+topk``
  and the ledger: the global tree (serverless: the stacked tree and the
  consensus at every evaluation), the error-feedback residual, every
  round's payload bytes, every ledger entry and the head, the per-client
  stats and the evaluations (rounds 1 and 3 of 4 at ``eval_every=2``);
  also on a resampled partition, with the lazy consensus at
  ``eval_every=0``, on four CPU client shards against one, and for
  tiny-llama LoRA at ``tp=2`` in serverless mode; ``mix_recv`` of the
  tree that was sent (JAX's fused gossip) is ``mix`` bit for bit;
- ``_chunk_rounds`` gives JAX's answers on JAX's cases and on a fault
  plan, reputation and cohort sampling;
- no record is built before a chunk's last round is issued;
- ``fused_tamper``: exactly the corrupted client fails authentication in
  exactly its round, the chain verifies, the device's auth is the
  chain's, every leaf stays finite and small, and the run matches JAX's
  fused engine from the same start and batches (dropout off) at the
  tolerances of ``tests/test_torch_clients_axis.py``;
- the records carry ``fused`` and ``wall_chunk_s``; the checkpoint at a
  chunk's end is the per-round run's, byte for byte, and a resume from it
  ends where the uninterrupted fused run ends.
"""

import dataclasses
import filecmp
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from bcfl_tpu.compression import codecs as jcc
from bcfl_tpu_torch.compression import CompressionConfig
from bcfl_tpu_torch.config import (FedConfig, LedgerConfig, PartitionConfig,
                                   TopologyConfig)
from bcfl_tpu_torch.fed import client_step as cs
from bcfl_tpu_torch.fed.engine import FedEngine

STEPS, BATCH, SEQ = 2, 4, 16
LR = 5e-5
ATOL_NONE = 2e-6
TIMING = ("wall_s", "fused", "wall_chunk_s")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several test workers with a thread per core each oversubscribe the
    # host; the runs compared here share the setting
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    base = dict(name="fused", model="tiny-bert", dataset="synthetic",
                num_labels=2, num_clients=4, num_rounds=4, seq_len=SEQ,
                batch_size=BATCH, max_local_batches=1, vocab_size=512,
                eval_every=2, compute_dtype="float32",
                partition=PartitionConfig(kind="iid", iid_samples=16))
    base.update(kw)
    return FedConfig(**base)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


def _tapped(cfg, devices=("cpu",), **kw):
    """``cfg``'s run on ``devices`` with every round's payload, per-client
    stats and every evaluation's trees (the global or consensus, and the
    stacked tree) captured. Returns ``(result, taps)``."""
    eng = FedEngine(cfg, devices=list(devices), **kw)
    taps = {"payloads": [], "stats": [], "evals": []}
    check, to_rec, evaluate = (eng._check_payload, eng._stats_to_rec,
                               eng._maybe_eval)

    def tap_payload(payload):
        taps["payloads"].append({p: {k: v.clone() for k, v in parts.items()}
                                 for p, parts in payload.items()})
        return check(payload)

    def tap_stats(rnd, st):
        taps["stats"].append(np.array(st.double() if isinstance(
            st, torch.Tensor) else st, np.float64))
        return to_rec(rnd, st)

    def tap_eval(rnd, rec, trainable, stacked):
        evaluate(rnd, rec, trainable, stacked)
        if rec.global_acc is not None:
            # a stack on several client shards lands for the comparison
            taps["evals"].append((rnd, dict(trainable), None if stacked is None
                                  else dict(cs.gathered(stacked))))

    eng._check_payload, eng._stats_to_rec = tap_payload, tap_stats
    eng._maybe_eval = tap_eval
    return eng.run(), taps


def _record(r):
    # a chunk reads the adapters' effective rank at its end only
    return {k: v for k, v in dataclasses.asdict(r).items()
            if k not in TIMING + ("effective_rank",)}


def _assert_same_runs(a, b):
    """Two tapped runs: the same bits everywhere a run leaves them."""
    (ra, ta), (rb, tb) = a, b
    for p, x in ra.trainable.items():
        assert _same(rb.trainable[p], x), p
    if ra.ef_residual is not None:
        for p, x in ra.ef_residual.items():
            assert _same(rb.ef_residual[p], x), p
    assert len(ta["payloads"]) == len(tb["payloads"])
    for pa, pb in zip(ta["payloads"], tb["payloads"]):
        for p, parts in pa.items():
            for k, v in parts.items():
                assert _same(pb[p][k], v), (p, k)
    assert len(ta["stats"]) == len(tb["stats"])
    for sa, sb in zip(ta["stats"], tb["stats"]):
        assert np.array_equal(sa, sb)
    assert [e[0] for e in ta["evals"]] == [e[0] for e in tb["evals"]]
    for (_, ga, sa), (_, gb, sb) in zip(ta["evals"], tb["evals"]):
        for p, x in ga.items():
            assert _same(gb[p], x), p
        if sa is not None:
            for p, x in sa.items():
                assert _same(sb[p], x), p
    assert ([_record(r) for r in ra.metrics.rounds]
            == [_record(r) for r in rb.metrics.rounds])
    assert (ra.metrics.rounds[-1].effective_rank
            == rb.metrics.rounds[-1].effective_rank)
    if ra.ledger is not None:
        assert rb.ledger.to_json() == ra.ledger.to_json()
        assert rb.ledger.head == ra.ledger.head


# ---------------------------------------------------- bits against per-round


BITS = [(mode, comp, ledger) for mode in ("server", "serverless")
        for comp in ("none", "int8+topk") for ledger in (False, True)]


@pytest.mark.parametrize("mode,comp,ledger", BITS,
                         ids=[f"{m}-{c}-{'ledger' if l else 'plain'}"
                              for m, c, l in BITS])
def test_fused_run_equals_per_round_run(mode, comp, ledger):
    """JAX ``test_rounds_per_dispatch_matches_per_round_path`` and its
    serverless, ledger and codec twins; the port's chunk runs the per-round
    ops in the same order, so the bound is bit identity, not JAX's atol
    1e-5."""
    cfg = _cfg(mode=mode, compression=CompressionConfig(kind=comp),
               ledger=LedgerConfig(enabled=ledger))
    per = _tapped(cfg)
    fused = _tapped(cfg.replace(rounds_per_dispatch=4))
    _assert_same_runs(per, fused)
    res = fused[0]
    assert [r.round for r in res.metrics.rounds
            if r.global_acc is not None] == [1, 3]
    assert [e[0] for e in fused[1]["evals"]] == [1, 3]
    assert all(r.fused and r.wall_chunk_s is not None
               for r in res.metrics.rounds)
    if ledger:
        assert len(res.ledger) == 4 * cfg.num_clients
        assert res.ledger.verify_chain() == -1
        assert res.metrics.ledger["chain_ok"] == 1.0
        assert all(r.auth == [1.0] * cfg.num_clients
                   for r in res.metrics.rounds)


@pytest.mark.parametrize("steps", [0, 1, 2])
def test_mix_recv_of_what_was_sent_is_mix(steps):
    """A clean fused gossip round mixes with ``mix`` (the per-round path's
    choice) where JAX's fused program calls ``mix_recv``: with the
    received tree the sent one, the two give the same bits, a masked
    client included."""
    g = torch.Generator().manual_seed(steps)
    tree = {"a": torch.randn((5, 3, 4), generator=g),
            "b": torch.randn((5, 7), generator=g)}
    fallback = {p: torch.randn(x.shape[1:], generator=g)
                for p, x in tree.items()}
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0, 1.0])
    want = cs.mix(tree, mask, fallback, 0.5, steps)
    got = cs.mix_recv(tree, tree, mask, fallback, 0.5, steps)
    for p, x in want.items():
        assert _same(got[p], x), p


def test_resampled_partition_fuses_bit_identically():
    """JAX ``test_rounds_per_dispatch_resampled_partition``: each round of
    the chunk draws its own batches."""
    cfg = _cfg(mode="server", num_rounds=2,
               partition=PartitionConfig(kind="iid", iid_samples=16,
                                         resample_each_round=True),
               compression=CompressionConfig(kind="int8+topk"))
    _assert_same_runs(_tapped(cfg),
                      _tapped(cfg.replace(rounds_per_dispatch=2)))


def test_serverless_lazy_consensus_at_eval_every_0(monkeypatch):
    """JAX ``test_serverless_chunk_lazy_consensus_end_of_run``: with
    evaluation and checkpoints off the chunks collapse no consensus until
    the run's last round, and the run ends on the per-round run's bits."""
    cfg = _cfg(mode="serverless", eval_every=0)
    per = FedEngine(cfg, device="cpu").run()
    collapses = []
    collapse = cs.collapse

    def counting(*a, **k):
        collapses.append(1)
        return collapse(*a, **k)

    monkeypatch.setattr(cs, "collapse", counting)
    fused = FedEngine(cfg.replace(rounds_per_dispatch=2), device="cpu").run()
    assert len(collapses) == 1  # the second chunk's end, the run's last
    for p, x in per.trainable.items():
        assert _same(fused.trainable[p], x), p


# ----------------------------------------------------------- eligibility


def _plan(**kw):
    from bcfl_tpu.faults import FaultPlan as JPlan
    from bcfl_tpu_torch.faults import FaultPlan
    return {"port": FaultPlan(**kw), "jax": JPlan(**kw)}


def _reputation(**kw):
    from bcfl_tpu.reputation import ReputationConfig as JRep
    from bcfl_tpu_torch.reputation import ReputationConfig
    return {"port": ReputationConfig(**kw), "jax": JRep(**kw)}


ELIGIBILITY = [
    # JAX's cases (tests/test_engine.py), then a fault plan, reputation and
    # cohort sampling
    ("serverless-bounded", dict(mode="serverless", num_rounds=2,
                                rounds_per_dispatch=8, eval_every=2),
     [0], [2]),
    ("faithful", dict(mode="serverless", num_rounds=2, rounds_per_dispatch=8,
                      faithful=True), [0], [1]),
    ("ledger-eval-every-1", dict(mode="server", num_rounds=2,
                                 rounds_per_dispatch=8,
                                 ledger=LedgerConfig(enabled=True)),
     [0], [1]),
    ("pagerank", dict(mode="server", num_clients=10, num_rounds=2,
                      rounds_per_dispatch=8,
                      topology=TopologyConfig(anomaly_filter="pagerank")),
     [0], [1]),
    ("eval-boundary", dict(mode="server", num_rounds=3,
                           rounds_per_dispatch=8, eval_every=2),
     [0, 2], [2, 1]),
    ("checkpoint-boundary", dict(mode="server", num_rounds=6,
                                 rounds_per_dispatch=8, eval_every=0,
                                 checkpoint_dir="ck", checkpoint_every=4),
     [0, 1, 4], [4, 3, 2]),
    ("async", dict(mode="server", sync="async", async_buffer=2,
                   num_rounds=4, rounds_per_dispatch=4, eval_every=0),
     [0], [1]),
    ("fault-plan", dict(mode="server", num_rounds=4, rounds_per_dispatch=4,
                        eval_every=0, faults=_plan(dropout_prob=0.25)),
     [0], [1]),
    ("reputation", dict(mode="server", num_rounds=4, rounds_per_dispatch=4,
                        eval_every=0,
                        reputation=_reputation(enabled=True)),
     [0], [1]),
    ("cohort", dict(mode="server", num_rounds=4, rounds_per_dispatch=4,
                    eval_every=0, registry_size=8, sample_clients=4),
     [0], [1]),
]


@pytest.mark.parametrize("name,kw,rounds,want", ELIGIBILITY,
                         ids=[e[0] for e in ELIGIBILITY])
def test_chunk_rounds_matches_jax(name, kw, rounds, want):
    """JAX ``test_rounds_per_dispatch_ineligible_configs_fall_back``, and
    the per-round fallbacks JAX's ``_chunk_rounds`` gives a fault plan,
    reputation and cohort sampling."""
    from bcfl_tpu.config import (FedConfig as JCfg, LedgerConfig as JLed,
                                 PartitionConfig as JPart,
                                 TopologyConfig as JTopo)
    from bcfl_tpu.fed.engine import FedEngine as JEngine

    def side(pkg, v):
        if isinstance(v, dict):
            return v[pkg]
        if pkg == "jax" and isinstance(v, LedgerConfig):
            return JLed(enabled=v.enabled, use_native=False)
        if pkg == "jax" and isinstance(v, TopologyConfig):
            return JTopo(anomaly_filter=v.anomaly_filter)
        return v

    base = dict(dataset="synthetic", num_labels=2, seq_len=SEQ,
                batch_size=BATCH, vocab_size=512, model="tiny-bert",
                num_clients=4, max_local_batches=1)
    tcfg = FedConfig(**{**base, **{k: side("port", v)
                                   for k, v in kw.items()}},
                     partition=PartitionConfig(kind="iid", iid_samples=16))
    jcfg = JCfg(**{**base, **{k: side("jax", v) for k, v in kw.items()}},
                partition=JPart(kind="iid", iid_samples=16))
    teng, jeng = FedEngine(tcfg, device="cpu"), JEngine(jcfg)
    got = [teng._chunk_rounds(r) for r in rounds]
    assert got == [jeng._chunk_rounds(r) for r in rounds] == want


# ------------------------------------------------------- one read-back


def test_no_record_before_the_chunk_is_issued():
    """In a chunk of 4 every client's local round of every round is issued
    before the first record is built (the stats are read once, after the
    chunk); the per-round path builds a record every round."""

    def order(cfg):
        eng = FedEngine(cfg, device="cpu")
        events = []
        body, to_rec = eng.local_train.bodies[0], eng._stats_to_rec

        def train(*a):
            events.append("train")
            return body(*a)

        def rec(rnd, st):
            events.append(f"rec {rnd}")
            return to_rec(rnd, st)

        eng.local_train.bodies[0], eng._stats_to_rec = train, rec
        eng.run()
        return events

    cfg = _cfg(mode="server", eval_every=0,
               ledger=LedgerConfig(enabled=True),
               compression=CompressionConfig(kind="int8+topk"))
    C = cfg.num_clients
    assert order(cfg.replace(rounds_per_dispatch=4)) == (
        ["train"] * 4 * C + [f"rec {r}" for r in range(4)])
    assert order(cfg) == sum(
        (["train"] * C + [f"rec {r}"] for r in range(4)), [])


# ------------------------------------------------------------ fused_tamper


def _flat(tree):
    return {jcc._path_name(p): torch.from_numpy(np.array(x))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tamper_pair(monkeypatch, mode, comp, schedule, ledger=True,
                 aggregator="mean", gossip_steps=1, lr=LR):
    """The port's fused engine beside JAX's under the same
    ``fused_tamper`` schedule, from JAX's initial parameters and batches,
    dropout off, the ledger on unless ``ledger`` is False, the
    ``aggregator``, ``gossip_steps`` and learning rate given, 2 rounds in
    one chunk.
    Returns ``(JAX result, port result, device auth rows, per-leaf sum
    over rounds of the largest quantization scale)``."""
    import bcfl_tpu.models as jmodels
    from bcfl_tpu.compression import CompressionConfig as JComp
    from bcfl_tpu.config import (FedConfig as JCfg, LedgerConfig as JLed,
                                 TopologyConfig as JTopo)
    from bcfl_tpu.fed.engine import FedEngine as JEngine

    kw = dict(name="fused-tamper", model="tiny-bert", dataset="synthetic",
              num_labels=2, mode=mode, num_clients=4, num_rounds=2,
              seq_len=SEQ, batch_size=BATCH, max_local_batches=STEPS,
              vocab_size=512, eval_every=2, rounds_per_dispatch=2,
              compute_dtype="float32", aggregator=aggregator,
              learning_rate=lr)
    jcfg = JCfg(**kw, compression=JComp(**comp),
                ledger=JLed(enabled=ledger, use_native=False),
                topology=JTopo(gossip_steps=gossip_steps))
    tcfg = FedConfig(**kw, compression=CompressionConfig(**comp),
                     ledger=LedgerConfig(enabled=ledger),
                     topology=TopologyConfig(gossip_steps=gossip_steps))
    build = jmodels.build
    monkeypatch.setattr(jmodels, "build",
                        lambda *a, **k: build(*a, dropout_rate=0.0, **k))
    with pytest.warns(DeprecationWarning):
        jeng = JEngine(jcfg, fused_tamper=schedule)
    assert jeng._chunk_rounds(0) == 2
    jres = jeng.run()
    with pytest.warns(DeprecationWarning):
        teng = FedEngine(tcfg, device="cpu", fused_tamper=schedule)
    assert teng._chunk_rounds(0) == 2
    teng.trainable0 = _flat(jeng.trainable0)
    batches = {}

    def round_batches(rnd):
        if rnd not in batches:
            tree, n_ex = jeng._round_batches(rnd)
            batches[rnd] = ({k: torch.from_numpy(np.array(v))
                             for k, v in tree.items()}, np.asarray(n_ex))
        return batches[rnd]

    monkeypatch.setattr(teng, "_round_batches", round_batches)
    monkeypatch.setattr(teng, "_generators", lambda rnd: [None] * 4)
    steps, device_auth = {}, []
    check, read = teng._check_payload, teng._read_chunk

    def recording(payload):
        for p, parts in payload.items():
            steps[p] = steps.get(p, 0.0) + float(parts["s"].max())
        return check(payload)

    def reading(out):
        rows = read(out)
        if "auth" in rows:
            device_auth.extend(rows["auth"].tolist())
        return rows

    monkeypatch.setattr(teng, "_check_payload", recording)
    monkeypatch.setattr(teng, "_read_chunk", reading)
    return jres, teng.run(), device_auth, steps


def _assert_near_jax(jres, tres, steps, rounds, lr=LR):
    """The final global within ``2 * lr * steps`` a round plus the sum of
    the rounds' largest quantization steps everywhere, and all but 1e-4
    of the coordinates within 2e-6 a round plus that step (the
    tolerance of ``tests/test_torch_clients_axis.py``; both bounds in
    proportion to ``lr`` against its 5e-5)."""
    far = total = 0
    for p, x in _flat(jres.trainable).items():
        err = np.abs(tres.trainable[p].numpy() - x.numpy())
        step = steps.get(p, 0.0)
        assert err.max() <= rounds * 2 * lr * STEPS * 1.01 + step, p
        if not p.endswith("/key/bias"):
            far += int((err > rounds * ATOL_NONE * lr / LR + step).sum())
            total += err.size
    assert far <= total * 1e-4, f"{far} of {total} coordinates past atol"


TAMPER = [
    # JAX test_ledger_fused_transport_corruption_fails_auth: client 1 in
    # round 1; test_ledger_fused_serverless_corruption_fails_auth: client 0
    # in round 0; test_compression's test_chaos_ledger_auth_fused_path:
    # client 2 in round 1 of an int8+topk chunk
    ("server", dict(kind="none"), 1, 1),
    ("serverless", dict(kind="none"), 0, 0),
    ("server", dict(kind="int8+topk", topk_frac=1.0, stochastic=False), 1, 2),
]


@pytest.mark.parametrize("mode,comp,rnd,client", TAMPER,
                         ids=["server", "serverless", "server-int8+topk"])
def test_fused_tamper_fails_exactly_the_corrupted_client(
        monkeypatch, mode, comp, rnd, client):
    C = 4

    def schedule(r):
        if r != rnd:
            return None
        row = np.zeros((C,), np.float32)
        row[client] = 1e6
        return row

    jres, tres, device_auth, steps = _tamper_pair(monkeypatch, mode, comp,
                                                  schedule)
    want = [[1.0] * C for _ in range(2)]
    want[rnd][client] = 0.0
    assert [r.auth for r in tres.metrics.rounds] == want
    assert [r.auth for r in jres.metrics.rounds] == want
    assert device_auth == want  # the gate the chunk applied on the device
    assert tres.ledger.verify_chain() == -1
    assert len(tres.ledger) == len(jres.ledger) == 2 * C
    assert all(bool(torch.isfinite(x).all()) and float(x.abs().max()) < 1e3
               for x in tres.trainable.values())
    for rj, rt in zip(jres.metrics.rounds, tres.metrics.rounds):
        assert (rt.mask, rt.fused, rt.bytes_on_wire) == (
            rj.mask, rj.fused, rj.bytes_on_wire)
        np.testing.assert_allclose(rt.train_loss, rj.train_loss, rtol=1e-4)
    _assert_near_jax(jres, tres, steps, 2)


def test_fused_tamper_int8_topk_chunk_of_three():
    """JAX ``test_chaos_ledger_auth_fused_path`` at its own codec
    (``int8+topk`` at top-k 0.1, stochastic rounding): the payload
    fingerprints catch the corruption of client 2 in round 1, and the
    chunk's clean rounds still authenticate."""

    def tamper(rnd):
        return (np.array([0.0, 0.0, 1e6, 0.0], np.float32)
                if rnd == 1 else None)

    cfg = _cfg(num_rounds=3, rounds_per_dispatch=3, eval_every=3,
               partition=PartitionConfig(kind="iid", iid_samples=8),
               compression=CompressionConfig(kind="int8+topk",
                                             topk_frac=0.1),
               ledger=LedgerConfig(enabled=True))
    with pytest.warns(DeprecationWarning):
        eng = FedEngine(cfg, device="cpu", fused_tamper=tamper)
    res = eng.run()
    assert res.metrics.rounds[0].auth == [1.0, 1.0, 1.0, 1.0]
    assert res.metrics.rounds[1].auth == [1.0, 1.0, 0.0, 1.0]
    assert res.metrics.rounds[2].auth == [1.0, 1.0, 1.0, 1.0]
    assert res.ledger.verify_chain() == -1


def test_cli_fused_tamper_reaches_a_fused_chunk(capsys):
    """``--rounds-per-dispatch`` and ``--fused-tamper`` on the command line:
    the corrupted client is reported as failing authentication."""
    from bcfl_tpu_torch.entrypoints.__main__ import main

    assert main(["--preset", "smoke", "--device", "cpu", "--clients", "4",
                 "--rounds", "2", "--seq-len", "16", "--max-local-batches",
                 "1", "--ledger",
                 "--rounds-per-dispatch", "2", "--eval-every", "2",
                 "--fused-tamper", "1:2:5"]) == 0
    out = capsys.readouterr().out
    assert "round   1:" in out and "auth_failed=[2]" in out
    assert "(fused, chunk" in out


# ------------------------------------------------ robust rules in a chunk


ROBUST = [(rule, mode, ledger) for rule in ("trimmed_mean", "median", "krum")
          for mode in ("server", "serverless") for ledger in (False, True)]


@pytest.mark.parametrize("rule,mode,ledger", ROBUST,
                         ids=[f"{r}-{m}-{'ledger' if l else 'plain'}"
                              for r, m, l in ROBUST])
def test_robust_chunk_equals_per_round_run(rule, mode, ledger):
    """A chunk of 2 rounds under a robust rule (server FedAvg, and
    serverless at ``gossip_steps=0``, whose exact aggregate is the rule)
    with ``int8+topk`` equals the per-round run bit for bit, every round's
    payload, the ledger and the evaluations included; the serverless
    chunk also on four CPU client shards (the stack on its shards, the
    rule's one reduction over the rows landed in client order)."""
    cfg = _cfg(mode=mode, aggregator=rule,
               topology=TopologyConfig(gossip_steps=0),
               compression=CompressionConfig(kind="int8+topk"),
               ledger=LedgerConfig(enabled=ledger))
    per = _tapped(cfg)
    fused_cfg = cfg.replace(rounds_per_dispatch=4)
    fused = _tapped(fused_cfg)
    _assert_same_runs(per, fused)
    assert all(r.fused for r in fused[0].metrics.rounds)
    if mode == "serverless":
        four = _tapped(fused_cfg, devices=["cpu"] * 4)
        assert isinstance(four[0].stacked, cs.Stacked)
        _assert_same_runs(per, four)


@pytest.mark.parametrize("rule,mode,ledger", ROBUST,
                         ids=[f"{r}-{m}-{'ledger' if l else 'plain'}"
                              for r, m, l in ROBUST])
def test_robust_chunk_matches_jax_fused_engine(monkeypatch, rule, mode,
                                               ledger):
    """The same chunks (2 rounds, serverless at ``gossip_steps=0``) beside
    JAX's fused engine from the same start and batches, dropout off, no
    codec, a clean wire: the records equal, train losses at rtol 1e-4,
    the global (serverless: the consensus) at the file's tolerance. JAX
    forms krum's distances as ``|a|^2 + |b|^2 - 2 a.b``, which cancels at
    the parameters' magnitude (ROADMAP, "not port faults"); at a learning
    rate of 1e-3 the clients lie far enough apart that its rounding does
    not pick the client, as ``tests/test_torch_chaos_engine.py`` runs it."""
    lr = 1e-3 if rule == "krum" else LR
    jres, tres, device_auth, steps = _tamper_pair(
        monkeypatch, mode, dict(kind="none"), lambda r: None, ledger=ledger,
        aggregator=rule, gossip_steps=0, lr=lr)
    assert device_auth == ([[1.0] * 4] * 2 if ledger else [])
    for rj, rt in zip(jres.metrics.rounds, tres.metrics.rounds):
        assert (rt.mask, rt.auth, rt.fused, rt.bytes_on_wire) == (
            rj.mask, rj.auth, rj.fused, rj.bytes_on_wire)
        np.testing.assert_allclose(rt.train_loss, rj.train_loss, rtol=1e-4)
    _assert_near_jax(jres, tres, steps, 2, lr=lr)


# ------------------------------------------------------------------ records


def test_fused_round_records_marked():
    """JAX ``test_fused_round_records_marked``: fused records carry the
    chunk's wall and its even split; per-round records are unmarked."""
    base = _cfg(mode="server", num_rounds=2, eval_every=2)
    fused = FedEngine(base.replace(rounds_per_dispatch=2), device="cpu").run()
    for r in fused.metrics.rounds:
        assert r.fused is True
        assert r.wall_chunk_s is not None and r.wall_chunk_s > 0
        assert r.wall_s == pytest.approx(r.wall_chunk_s / 2)
    assert '"wall_chunk_s"' in fused.metrics.to_json()
    plain = FedEngine(base, device="cpu").run()
    assert all(r.fused is False and r.wall_chunk_s is None
               for r in plain.metrics.rounds)


# ------------------------------------------------------------ clients axis


def test_fused_on_four_shards_equals_per_round_on_one():
    """A fused run on ``["cpu"] * 4`` (4 client shards, each encoding its
    own rows and keeping its residual rows across the chunk) equals the
    per-round run on ``["cpu"]`` bit for bit."""
    cfg = _cfg(mode="server", compression=CompressionConfig(kind="int8+topk"),
               ledger=LedgerConfig(enabled=True))
    _assert_same_runs(_tapped(cfg),
                      _tapped(cfg.replace(rounds_per_dispatch=4),
                              devices=["cpu"] * 4))


def test_fused_lora_tp_serverless_equals_per_round():
    """JAX ``test_engine_fed_tp_serverless_fused_and_ledger``: tiny-llama
    LoRA at ``tp=2``, serverless, fused, on ``["cpu"] * 2`` equals its
    per-round run."""
    cfg = _cfg(mode="serverless", model="tiny-llama", lora_rank=2, tp=2,
               num_rounds=2, eval_every=2, ledger=LedgerConfig(enabled=True))
    per = _tapped(cfg, devices=["cpu"] * 2)
    fused = _tapped(cfg.replace(rounds_per_dispatch=2), devices=["cpu"] * 2)
    _assert_same_runs(per, fused)
    assert fused[0].metrics.rounds[-1].effective_rank is not None
    assert fused[0].metrics.rounds[0].effective_rank is None


# --------------------------------------------------------- checkpoint cadence


def test_fused_checkpoints_at_chunk_ends_and_resumes(tmp_path):
    """With ``checkpoint_every=2`` the chunks stop at the boundary: the
    fused run's round-1 checkpoint is the per-round run's, byte for byte,
    and a resume from it ends on the uninterrupted fused run's bits."""
    cfg = _cfg(mode="server", eval_every=0, checkpoint_every=2,
               rounds_per_dispatch=4,
               compression=CompressionConfig(kind="int8+topk"),
               ledger=LedgerConfig(enabled=True))
    fused_dir, per_dir = tmp_path / "fused", tmp_path / "per"
    eng = FedEngine(cfg.replace(checkpoint_dir=str(fused_dir)), device="cpu")
    assert [eng._chunk_rounds(r) for r in (0, 1, 2)] == [2, 1, 2]
    fused = eng.run()
    FedEngine(cfg.replace(checkpoint_dir=str(per_dir),
                          rounds_per_dispatch=1), device="cpu").run()
    name = "round_000001"
    cmp = filecmp.dircmp(fused_dir / name, per_dir / name)
    assert cmp.left_list == cmp.right_list and not cmp.diff_files
    _, mismatch, errors = filecmp.cmpfiles(
        fused_dir / name, per_dir / name, cmp.left_list, shallow=False)
    assert not mismatch and not errors
    assert filecmp.cmp(fused_dir / f"{name}.meta.json",
                       per_dir / f"{name}.meta.json", shallow=False)
    resume_dir = tmp_path / "resume"
    resume_dir.mkdir()
    shutil.copytree(fused_dir / name, resume_dir / name)
    shutil.copy(fused_dir / f"{name}.meta.json", resume_dir)
    resumed = FedEngine(cfg.replace(checkpoint_dir=str(resume_dir)),
                        device="cpu").run(resume=True)
    assert [r.round for r in resumed.metrics.rounds] == [2, 3]
    for p, x in fused.trainable.items():
        assert _same(resumed.trainable[p], x), p
    for p, x in fused.ef_residual.items():
        assert _same(resumed.ef_residual[p], x), p
    assert resumed.ledger.head == fused.ledger.head
    assert os.path.isdir(resume_dir / "round_000003")
