"""PyTorch port (``bcfl_tpu_torch``): buffered async under the fault plan,
and what crash/resume does to an async run, beside the JAX engine.

(a) One async run (tiny-bert, 6 clients, buffer 3, ledger and reputation
on with staleness evidence, dropout and stragglers pushing clients later
on the simulated clock) from the JAX engine's initial parameters and
batches, dropout off in both: the per-round records (mask, dropped, auth,
staleness, merge weights, straggler delays, reputation states and trust,
information passing times) equal the JAX engine's exactly, and the final
parameters agree within the tolerance of ``tests/test_torch_round.py``.

(b) The same run crashed at round 2 and resumed from round 1's checkpoint,
in both packages. Neither checkpoints the async network clock (the JAX
engine rebuilds ``_init_async_state()`` after the restore, and the port
does the same): the resumed run restarts every client's completion time,
version and the global version. So a resumed async run does NOT reproduce
the uninterrupted one in the JAX package, and the port's resumed run
equals the JAX package's resumed run, record for record.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from bcfl_tpu.compression import codecs as jcc

STEPS, BATCH, SEQ, C, ROUNDS = 1, 4, 16, 6, 4
LR = 5e-5
ATOL_NONE = 2e-6
FIELDS = ("mask", "dropped", "auth", "staleness", "async_alpha",
          "straggler_s", "reputation_state", "reputation_trust", "degraded",
          "info_passing_sync_s", "info_passing_async_s")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return {jcc._path_name(p): torch.from_numpy(np.array(x))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _configs(**faults):
    from bcfl_tpu.config import FedConfig as JCfg, LedgerConfig as JLed
    from bcfl_tpu.faults import FaultPlan as JPlan
    from bcfl_tpu.reputation import ReputationConfig as JRep
    from bcfl_tpu_torch.config import FedConfig as TCfg, LedgerConfig as TLed
    from bcfl_tpu_torch.faults import FaultPlan as TPlan
    from bcfl_tpu_torch.reputation import ReputationConfig as TRep

    kw = dict(name="async-chaos", model="tiny-bert", dataset="synthetic",
              num_labels=2, mode="serverless", sync="async", async_buffer=3,
              weighted_agg=False, num_clients=C, num_rounds=ROUNDS,
              seq_len=SEQ, batch_size=BATCH, max_local_batches=STEPS,
              vocab_size=512, eval_every=0, compute_dtype="float32")
    plan = dict(seed=2, dropout_prob=0.2, straggler_prob=0.4,
                straggler_delay_s=2.0, **faults)
    rep = dict(enabled=True, staleness_limit=1, quarantine_rounds=1)
    j = JCfg(**kw, faults=JPlan(**plan), reputation=JRep(**rep),
             ledger=JLed(enabled=True, use_native=False))
    t = TCfg(**kw, faults=TPlan(**plan), reputation=TRep(**rep),
             ledger=TLed(enabled=True))
    return j, t


class _Pair:
    """Builds JAX and port engines that share the JAX engine's start and
    batches (dropout off)."""

    def __init__(self, monkeypatch):
        import bcfl_tpu.models as jmodels

        build = jmodels.build
        monkeypatch.setattr(jmodels, "build",
                            lambda *a, **k: build(*a, dropout_rate=0.0, **k))
        self.mp = monkeypatch
        self.start = None
        self.batches = {}

    def engines(self, jcfg, tcfg):
        from bcfl_tpu.fed.engine import FedEngine as JEngine
        from bcfl_tpu_torch.fed.engine import FedEngine as TEngine

        jeng = JEngine(jcfg)
        teng = TEngine(tcfg, device="cpu")
        if self.start is None:
            self.start = _flat(jeng.trainable0)
        teng.trainable0 = dict(self.start)

        def round_batches(rnd):
            if rnd not in self.batches:
                tree, n_ex = jeng._round_batches(rnd)
                self.batches[rnd] = (
                    {k: torch.from_numpy(np.array(v))
                     for k, v in tree.items()}, np.asarray(n_ex))
            return self.batches[rnd]

        self.mp.setattr(teng, "_round_batches", round_batches)
        self.mp.setattr(teng, "_generators", lambda rnd: [None] * C)
        return jeng, teng


def _params_close(jtree, ttree):
    far = total = 0
    for p, x in _flat(jtree).items():
        err = np.abs(ttree[p].numpy() - x.numpy())
        assert err.max() <= ROUNDS * 2 * LR * STEPS * 1.01, p
        if not p.endswith("/key/bias"):
            far += int((err > ROUNDS * ATOL_NONE).sum())
            total += err.size
    assert far <= total * 1e-4, f"{far} of {total} coordinates past atol"


def _same(recs_t, recs_j):
    assert [r.round for r in recs_t] == [r.round for r in recs_j]
    for rt, rj in zip(recs_t, recs_j):
        for f in FIELDS:
            assert getattr(rt, f) == getattr(rj, f), (rt.round, f)
        np.testing.assert_allclose(rt.train_loss, rj.train_loss, rtol=1e-4)


def test_async_chaos_and_resume_match_jax(monkeypatch, tmp_path):
    from bcfl_tpu.faults import SimulatedCrash as JCrash
    from bcfl_tpu_torch.faults import SimulatedCrash as TCrash

    pair = _Pair(monkeypatch)
    # (a) uninterrupted, beside JAX
    jcfg, tcfg = _configs()
    jeng, teng = pair.engines(jcfg, tcfg)
    jref, tref = jeng.run(), teng.run()
    _same(tref.metrics.rounds, jref.metrics.rounds)
    assert tref.metrics.reputation == jref.metrics.reputation
    _params_close(jref.trainable, tref.trainable)
    recs = tref.metrics.rounds
    assert any(r.straggler_s for r in recs) and any(r.dropped for r in recs)
    assert any(max(r.staleness) > 1 for r in recs)

    # (b) crash at round 2, resume from round 1's checkpoint
    def crashed(cfg, d):
        return cfg.replace(checkpoint_dir=str(tmp_path / d),
                           checkpoint_every=1,
                           faults=dataclasses.replace(cfg.faults,
                                                      crash_at_round=2))

    jc, tc = crashed(jcfg, "jax"), crashed(tcfg, "port")
    jeng, teng = pair.engines(jc, tc)
    with pytest.raises(JCrash):
        jeng.run()
    with pytest.raises(TCrash):
        teng.run()
    jeng, teng = pair.engines(jc, tc)
    jres, tres = jeng.run(resume=True), teng.run(resume=True)
    # the port's resumed run is the JAX package's resumed run
    _same(tres.metrics.rounds, jres.metrics.rounds)
    assert tres.metrics.reputation == jres.metrics.reputation
    _params_close(jres.trainable, tres.trainable)
    # and neither reproduces the uninterrupted run: the restarted network
    # clock re-deals the arrivals and zeroes the staleness
    assert ([r.staleness for r in jres.metrics.rounds]
            != [r.staleness for r in jref.metrics.rounds[2:]])
    assert any(not np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(jax.tree.leaves(jres.trainable),
                               jax.tree.leaves(jref.trainable)))
