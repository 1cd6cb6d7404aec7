"""PyTorch port (``bcfl_tpu_torch``): cohort mode (``bcfl_tpu/fed/cohort.py``
and the engine's registry-keyed state) against the JAX package.

- The sampler is numpy in both packages: its ids equal
  ``bcfl_tpu.fed.cohort.ClientSampler``'s bit for bit over seeds, registry
  sizes and rounds.
- ``EFRegistry``: unseen clients gather zeros, scattered rows are copies,
  and the checkpoint state round-trips exactly.
- The config's capability table for LoRA ranks and cohort mode is JAX's:
  every case JAX rejects the port rejects with JAX's message, every case
  JAX accepts the port accepts; ``cohort_size`` pins the mesh to
  ``sample_clients / cohort_size`` client shards, and the engine refuses a
  pin its devices cannot meet with the JAX engine's message (on 8 devices
  and on one); JAX's own pin test on the port's CPU devices (4 client
  shards of 2; 2 shards of 2 x ``tp=2``).
- The cohort mean is JAX's two-level mean over the client shards: on 2
  shards of 2 every round's global is ``hierarchical_weighted_mean`` with
  2 groups over the landed reconstruction, bit for bit, and the engine
  stays within the tolerance below of JAX's engine on the same mesh
  shape; on shards of one client the two-level mean is the flat one.
- A tiny-bert cohort engine run (registry 10, cohort 4, ``int8+topk``
  with top-k 1.0 and nearest rounding, the ledger, 3 rounds, contiguous
  partitions, so each slot's batches come from its registry id in both
  packages) from the JAX engine's initial parameters, dropout off: the
  cohorts, masks, auth, ledger entries' client ids and bytes on the wire
  equal the JAX engine's exactly, train losses agree at rtol 1e-4, and the
  final global within ``2 * lr * steps * rounds`` plus one quantization
  step per round per leaf (the tolerance of
  ``tests/test_torch_bcfl_async.py``).
- Cohort crash and resume (stochastic ``int8+topk``, the registry's
  residuals in the checkpoint) equals the uninterrupted run bit for bit;
  resume refuses a changed ``registry_size`` or ``sample_clients``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from bcfl_tpu.compression import codecs as jcc
from bcfl_tpu.fed.cohort import ClientSampler as JSampler
from bcfl_tpu_torch.compression import CompressionConfig
from bcfl_tpu_torch.config import FedConfig, LedgerConfig, PartitionConfig
from bcfl_tpu_torch.faults import FaultPlan, SimulatedCrash
from bcfl_tpu_torch.fed.cohort import ClientSampler, EFRegistry, cohort_view
from bcfl_tpu_torch.fed.engine import FedEngine

STEPS, LR = 2, 5e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return {jcc._path_name(p): torch.from_numpy(np.array(x))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("seed,registry,cohort",
                         [(42, 64, 4), (0, 10, 4), (7, 1000, 16), (3, 5, 5),
                          (123456789, 300, 1)])
def test_sampler_ids_bit_identical_to_jax(seed, registry, cohort):
    mine, theirs = (ClientSampler(seed, registry, cohort),
                    JSampler(seed, registry, cohort))
    for rnd in range(12):
        got, want = mine.cohort_ids(rnd), theirs.cohort_ids(rnd)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="cohort"):
        ClientSampler(seed, registry, registry + 1)


def test_ef_registry_round_trip():
    tmpl = {"a": torch.zeros(3), "b": torch.zeros(2, 2)}
    reg = EFRegistry(tmpl)
    ids = np.asarray([5, 11], np.int64)
    stacked = {"a": torch.arange(6.0).reshape(2, 3),
               "b": torch.ones(2, 2, 2)}
    reg.scatter(ids, stacked)
    got = reg.gather(np.asarray([11, 3, 5]))
    assert torch.equal(got["a"][0], stacked["a"][1])
    assert not got["a"][1].any()  # never sampled: zeros
    assert torch.equal(got["a"][2], stacked["a"][0])
    # rows are copies: changing the source changes nothing stored
    stacked["a"][0] = -1.0
    assert torch.equal(reg.gather([5])["a"][0], torch.tensor([0.0, 1, 2]))
    state = reg.checkpoint_state()
    assert state["ef_ids"].tolist() == [5, 11]
    other = EFRegistry(tmpl)
    other.restore(state)
    assert len(other) == 2
    for p in tmpl:
        assert torch.equal(other.gather(ids)[p], reg.gather(ids)[p])
    other.restore({})
    assert len(other) == 0 and EFRegistry(tmpl).checkpoint_state() == {}
    assert cohort_view(None, ids) is None
    np.testing.assert_array_equal(cohort_view(np.arange(20.0), ids),
                                  [5.0, 11.0])


def _plan(**kw):
    return kw


CAPABILITY = [
    ("sample-without-registry", dict(sample_clients=4)),
    ("cohort-size-without-registry", dict(cohort_size=2)),
    ("negative-registry", dict(registry_size=-1)),
    ("cohort-past-registry", dict(registry_size=4, sample_clients=8)),
    ("cohort-size-divides", dict(registry_size=64, sample_clients=8,
                                 cohort_size=3)),
    ("registry-serverless", dict(registry_size=64, mode="serverless")),
    ("registry-async", dict(registry_size=64, sync="async")),
    ("registry-faithful", dict(registry_size=64, faithful=True)),
    ("registry-partition", dict(registry_size=64, faults=_plan(
        partition_rounds=(1,), partition_groups=((0, 1), (2, 3))))),
    ("rank-and-ranks", dict(lora_rank=4, lora_ranks="2,4")),
    ("ranks-bad-token", dict(lora_ranks="2,x")),
    ("ranks-zero", dict(lora_ranks="0,2")),
    ("hetero-trimmed-mean", dict(lora_ranks="2,4",
                                 aggregator="trimmed_mean")),
    ("hetero-serverless", dict(lora_ranks="2,4", mode="serverless")),
    ("hetero-faithful", dict(lora_ranks="2,4", mode="serverless",
                             faithful=True)),
    ("hetero-registry", dict(lora_ranks="2,4", registry_size=64)),
    # accepted by both
    ("registry", dict(registry_size=64, sample_clients=8)),
    ("registry-robust-codec", dict(registry_size=64, aggregator="krum",
                                   compression="int8+topk")),
    ("hetero-server", dict(lora_ranks="2,4,8")),
    ("uniform-ranks-robust", dict(lora_ranks="4,4", aggregator="median")),
    ("uniform-ranks-registry", dict(lora_ranks="4", registry_size=64)),
    ("lora-serverless", dict(lora_rank=4, mode="serverless")),
    ("causal-lm", dict(task="causal_lm", model="tiny-llama", lora_rank=2)),
    ("north-star", dict(model="llama2-7b", lora_rank=8, registry_size=64,
                        sample_clients=4, cohort_size=4)),
]


def _both(kw):
    from bcfl_tpu.compression import CompressionConfig as JComp
    from bcfl_tpu.config import FedConfig as JCfg
    from bcfl_tpu.faults import FaultPlan as JPlan

    jkw, tkw = dict(kw), dict(kw)
    if "faults" in kw:
        jkw["faults"], tkw["faults"] = (JPlan(**kw["faults"]),
                                        FaultPlan(**kw["faults"]))
    if "compression" in kw:
        jkw["compression"] = JComp(kind=kw["compression"])
        tkw["compression"] = CompressionConfig(kind=kw["compression"])
    return (lambda: JCfg(**jkw)), (lambda: FedConfig(**tkw))


@pytest.mark.parametrize("kw", [k for _, k in CAPABILITY],
                         ids=[n for n, _ in CAPABILITY])
def test_capability_table_is_jax(kw):
    make_j, make_t = _both(kw)
    try:
        jcfg = make_j()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            make_t()
        assert str(got.value) == str(e)
        return
    tcfg = make_t()
    for f in ("lora_rank", "lora_ranks", "registry_size", "sample_clients",
              "cohort_size", "task"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tcfg.client_lora_ranks == jcfg.client_lora_ranks
    assert tcfg.lora_rank_spec == jcfg.lora_rank_spec
    # a replace keeps the canonicalized spec valid
    assert tcfg.replace(num_rounds=3).lora_rank == tcfg.lora_rank


def test_cohort_size_on_one_device():
    from bcfl_tpu.config import FedConfig as JCfg
    from bcfl_tpu.fed.engine import FedEngine as JEngine

    base = dict(registry_size=64, sample_clients=16, model="tiny-bert",
                seq_len=16, batch_size=4, dataset="synthetic")
    # the config takes any pin that divides the cohort, as JAX's does
    for pin in (0, 1, 8, 16):
        assert (FedConfig(**base, cohort_size=pin).cohort_size
                == JCfg(**base, cohort_size=pin).cohort_size == pin)
    assert FedEngine(FedConfig(**base, cohort_size=16),
                     device="cpu").mesh.per_device == 16
    # the engine pins the mesh to sample_clients / cohort_size client
    # shards and refuses, in JAX's words, a pin its devices cannot meet:
    # on JAX's 8 devices and the port's 8 CPU devices alike, and on one
    n = len(jax.devices())
    with pytest.raises(ValueError) as jerr:
        JEngine(JCfg(**base, cohort_size=1))
    with pytest.raises(ValueError) as terr:
        FedEngine(FedConfig(**base, cohort_size=1), devices=["cpu"] * n)
    assert str(terr.value) == str(jerr.value) == (
        f"cohort_size 1 needs 16 devices for a 16-client cohort, have {n}")
    with pytest.raises(ValueError, match="cohort_size 8 needs 2 devices for "
                                         "a 16-client cohort, have 1"):
        FedEngine(FedConfig(**base, cohort_size=8), device="cpu")


def test_cohort_size_pins_per_device_stack():
    """JAX's ``tests/test_cohort.py::test_cohort_size_pins_per_device_stack``
    on the port's CPU devices: the pin gives the client shards, with an
    inner tp axis each shard reserving tp devices."""
    eng = FedEngine(_tiny_cohort(registry_size=64, sample_clients=8,
                                 max_local_batches=2, cohort_size=2,
                                 compression=CompressionConfig(kind="none"),
                                 ledger=LedgerConfig(enabled=False)),
                    devices=["cpu"] * 8)
    # 8-client cohort / 2 per device = 4 client shards
    assert eng.mesh.per_device == 2
    assert eng.mesh.mesh.shape == {"clients": 4}
    assert len(eng.local_train.bodies) == 4
    res = eng.run()
    for x in res.trainable.values():
        assert torch.isfinite(x).all()
    # 4-client cohort / 2 per device = 2 client shards x tp=2 = 4 devices,
    # each shard on its own row
    eng_tp = FedEngine(_tiny_cohort(registry_size=64, sample_clients=4,
                                    cohort_size=2, tp=2, lora_rank=2,
                                    num_rounds=1), devices=["cpu"] * 4)
    assert eng_tp.mesh.per_device == 2
    assert eng_tp.mesh.mesh.shape == {"clients": 2, "tp": 2}
    assert len(eng_tp.local_train.bodies) == 2
    res = eng_tp.run()
    for x in res.trainable.values():
        assert torch.isfinite(x).all()


def _pair_configs(**kw):
    from bcfl_tpu.compression import CompressionConfig as JComp
    from bcfl_tpu.config import FedConfig as JCfg, LedgerConfig as JLed
    from bcfl_tpu.config import PartitionConfig as JPart

    base = dict(name="cohort", model="tiny-bert", dataset="synthetic",
                num_labels=2, mode="server", registry_size=10,
                sample_clients=4, num_rounds=3, seq_len=16, batch_size=4,
                max_local_batches=STEPS, vocab_size=512, eval_every=0,
                compute_dtype="float32")
    base.update(kw)
    part = dict(kind="contiguous", stride=12, train_span=8, test_span=4)
    comp = dict(kind="int8+topk", topk_frac=1.0, stochastic=False)
    j = JCfg(**base, partition=JPart(**part), compression=JComp(**comp),
             ledger=JLed(enabled=True, use_native=False))
    t = FedConfig(**base, partition=PartitionConfig(**part),
                  compression=CompressionConfig(**comp),
                  ledger=LedgerConfig(enabled=True))
    return j, t


def _engine_pair(monkeypatch, devices, **kw):
    """JAX's cohort engine and the port's on ``devices``, from JAX's
    initial parameters, dropout off, both run; the port's batches checked
    to be JAX's. Returns ``(JAX result, JAX engine, port engine, port
    result, the per-leaf sum over rounds of the largest quantization
    scale)``."""
    import bcfl_tpu.models as jmodels
    from bcfl_tpu.fed.engine import FedEngine as JEngine
    from bcfl_tpu_torch.fed import client_step as tcs

    jcfg, tcfg = _pair_configs(**kw)
    build = jmodels.build
    monkeypatch.setattr(jmodels, "build",
                        lambda *a, **k: build(*a, dropout_rate=0.0, **k))
    jeng = JEngine(jcfg)
    teng = FedEngine(tcfg, devices=devices)
    teng.trainable0 = _flat(jeng.trainable0)
    monkeypatch.setattr(teng, "_generators", lambda rnd: [None] * 4)
    # the port's own batches (contiguous partitions by registry id) are
    # the JAX engine's
    for rnd in range(3):
        tb, tn = teng._round_batches(rnd)
        jb, jn = jeng._round_batches(rnd)
        np.testing.assert_array_equal(tn, np.asarray(jn))
        for k, v in tb.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jb[k]))
    steps = {}
    encode, decode = tcs.encode_deltas, tcs.decode_recon

    def add_steps(payload):
        for p, parts in payload.items():
            steps[p] = steps.get(p, 0.0) + float(parts["s"].max())

    def recording(*args):
        payload, recon, resid = encode(*args)
        add_steps(payload)
        return payload, recon, resid

    def decoding(comp, payload, *args):  # the shards encoded the payload
        add_steps(payload)
        return decode(comp, payload, *args)

    monkeypatch.setattr(tcs, "encode_deltas", recording)
    monkeypatch.setattr(tcs, "decode_recon", decoding)
    jres, tres = jeng.run(), teng.run()
    assert len(tres.metrics.rounds) == 3
    for rj, rt in zip(jres.metrics.rounds, tres.metrics.rounds):
        for field in ("cohort", "mask", "auth", "bytes_on_wire",
                      "bytes_raw", "degraded", "info_passing_sync_s"):
            assert getattr(rt, field) == getattr(rj, field), (rt.round, field)
        np.testing.assert_allclose(rt.train_loss, rj.train_loss, rtol=1e-4)
    assert [r.cohort for r in tres.metrics.rounds] == [
        JSampler(42, 10, 4).cohort_ids(r).tolist() for r in range(3)]
    # ledger entries are keyed by registry id, in both packages
    tl, jl = tres.ledger.entries, jres.ledger.entries
    assert [(e.round, e.client) for e in tl] == [(e.round, e.client)
                                                 for e in jl]
    return jres, jeng, teng, tres, steps


def _assert_near_jax(jres, tres, steps):
    flat_j = _flat(jres.trainable)
    for p, x in flat_j.items():
        err = np.abs(tres.trainable[p].numpy() - x.numpy())
        assert err.max() <= 3 * 2 * LR * STEPS * 1.01 + steps[p], p


def test_cohort_engine_matches_jax(monkeypatch):
    jres, _, _, tres, steps = _engine_pair(monkeypatch, ["cpu"])
    _assert_near_jax(jres, tres, steps)


def test_cohort_mean_is_two_level_over_client_shards(monkeypatch):
    """``cohort_size=2`` on 2 devices: 2 client shards of 2, as JAX's mesh
    on 2 of its devices. Every round's global is the two-level mean with 2
    groups over the reconstruction that landed, bit for bit, and the run
    stays within the one-device tolerance of JAX's engine, which compiles
    the same two-level mean."""
    from bcfl_tpu_torch.parallel import (hierarchical_weighted_mean,
                                         masked_weighted_mean)

    calls = []
    real = FedEngine.__init__

    def tapped(self, *a, **k):
        real(self, *a, **k)
        agg = self.agg

        def recorded(t, w, fb):
            out = agg(t, w, fb)
            calls.append((t, w, fb, out))
            return out

        self.agg = recorded

    monkeypatch.setattr(FedEngine, "__init__", tapped)
    jres, jeng, teng, tres, steps = _engine_pair(
        monkeypatch, ["cpu"] * 2, cohort_size=2)
    assert teng.mesh.mesh.shape == {"clients": 2} == dict(
        jeng.mesh.mesh.shape)
    assert teng.mesh.per_device == 2 and len(teng.local_train.bodies) == 2
    assert len(calls) == 3
    for t, w, fb, out in calls:
        want = hierarchical_weighted_mean(t, w, 2, fallback=fb)
        for p, x in want.items():
            assert torch.equal(out[p].view(torch.int32),
                               x.view(torch.int32)), p
    for p, x in calls[-1][3].items():
        assert torch.equal(tres.trainable[p], x), p
    _assert_near_jax(jres, tres, steps)
    # one client a shard: the two-level mean is the flat one, bit for bit
    t, w, fb, _ = calls[0]
    flat = masked_weighted_mean(t, w, fallback=fb)
    for p, x in hierarchical_weighted_mean(t, w, 4, fallback=fb).items():
        assert torch.equal(x.view(torch.int32), flat[p].view(torch.int32)), p


def _tiny_cohort(**kw):
    base = dict(dataset="synthetic", model="tiny-bert", registry_size=10,
                sample_clients=4, num_rounds=3, seq_len=16, batch_size=4,
                max_local_batches=1, vocab_size=512, eval_every=0,
                partition=PartitionConfig(kind="iid", iid_samples=8),
                compression=CompressionConfig(kind="int8+topk"),
                ledger=LedgerConfig(enabled=True))
    base.update(kw)
    return FedConfig(**base)


def test_cohort_crash_resume_bit_identical(tmp_path):
    cfg = _tiny_cohort()
    ref_eng = FedEngine(cfg, device="cpu")
    ref = ref_eng.run()
    crash = cfg.replace(checkpoint_dir=str(tmp_path / "ck"),
                        checkpoint_every=1,
                        faults=FaultPlan(crash_at_round=2))
    with pytest.raises(SimulatedCrash):
        FedEngine(crash, device="cpu").run()
    eng = FedEngine(crash, device="cpu")
    res = eng.run(resume=True)
    assert [r.round for r in res.metrics.rounds] == [2]
    for p in ref.trainable:
        assert torch.equal(ref.trainable[p], res.trainable[p]), p
    ra, rb = ref.metrics.rounds[2], res.metrics.rounds[0]
    for f in ("cohort", "train_loss", "train_acc", "mask", "auth"):
        assert getattr(ra, f) == getattr(rb, f), f
    assert ref.ledger.to_json() == res.ledger.to_json()
    # the registry's residual rows, every client ever sampled
    a, b = ref_eng._ef_reg.checkpoint_state(), eng._ef_reg.checkpoint_state()
    np.testing.assert_array_equal(a["ef_ids"], b["ef_ids"])
    seen = sorted({i for r in ref.metrics.rounds for i in r.cohort})
    assert a["ef_ids"].tolist() == seen
    for p in a["ef_registry"]:
        assert torch.equal(a["ef_registry"][p], b["ef_registry"][p]), p
    assert ref.ef_residual is not None and res.ef_residual is not None


def test_resume_refuses_changed_cohort_identity(tmp_path):
    cfg = _tiny_cohort(num_rounds=1, checkpoint_dir=str(tmp_path),
                       checkpoint_every=1)
    FedEngine(cfg, device="cpu").run()
    cfg2 = cfg.replace(num_rounds=2)
    for change, have in ((dict(registry_size=12), "12/4"),
                         (dict(sample_clients=3), "10/3")):
        with pytest.raises(ValueError, match=f"registry_size=10/"
                                             f"sample_clients=4 but this run "
                                             f"has {have}"):
            FedEngine(cfg2.replace(**change), device="cpu").run(resume=True)
    off = dataclasses.replace(cfg2, registry_size=0, sample_clients=0,
                              num_clients=4)
    with pytest.raises(ValueError, match="has 0/0"):
        FedEngine(off, device="cpu").run(resume=True)
    assert [r.round for r in FedEngine(cfg2, device="cpu").run(
        resume=True).metrics.rounds] == [1]


def test_record_carries_the_cohort_in_json():
    res = FedEngine(_tiny_cohort(num_rounds=1), device="cpu").run()
    import json

    rounds = json.loads(res.metrics.to_json())["rounds"]
    assert rounds[0]["cohort"] == ClientSampler(42, 10, 4).cohort_ids(
        0).tolist()
    assert rounds[0]["effective_rank"] is None
