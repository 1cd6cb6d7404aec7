"""PyTorch port (``bcfl_tpu_torch``): cohort mode (``bcfl_tpu/fed/cohort.py``
and the engine's registry-keyed state) against the JAX package.

- The sampler is numpy in both packages: its ids equal
  ``bcfl_tpu.fed.cohort.ClientSampler``'s bit for bit over seeds, registry
  sizes and rounds.
- ``EFRegistry``: unseen clients gather zeros, scattered rows are copies,
  and the checkpoint state round-trips exactly.
- The config's capability table for LoRA ranks and cohort mode is JAX's:
  every case JAX rejects the port rejects with JAX's message, every case
  JAX accepts the port accepts; ``cohort_size`` on the port's one device
  accepts 0 and the whole cohort and otherwise raises the JAX engine's
  device-count message (for one device).
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
                seq_len=16, batch_size=4)
    for ok in (0, 16):
        assert FedConfig(**base, cohort_size=ok).cohort_size == ok
    # JAX pins the mesh to sample_clients / cohort_size devices and
    # refuses a pin it cannot meet; the port has one device
    with pytest.raises(ValueError) as jerr:
        JEngine(JCfg(**base, cohort_size=1))
    n = len(jax.devices())
    with pytest.raises(ValueError) as terr:
        FedConfig(**base, cohort_size=1)
    assert str(terr.value) == str(jerr.value).replace(f"have {n}", "have 1")
    with pytest.raises(ValueError, match="cohort_size 8 needs 2 devices for "
                                         "a 16-client cohort, have 1"):
        FedConfig(**base, cohort_size=8)


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


def test_cohort_engine_matches_jax(monkeypatch):
    import bcfl_tpu.models as jmodels
    from bcfl_tpu.fed.engine import FedEngine as JEngine
    from bcfl_tpu_torch.fed import client_step as tcs

    jcfg, tcfg = _pair_configs()
    build = jmodels.build
    monkeypatch.setattr(jmodels, "build",
                        lambda *a, **k: build(*a, dropout_rate=0.0, **k))
    jeng = JEngine(jcfg)
    teng = FedEngine(tcfg, device="cpu")
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
    encode = tcs.encode_deltas

    def recording(*args):
        payload, recon, resid = encode(*args)
        for p, parts in payload.items():
            steps[p] = steps.get(p, 0.0) + float(parts["s"].max())
        return payload, recon, resid

    monkeypatch.setattr(tcs, "encode_deltas", recording)
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
    flat_j = _flat(jres.trainable)
    for p, x in flat_j.items():
        err = np.abs(tres.trainable[p].numpy() - x.numpy())
        assert err.max() <= 3 * 2 * LR * STEPS * 1.01 + steps[p], p


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
