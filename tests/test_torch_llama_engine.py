"""PyTorch port (``bcfl_tpu_torch``): the LoRA engine paths and the
causal-LM task against the JAX engine, LoRA crash and resume, and the
command line's LoRA and cohort flags.

Each engine pair runs the JAX engine and the port's on one configuration
from the JAX engine's frozen base and initial adapters, with contiguous
partitions (both packages build the same batches) and dropout off:

- tiny-llama, ``task="causal_lm"``, LoRA rank 2 (the ``lm_head`` carries
  an adapter), server FedAvg, ``int8+topk`` (top-k 1.0, nearest rounding);
- tiny-llama classification at per-client ranks ``2,4`` (the RBLA mean),
  the effective rank recorded every round;
- tiny-bert LoRA on serverless ring gossip, buffered async and the
  faithful sequential mode.

The records' masks, auth, staleness, merge weights and bytes on the wire
equal the JAX engine's exactly; train losses agree at rtol 1e-4 and the
effective rank at rtol 1e-3 (a statistic of the adapters, which differ by
float32 roundings); the final adapters within ``2 * lr * steps`` per round
and client trained in sequence (AdamW moves a coordinate by at most about
``lr`` a step, and a coordinate whose gradient is near zero may move the
other way), plus one quantization step per round per leaf under the codec
(the tolerance of ``tests/test_torch_bcfl_async.py``). ``loss_lm`` equals
JAX's to float32 rounding (rtol 1e-6) with ragged masks and a masked
example. LoRA with ``int8+topk`` and error feedback crashes and resumes
bit for bit (also under ``trimmed_mean`` with a partition over the
crash), and resume refuses another rank layout.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bcfl_tpu.compression import codecs as jcc
from bcfl_tpu_torch.compression import CompressionConfig
from bcfl_tpu_torch.config import FedConfig, PartitionConfig
from bcfl_tpu_torch.entrypoints.__main__ import main as cli_main
from bcfl_tpu_torch.faults import FaultPlan, SimulatedCrash
from bcfl_tpu_torch.fed import client_step as tcs
from bcfl_tpu_torch.fed.engine import FedEngine
from bcfl_tpu_torch.models import convert

STEPS, LR = 1, 5e-5
PART = dict(kind="contiguous", stride=12, train_span=8, test_span=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return {jcc._path_name(p): torch.from_numpy(np.array(x))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _configs(codec=False, **kw):
    from bcfl_tpu.compression import CompressionConfig as JComp
    from bcfl_tpu.config import FedConfig as JCfg
    from bcfl_tpu.config import PartitionConfig as JPart

    base = dict(name="lora", dataset="synthetic", num_labels=2,
                num_clients=4, num_rounds=2, seq_len=16, batch_size=4,
                max_local_batches=STEPS, vocab_size=512, eval_every=0,
                compute_dtype="float32")
    base.update(kw)
    comp = (dict(kind="int8+topk", topk_frac=1.0, stochastic=False)
            if codec else dict(kind="none"))
    return (JCfg(**base, partition=JPart(**PART), compression=JComp(**comp)),
            FedConfig(**base, partition=PartitionConfig(**PART),
                      compression=CompressionConfig(**comp)))


def run_pair(monkeypatch, jcfg, tcfg):
    """The JAX engine's run and the port's from JAX's frozen base and
    adapters, dropout off; returns both results and the codec's summed
    quantization step per leaf."""
    import bcfl_tpu.models as jmodels
    from bcfl_tpu.fed.engine import FedEngine as JEngine

    build = jmodels.build

    def no_dropout(name, **k):
        if name.startswith("tiny-bert"):
            k["dropout_rate"] = 0.0
        return build(name, **k)

    monkeypatch.setattr(jmodels, "build", no_dropout)
    jeng = JEngine(jcfg)
    teng = FedEngine(tcfg, device="cpu")
    teng.model.load_state_dict(convert.from_flax(
        jax.tree.map(np.asarray, jeng.frozen)))
    assert not any(p.requires_grad for p in teng.model.parameters())
    t0 = convert.from_flax_adapters(jax.tree.map(np.asarray,
                                                 jeng.trainable0))
    assert list(t0) == list(teng.trainable0)
    assert all(t0[p].shape == x.shape for p, x in teng.trainable0.items())
    teng.trainable0 = t0
    monkeypatch.setattr(teng, "_generators",
                        lambda rnd: [None] * tcfg.num_clients)
    steps = {}
    for name in ("encode_deltas", "encode_deltas_async"):
        encode = getattr(tcs, name)

        def recording(*args, _encode=encode):
            out = _encode(*args)
            for p, parts in out[0].items():
                steps[p] = steps.get(p, 0.0) + float(parts["s"].max())
            return out

        monkeypatch.setattr(tcs, name, recording)
    return jeng.run(), teng.run(), steps


def _assert_pair(jres, tres, steps, per_round):
    rounds = len(jres.metrics.rounds)
    assert len(tres.metrics.rounds) == rounds
    for rj, rt in zip(jres.metrics.rounds, tres.metrics.rounds):
        for field in ("mask", "auth", "staleness", "async_alpha",
                      "bytes_on_wire", "bytes_raw", "degraded"):
            assert getattr(rt, field) == getattr(rj, field), (rt.round, field)
        np.testing.assert_allclose(rt.train_loss, rj.train_loss, rtol=1e-4)
        assert (rt.effective_rank is None) == (rj.effective_rank is None)
        if rj.effective_rank is not None:
            np.testing.assert_allclose(rt.effective_rank, rj.effective_rank,
                                       rtol=1e-3)
    flat_j = _flat(jres.trainable)
    assert list(tres.trainable) == list(flat_j)
    for p, x in flat_j.items():
        err = np.abs(tres.trainable[p].numpy() - x.numpy())
        assert err.max() <= rounds * per_round * 1.01 + steps.get(p, 0.0), p


def test_llama_causal_lm_lora_server_round_matches_jax(monkeypatch):
    jcfg, tcfg = _configs(codec=True, model="tiny-llama", task="causal_lm",
                          lora_rank=2, mode="server")
    jres, tres, steps = run_pair(monkeypatch, jcfg, tcfg)
    assert any(p.startswith("lm_head/") for p in tres.trainable)
    assert steps
    _assert_pair(jres, tres, steps, 2 * LR * STEPS)
    # per-token loss: ln(512) at the random init
    assert abs(tres.metrics.rounds[0].train_loss - np.log(512)) < 0.5


def test_llama_hetero_ranks_match_jax_with_effective_rank(monkeypatch):
    jcfg, tcfg = _configs(model="tiny-llama", lora_ranks="2,4",
                          mode="server", num_rounds=3)
    jres, tres, steps = run_pair(monkeypatch, jcfg, tcfg)
    assert all(r.effective_rank > 0 for r in tres.metrics.rounds)
    _assert_pair(jres, tres, steps, 2 * LR * STEPS)
    # the rank-2 client's padding never moved off zero: the global's
    # rank dims 2-3 come from the rank-4 client alone
    assert tres.trainable["model/layer_0/attention/q_proj/a"].shape[-1] == 4


ENCODER_MODES = {
    "serverless": dict(mode="serverless"),
    "async": dict(mode="serverless", sync="async", async_buffer=2),
    "faithful": dict(mode="serverless", faithful=True),
}


@pytest.mark.parametrize("mode", list(ENCODER_MODES))
def test_encoder_lora_paths_match_jax(monkeypatch, mode):
    jcfg, tcfg = _configs(model="tiny-bert", lora_rank=2,
                          **ENCODER_MODES[mode])
    jres, tres, steps = run_pair(monkeypatch, jcfg, tcfg)
    # faithful: the clients train one shared tree in turn
    clients = tcfg.num_clients if mode == "faithful" else 1
    _assert_pair(jres, tres, steps, 2 * LR * STEPS * clients)
    assert set(tres.trainable) == set(_flat(jres.trainable))


def test_loss_lm_matches_jax():
    from bcfl_tpu.fed.client_step import make_loss_fn as jloss
    from bcfl_tpu.models import build as jbuild
    from bcfl_tpu_torch.models import build as tbuild

    jm = jbuild("tiny-llama", head="lm", vocab_size=128, dtype=jnp.float32)
    ids0 = jnp.ones((1, 8), jnp.int32)
    params = jm.init(jax.random.key(0), ids0, ids0)["params"]
    tm = tbuild("tiny-llama", head="lm", vocab_size=128, dtype=torch.float32)
    tm.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (4, 12)).astype(np.int32)
    mask = (np.arange(12)[None] < np.array([12, 7, 3, 9])[:, None]).astype(
        np.int32)
    batch = {"ids": ids, "mask": mask,
             "labels": np.zeros(4, np.int32),
             "example_mask": np.array([1, 1, 1, 0], np.float32)}
    loss_j, (correct_j, n_j) = jloss(jm, "causal_lm")(params, None,
                                                      batch, None)
    with torch.no_grad():
        loss_t, correct_t, n_t = tcs.make_loss_fn(tm.eval(), "causal_lm")(
            {k: torch.from_numpy(v) for k, v in batch.items()}, None)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    assert float(correct_t) == float(correct_j)
    # n counts tokens: the shifted padding mask of the kept examples
    assert float(n_t) == float(n_j) == 11 + 6 + 2
    with pytest.raises(ValueError, match="unknown task"):
        tcs.make_loss_fn(tm, "regression")


def _lora_codec(**kw):
    base = dict(dataset="synthetic", model="tiny-llama", num_clients=3,
                num_rounds=3, seq_len=16, batch_size=4, max_local_batches=1,
                vocab_size=512, eval_every=0, lora_rank=2,
                partition=PartitionConfig(kind="iid", iid_samples=8),
                compression=CompressionConfig(kind="int8+topk",
                                              topk_frac=0.1))
    base.update(kw)
    return FedConfig(**base)


PARTITION = dict(partition_rounds=(1, 2), partition_groups=((0,), (1, 2)))


@pytest.mark.parametrize("kw", [
    {}, dict(aggregator="trimmed_mean", faults=PARTITION)],
    ids=["mean", "trimmed-mean-partition"])
def test_lora_codec_ef_crash_resume_bit_identical(tmp_path, kw):
    faults = kw.pop("faults", {})
    ref = FedEngine(_lora_codec(faults=FaultPlan(**faults), **kw),
                    device="cpu").run()
    if faults:
        assert [r.partition is not None for r in ref.metrics.rounds] == [
            False, True, True]
    cfg = _lora_codec(checkpoint_dir=str(tmp_path), checkpoint_every=1,
                      faults=FaultPlan(crash_at_round=1, **faults), **kw)
    with pytest.raises(SimulatedCrash):
        FedEngine(cfg, device="cpu").run()
    res = FedEngine(cfg, device="cpu").run(resume=True)
    assert [r.round for r in res.metrics.rounds] == [1, 2]
    for p in ref.trainable:
        assert torch.equal(ref.trainable[p], res.trainable[p]), p
    for p in ref.ef_residual:
        assert torch.equal(ref.ef_residual[p], res.ef_residual[p]), p
    for ra, rb in zip(ref.metrics.rounds[1:], res.metrics.rounds):
        assert (ra.train_loss, ra.effective_rank) == (rb.train_loss,
                                                      rb.effective_rank)
    last = res.metrics.rounds[-1]
    assert last.bytes_on_wire < last.bytes_raw
    # the adapters are the exchange: the base never reaches the wire
    assert last.bytes_raw == 4 * sum(x.numel() for x in ref.trainable.values()
                                     ) * 3
    with pytest.raises(ValueError, match="rank layout"):
        FedEngine(cfg.replace(lora_rank=4), device="cpu").run(resume=True)
    with pytest.raises(ValueError, match="rank layout"):
        FedEngine(cfg.replace(lora_rank=0, lora_ranks="2,4",
                              aggregator="mean"),
                  device="cpu").run(resume=True)


def test_cli_lora_and_cohort_flags(capsys):
    common = ["--preset", "smoke", "--device", "cpu", "--mode", "server",
              "--rounds", "1", "--seq-len", "16", "--batch-size", "4",
              "--max-local-batches", "1", "--eval-every", "0"]
    assert cli_main(common + ["--model", "tiny-llama", "--lora-rank", "2",
                              "--task", "causal_lm", "--registry-size", "16",
                              "--sample-clients", "4", "--cohort-size",
                              "4"]) == 0
    out = capsys.readouterr().out
    assert "task=causal_lm" in out and "registry=16 cohort=4/round" in out
    assert "cohort=[" in out and "eff_rank=" in out
    assert cli_main(common + ["--model", "tiny-bert", "--lora-ranks",
                              "2,4"]) == 0
    assert "ranks=2,4" in capsys.readouterr().out
    for flags, needle in (
            (["--lora-ranks", "2,4", "--lora-rank", "2"], "not both"),
            (["--lora-ranks", "2,x"], "comma-separated positive ints"),
            (["--lora-ranks", "2,4", "--mode", "serverless"],
             "require mode='server'"),
            (["--sample-clients", "4"], "registry_size > 0"),
            (["--registry-size", "8", "--sample-clients", "4",
              "--cohort-size", "2"], "needs 2 devices"),
            (["--registry-size", "8", "--sync", "async"], "async")):
        with pytest.raises(ValueError, match=needle):
            cli_main(common + flags)
    with pytest.raises(ValueError, match="is an encoder"):
        cli_main(common + ["--model", "tiny-bert", "--task", "causal_lm"])
