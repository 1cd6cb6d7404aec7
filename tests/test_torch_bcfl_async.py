"""PyTorch port (``bcfl_tpu_torch``): the BC-FL async engine, the presets
and the CLI against the JAX package.

(c) One async engine run (tiny-bert, 10 clients, buffer 4, PageRank
gating, ledger on, 3 rounds) from the JAX engine's initial parameters and
batches, dropout off in both, without a codec and with ``int8+topk``
(top-k 1.0, nearest rounding: the recon-free encode, the merge's decode
and the error-feedback residual of clients that did not arrive): the
per-round mask, anomalies, auth, staleness, merge weights, information
passing times and bytes on the wire equal the JAX engine's exactly, and
so do the ledger's length and payload accounting; the final global
parameters agree within ``2 * lr * steps * rounds``, all but 1e-4 of the
coordinates within 2e-6 per round (the tolerance of
``tests/test_torch_round.py``, per round), each plus one quantization
step per round under the codec (a code may flip where the two trainings
differ by an ulp).

(d) The presets against the JAX presets, and the CLI on the CPU:
``--preset smoke`` (serverless now) and ``bcfl_async_pagerank`` at tiny
size.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from bcfl_tpu.compression import codecs as jcc
from bcfl_tpu.config import PartitionConfig as JPart
from bcfl_tpu.entrypoints import presets as jpresets
from bcfl_tpu_torch.entrypoints import presets as tpresets
from bcfl_tpu_torch.entrypoints.__main__ import main as cli_main

STEPS, BATCH, SEQ = 2, 4, 16
LR = 5e-5
ATOL_NONE = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return {jcc._path_name(p): torch.from_numpy(np.array(x))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_round_close(flat_j, got, rounds, step_of=lambda p: 0.0):
    far = total = 0
    for p, x in flat_j.items():
        err = np.abs(got[p].numpy() - x.numpy())
        step = step_of(p)
        assert err.max() <= rounds * 2 * LR * STEPS * 1.01 + step, p
        if not p.endswith("/key/bias"):
            far += int((err > rounds * ATOL_NONE + step).sum())
            total += err.size
    assert far <= total * 1e-4, f"{far} of {total} coordinates past atol"


ASYNC_ROUNDS = 3


def _async_configs(codec):
    from bcfl_tpu.compression import CompressionConfig as JComp
    from bcfl_tpu.config import FedConfig as JCfg, LedgerConfig as JLed
    from bcfl_tpu.config import TopologyConfig as JTopo
    from bcfl_tpu_torch.compression import CompressionConfig as TComp
    from bcfl_tpu_torch.config import (FedConfig as TCfg, LedgerConfig as TLed,
                                       PartitionConfig as TPart,
                                       TopologyConfig as TTopo)

    kw = dict(name="async", model="tiny-bert", dataset="synthetic",
              num_labels=2, mode="serverless", sync="async",
              weighted_agg=False, num_clients=10, num_rounds=ASYNC_ROUNDS,
              async_buffer=4, seq_len=SEQ, batch_size=BATCH,
              max_local_batches=STEPS, vocab_size=512, eval_every=0,
              compute_dtype="float32")
    part = dict(kind="iid", iid_samples=6, resample_each_round=True)
    comp = (dict(kind="int8+topk", topk_frac=1.0, stochastic=False)
            if codec else dict(kind="none"))
    j = JCfg(**kw, partition=JPart(**part),
             topology=JTopo(anomaly_filter="pagerank"),
             ledger=JLed(enabled=True, use_native=False),
             compression=JComp(**comp))
    t = TCfg(**kw, partition=TPart(**part),
             topology=TTopo(anomaly_filter="pagerank"),
             ledger=TLed(enabled=True), compression=TComp(**comp))
    return j, t


@pytest.mark.parametrize("codec", [False, True], ids=["none", "int8+topk"])
def test_async_engine_matches_jax_bookkeeping_and_params(monkeypatch, codec):
    import bcfl_tpu.models as jmodels
    from bcfl_tpu.fed.engine import FedEngine as JEngine
    from bcfl_tpu_torch.fed import client_step as tcs
    from bcfl_tpu_torch.fed.engine import FedEngine as TEngine

    jcfg, tcfg = _async_configs(codec)
    build = jmodels.build
    monkeypatch.setattr(jmodels, "build",
                        lambda *a, **k: build(*a, dropout_rate=0.0, **k))
    jeng = JEngine(jcfg)
    teng = TEngine(tcfg, device="cpu")
    # the same start, batches and no dropout: JAX's
    teng.trainable0 = _flat(jeng.trainable0)
    batches = {}

    def round_batches(rnd):
        if rnd not in batches:
            tree, n_ex = jeng._round_batches(rnd)
            batches[rnd] = ({k: torch.from_numpy(np.array(v))
                             for k, v in tree.items()}, np.asarray(n_ex))
        return batches[rnd]

    monkeypatch.setattr(teng, "_round_batches", round_batches)
    monkeypatch.setattr(teng, "_generators", lambda rnd: [None] * 10)
    # one quantization step per round: the largest chunk scale of each
    # leaf's payload, summed over the rounds
    steps = {}
    encode = tcs.encode_deltas_async

    def recording(*args):
        payload, resid = encode(*args)
        for p, parts in payload.items():
            steps[p] = steps.get(p, 0.0) + float(parts["s"].max())
        return payload, resid

    monkeypatch.setattr(tcs, "encode_deltas_async", recording)
    # the port's own partitioner gives the same example counts
    assert np.array_equal(TEngine._round_batches(teng, 1)[1],
                          np.asarray(jeng._round_batches(1)[1]))
    jres = jeng.run()
    tres = teng.run()
    saw_stale = False
    for rj, rt in zip(jres.metrics.rounds, tres.metrics.rounds):
        for field in ("mask", "anomalies", "auth", "staleness", "async_alpha",
                      "info_passing_sync_s", "info_passing_async_s",
                      "bytes_on_wire", "degraded"):
            assert getattr(rt, field) == getattr(rj, field), (rt.round, field)
        assert rt.anomalies == [0, 4, 7, 9] and rt.auth == [1.0] * 10
        saw_stale |= max(rt.staleness) > 0
        np.testing.assert_allclose(rt.train_loss, rj.train_loss, rtol=1e-4)
    assert saw_stale
    assert tres.metrics.ledger["chain_ok"] == 1.0 == jres.metrics.ledger[
        "chain_ok"]
    assert len(tres.ledger) == len(jres.ledger) == 10 * ASYNC_ROUNDS
    for key in ("full_weights_gb", "ledger_gb", "reduction"):
        assert tres.metrics.ledger[key] == jres.metrics.ledger[key]
    assert bool(steps) == codec
    _assert_round_close(_flat(jres.trainable), tres.trainable, ASYNC_ROUNDS,
                        lambda p: steps.get(p, 0.0))


# ------------------------------------------------- (d) presets and CLI


def test_presets_match_jax():
    jp, tp = jpresets.build_presets(), tpresets.build_presets()
    assert sorted(tp) == sorted(jp)
    fields = ("name", "model", "dataset", "num_labels", "mode", "sync",
              "weighted_agg", "num_clients", "num_rounds", "async_buffer",
              "seq_len", "max_local_batches", "staleness_decay",
              "async_server_lr")
    for name, t in tp.items():
        j = jp[name]
        for f in fields:
            assert getattr(t, f) == getattr(j, f), (name, f)
        for sub in ("partition", "topology"):
            assert (dataclasses.asdict(getattr(t, sub))
                    == dataclasses.asdict(getattr(j, sub))), (name, sub)
        assert t.ledger.enabled == j.ledger.enabled
    assert tp["smoke"].mode == "serverless"


def test_cli_drives_serverless_smoke_and_bcfl_async_on_cpu(capsys):
    assert cli_main(["--preset", "smoke", "--device", "cpu", "--rounds", "1",
                     "--seq-len", "16", "--max-local-batches", "1"]) == 0
    out = capsys.readouterr().out
    assert "mode=serverless sync=sync" in out and "round   0:" in out
    assert cli_main(["--preset", "bcfl_async_pagerank", "--device", "cpu",
                     "--model", "tiny-albert", "--dataset", "synthetic",
                     "--rounds", "2", "--seq-len", "16",
                     "--max-local-batches", "1"]) == 0
    out = capsys.readouterr().out
    assert "mode=serverless sync=async" in out
    assert "anomalies=[0, 4, 7, 9]" in out and '"chain_ok": 1.0' in out
    assert cli_main(["--preset", "smoke", "--device", "cpu", "--rounds", "1",
                     "--seq-len", "16", "--max-local-batches", "1",
                     "--gossip-steps", "0", "--anomaly-filter", "zscore",
                     "--ledger", "--sync", "sync",
                     "--compress", "int8+topk"]) == 0
    assert '"chain_ok": 1.0' in capsys.readouterr().out
