"""PyTorch port (``bcfl_tpu_torch``): the pod, the clients axis over
several processes (``FedConfig(pod=True)``, ``core.mesh``'s
``distributed_init``, ``pod_devices``, ``pod_client_mesh``).

- ``distributed_init`` is a no-op for one process and refuses a missing
  process id in JAX's words; ``pod_devices`` of one process is its own
  devices; ``pod_client_mesh(8)`` lays clients out as JAX's over the
  conftest's 8 virtual devices (the counterpart of ``tests/test_fed_tp.py``'s
  pod cases);
- the config refuses what JAX refuses under ``pod`` in JAX's words
  (``cohort_size``, ``runtime="dist"``) and every combination the port's
  pod leaves to later slices as "not ported yet";
- two processes of two CPU devices each (``scripts/pod_axis.py``'s child
  mode, gloo over loopback), 8 clients, ``int8+topk``, the ledger, 2
  rounds, server FedAvg and serverless gossip: bit for bit the one-process
  run over the same 4 client shards (the global or the consensus, every
  client's row of the final stack, every round's payload bytes, the
  ledger head, the per-client stats and evaluation, the error-feedback
  rows); process 1 ends holding process 0's final global; rows crossed
  between the processes;
- the same two-process server run against JAX's ``FedEngine(pod=True)``
  in one process over its 8 virtual devices, from JAX's initial
  parameters and batches, dropout off, at ``test_torch_clients_axis.py``'s
  tolerances;
- a process whose client shard raises fails the pod: every process exits
  nonzero on its own, none waits for the launcher's kill;
- without a GPU and without ``device="cpu"`` a pod engine raises.

Every child runs under :func:`bcfl_tpu_torch.parallel.pod.launch`'s hard
deadline and is reaped.
"""

import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import test_torch_clients_axis as ca
from bcfl_tpu_torch import config as tconfig
from bcfl_tpu_torch.compression import CompressionConfig
from bcfl_tpu_torch.config import FedConfig, LedgerConfig
from bcfl_tpu_torch.core import mesh as tmesh
from bcfl_tpu_torch.faults import FaultPlan
from bcfl_tpu_torch.fed.engine import FedEngine

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "pod_axis", ROOT / "scripts" / "pod_axis.py")
pod_axis = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(pod_axis)

#: a pod child's deadline here: set-up and two tiny runs take seconds
DEADLINE_S = 240.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    base = dict(name="pod", model="tiny-bert", dataset="synthetic",
                num_labels=2, num_clients=8, num_rounds=2, seq_len=16,
                batch_size=4, max_local_batches=2, vocab_size=512,
                eval_every=1, compute_dtype="float32",
                compression=CompressionConfig(kind="int8+topk"),
                ledger=LedgerConfig(enabled=True))
    base.update(kw)
    return FedConfig(**base)


# ------------------------------------------------------------ the mesh


def test_distributed_init_single_process_noop(monkeypatch):
    from bcfl_tpu.core.mesh import distributed_init as jinit

    monkeypatch.delenv("BCFL_NUM_PROCESSES", raising=False)
    assert tmesh.distributed_init() is False is jinit()
    assert tmesh.process_count() == 1 and tmesh.process_index() == 0
    assert tmesh.pod_devices(["cpu", "cpu"]) == [torch.device("cpu")] * 2


def test_distributed_init_requires_process_id_in_jax_words(monkeypatch):
    from bcfl_tpu.core.mesh import distributed_init as jinit

    monkeypatch.setenv("BCFL_NUM_PROCESSES", "2")
    monkeypatch.delenv("BCFL_PROCESS_ID", raising=False)
    with pytest.raises(ValueError) as want:
        jinit()
    with pytest.raises(ValueError) as got:
        tmesh.distributed_init()
    assert str(got.value) == str(want.value)
    assert "process_id" in str(got.value)


def test_pod_client_mesh_layout_matches_jax():
    from bcfl_tpu.core.mesh import pod_client_mesh as jpod_client_mesh

    jm = jpod_client_mesh(8)
    tm = tmesh.pod_client_mesh(8, local=["cpu"] * 8)
    assert tm.mesh.shape == dict(jm.mesh.shape)
    assert tm.per_device == jm.per_device == 1
    assert tm.shard_processes == [jax.devices()[s].process_index
                                  for s in range(8)] == [0] * 8
    # the pod's hosts-major layout: process p's devices after p - 1's,
    # another process's device a meta stand-in, every shard's owner known
    devs = [tmesh.PodDevice(p, torch.device("cpu"))
            for p in (0, 0, 0, 0, 1, 1, 1, 1)]
    pm = tmesh.client_mesh(8, devs)
    assert pm.shard_processes == [0, 0, 0, 0, 1, 1, 1, 1]
    assert [d.type for d in pm.client_devices] == ["cpu"] * 4 + ["meta"] * 4
    assert [pm.shard_of(c) for c in range(8)] == list(range(8))
    with pytest.raises(ValueError, match=r"process\(es\) \[1\] own none"):
        tmesh.client_mesh(3, devs)


# ----------------------------------------------------------- the config


def _both(**kw):
    from bcfl_tpu.config import FedConfig as JCfg

    out = []
    for make in (JCfg, tconfig.FedConfig):
        try:
            out.append(make(**kw))
        except ValueError as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("kw", [
    dict(registry_size=8, sample_clients=4, cohort_size=2),
    dict(runtime="dist", sync="async", eval_every=0),
], ids=["cohort_size", "runtime-dist"])
def test_pod_refusals_in_jax_words(kw):
    want, got = _both(pod=True, **kw)
    assert isinstance(want, str) and got == want


NOT_PORTED = [
    ("rounds_per_dispatch", dict(rounds_per_dispatch=2)),
    ("sync", dict(sync="async", mode="serverless")),
    ("faults.partition_groups", dict(
        mode="serverless", topology=tconfig.TopologyConfig(gossip_steps=0),
        faults=FaultPlan(partition_groups=((0, 1), (2, 3)),
                         partition_rounds=(1,)))),
    ("tp", dict(tp=2, lora_rank=2, model="tiny-llama")),
    ("sp", dict(sp=2, model="tiny-llama", task="causal_lm")),
    ("faithful", dict(faithful=True, mode="serverless")),
    ("registry_size", dict(registry_size=8, sample_clients=4)),
    ("checkpoint_every", dict(checkpoint_dir="ck", checkpoint_every=1)),
]


@pytest.mark.parametrize("field,kw", NOT_PORTED, ids=[f for f, _ in NOT_PORTED])
def test_pod_combinations_not_ported_yet(field, kw):
    tconfig.FedConfig(num_clients=4, **kw)  # ported without a pod
    with pytest.raises(ValueError, match=f"{field}=.*not ported yet"):
        tconfig.FedConfig(num_clients=4, pod=True, **kw)


def test_pod_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FedEngine(_cfg(pod=True))
    # the CLI's flag reaches the config
    from bcfl_tpu_torch.entrypoints.__main__ import (build_config,
                                                      build_parser)

    assert build_config(build_parser().parse_args(
        ["--pod", "--device", "cpu"])).pod


# ------------------------------------------------------- two processes

#: the two bit-for-bit legs (and the JAX run) share one pod's start-up
LEGS = {"server": dict(mode="server"), "gossip": dict(mode="serverless")}
JAX_ROUNDS = 2
JAX_COMP = dict(kind="int8+topk", topk_frac=1.0, stochastic=False)
JAX_KW = dict(name="pod", model="tiny-bert", dataset="synthetic",
              num_labels=2, mode="server", num_clients=8,
              num_rounds=JAX_ROUNDS, seq_len=16, batch_size=4,
              max_local_batches=2, vocab_size=512, eval_every=0,
              compute_dtype="float32")


def _pod(tmp_path, runs, **kw):
    return pod_axis.run_pod(runs, 2, tmp_path / "pod", threads=1,
                            deadline_s=DEADLINE_S, **kw)


def _jax_pod_run():
    """JAX's ``FedEngine(pod=True)`` in this process over its 8 virtual
    devices, dropout off: its result and its initial parameters and
    per-round batches."""
    import bcfl_tpu.models as jmodels
    from bcfl_tpu.compression import CompressionConfig as JComp
    from bcfl_tpu.config import FedConfig as JCfg, LedgerConfig as JLed
    from bcfl_tpu.fed.engine import FedEngine as JEngine

    mp = pytest.MonkeyPatch()
    build = jmodels.build
    mp.setattr(jmodels, "build",
               lambda *a, **k: build(*a, dropout_rate=0.0, **k))
    try:
        jeng = JEngine(JCfg(**JAX_KW, pod=True, compression=JComp(**JAX_COMP),
                            ledger=JLed(enabled=True, use_native=False)))
        assert jeng.mesh.n_devices == 8 and jeng.mesh.per_device == 1
        inputs = {"trainable0": ca._flat(jeng.trainable0), "batches": {},
                  "n_ex": {}}
        for rnd in range(JAX_ROUNDS):
            tree, n_ex = jeng._round_batches(rnd)
            inputs["batches"][rnd] = {k: torch.from_numpy(np.array(v))
                                      for k, v in tree.items()}
            inputs["n_ex"][rnd] = np.asarray(n_ex)
        return jeng.run(), inputs
    finally:
        mp.undo()


def _assert_leg_equals_one_process(leg, recs):
    cfg = _cfg(**LEGS[leg])
    assert [r["process"] for r in recs] == [0, 1]
    assert recs[0]["shard_processes"] == [0, 0, 1, 1]
    pod = pod_axis.merged(recs)  # raises unless rank 1 holds rank 0's
    one = pod_axis.one_process(cfg, ["cpu"] * 4)
    assert one["shards"] == pod["shards"] == 4
    assert pod_axis.differences(one, pod) == [], leg
    assert len(pod["payloads"]) == cfg.num_rounds
    assert all(p is not None for p in pod["payloads"])
    assert recs[1]["payloads"] == [None] * cfg.num_rounds
    assert pod["ledger_head"] and pod["chain_ok"] == 1.0
    if cfg.mode == "serverless":
        assert sorted(pod["rows"]) == list(range(8))
        assert sorted(recs[1]["rows"]) == [4, 5, 6, 7]
    assert one["traffic"][-1]["process_sent"] == 0
    assert one["traffic"][-1]["process_received"] == 0
    # rows cross every round, and what one process sent the other received
    sent = [pod_axis.per_round(r["traffic"], "process_sent") for r in recs]
    got = [pod_axis.per_round(r["traffic"], "process_received")
           for r in recs]
    assert min(sent[0]) > 0 and min(sent[1]) > 0, sent
    assert sent[0] == got[1] and sent[1] == got[0], (sent, got)


def _assert_near_jax(jres, recs):
    lead = recs[0]
    for rj, rt in zip(jres.metrics.rounds, lead["records"]):
        for field in ("mask", "auth", "bytes_on_wire", "degraded"):
            assert rt[field] == getattr(rj, field), (rj.round, field)
        np.testing.assert_allclose(rt["train_loss"], rj.train_loss,
                                   rtol=1e-4)
    assert lead["chain_ok"] == 1.0 == jres.metrics.ledger["chain_ok"]
    steps = {}
    for scales in lead["scales"]:
        for p, s in scales.items():
            steps[p] = steps.get(p, 0.0) + s
    ca._assert_global_near_jax(
        jres, types.SimpleNamespace(trainable=lead["trainable_t"]), steps,
        JAX_ROUNDS)
    # every process ends holding process 0's final global
    assert recs[1]["trainable"] == lead["trainable"]


def test_two_processes_equal_one_process_and_match_jax(tmp_path):
    """One pod of two processes runs the two bit-for-bit legs and, from
    JAX's initial parameters and batches, the JAX leg (one start-up for
    the three)."""
    jres, inputs = _jax_pod_run()
    jcfg = FedConfig(**JAX_KW, compression=CompressionConfig(**JAX_COMP),
                     ledger=LedgerConfig(enabled=True))
    runs = [{"label": k, "cfg": _cfg(**kw), "devices": ["cpu", "cpu"]}
            for k, kw in LEGS.items()]
    runs.append({"label": "jax", "cfg": jcfg, "devices": ["cpu", "cpu"],
                 "save": True, "inputs": inputs})
    got = _pod(tmp_path, runs)
    for leg in LEGS:
        _assert_leg_equals_one_process(leg, got[leg])
    _assert_near_jax(jres, got["jax"])


def test_a_failing_process_fails_the_pod(tmp_path):
    got = _pod(tmp_path, [{"label": "fail", "cfg": _cfg(num_rounds=1),
                           "devices": ["cpu", "cpu"]}], fail_rank=1)
    launch = got["_launch"]
    assert all(rc not in (0, None) for rc in launch["returncodes"]), launch
    assert launch["killed"] == [], launch
    assert "a client shard's body failed" in launch["logs"][1]
    assert launch["wall_s"] < tmesh.POD_TIMEOUT_S
