"""The port's multi-process runtime (``bcfl_tpu_torch/dist``) against the
JAX package: the capability table's verdicts, the config's JSON crossing,
the measured staleness, the leader's FedBuff merge step, and one 2-peer
loopback run on the CPU held to every assertion JAX's own loopback test
makes (``tests/test_dcn_proof.py::test_dist_loopback_two_peers``)."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from bcfl_tpu import config as jconfig
from bcfl_tpu.compression import CompressionConfig as JComp
from bcfl_tpu.dist import runtime as jrt
from bcfl_tpu.faults import FaultPlan as JPlan
from bcfl_tpu.reputation import ReputationConfig as JRep
from bcfl_tpu_torch import config as tconfig
from bcfl_tpu_torch.compression import CompressionConfig
from bcfl_tpu_torch.dist import launch, runtime
from bcfl_tpu_torch.faults import FaultPlan
from bcfl_tpu_torch.reputation import ReputationConfig

pytestmark = pytest.mark.dist

# (name, FedConfig overrides) — each names a capability row's feature
GRID = [
    ("base", {}),
    ("serverless", {"mode": "serverless"}),
    ("sync", {"sync": "sync"}),
    ("faithful", {"faithful": True}),
    ("registry", {"registry_size": 8}),
    ("tp", {"tp": 2}),
    ("sp", {"sp": 2}),
    ("fused", {"rounds_per_dispatch": 2}),
    ("anomaly", {"topology": "pagerank"}),
    ("reputation", {"reputation": True}),
    ("robust", {"aggregator": "median"}),
    ("compression", {"compression": "int8+topk"}),
    ("ledger", {"ledger": True}),
    ("partition", {"faults": dict(partition_rounds=(1,),
                                  partition_count=2)}),
    ("straggler", {"faults": dict(straggler_prob=0.5)}),
    ("dropout", {"faults": dict(dropout_prob=0.5)}),
    ("corrupt", {"faults": dict(corrupt_prob=0.5)}),
    ("wire", {"faults": dict(wire_drop_prob=0.1)}),
    ("byz", {"faults": dict(byz_peers=(1,))}),
    ("churn", {"faults": dict(churn_leave=((1, 1),))}),
    ("crash", {"faults": dict(crash_at_round=1)}),
    ("storage", {"faults": dict(storage_prob=0.5)}),
    ("limp", {"faults": dict(limp_prob=0.5)}),
    ("resource", {"faults": dict(resource_prob=0.5)}),
    ("gossip", {"dispatch": "gossip"}),
    ("gossip_partition", {"dispatch": "gossip",
                          "faults": dict(partition_rounds=(1,),
                                         partition_count=2)}),
    ("gossip_compress", {"dispatch": "gossip", "compression": "int8"}),
    ("gossip_krum", {"dispatch": "gossip", "aggregator": "krum"}),
    ("eval", {"eval_every": 1}),
    ("lora", {"lora_rank": 2}),
    ("hetero_lora", {"lora_ranks": "2,4"}),
]


def _ns(pkg: str, runtime_: str, over: dict):
    """A stand-in config carrying what the capability rows read (the
    table is evaluated on it directly, so a combination FedConfig would
    refuse for another reason still gets its row verdicts)."""
    port = pkg == "port"
    plan = (FaultPlan if port else JPlan)(**over.get("faults", {}))
    comp = (CompressionConfig if port else JComp)(
        kind=over.get("compression", "none"))
    rep = (ReputationConfig if port else JRep)(
        enabled=over.get("reputation", False))
    return types.SimpleNamespace(
        runtime=runtime_, mode=over.get("mode", "server"),
        sync=over.get("sync", "async"), faithful=over.get("faithful", False),
        registry_size=over.get("registry_size", 0), tp=over.get("tp", 1),
        sp=over.get("sp", 1), pod=False, donate=False,
        rounds_per_dispatch=over.get("rounds_per_dispatch", 1),
        topology=types.SimpleNamespace(
            anomaly_filter=over.get("topology")),
        reputation=rep, aggregator=over.get("aggregator", "mean"),
        compression=comp,
        ledger=types.SimpleNamespace(enabled=over.get("ledger", False)),
        faults=plan,
        dist=types.SimpleNamespace(dispatch=over.get("dispatch", "leader")),
        eval_every=over.get("eval_every", 0),
        lora_rank=over.get("lora_rank", 0),
        lora_ranks=over.get("lora_ranks", ""))


@pytest.mark.parametrize("runtime_", ["local", "dist"])
@pytest.mark.parametrize("name,over", GRID, ids=[g[0] for g in GRID])
def test_runtime_caps_verdicts_equal_jax(name, over, runtime_):
    want = {f: (bool(a(_ns("jax", runtime_, over))), v[runtime_])
            for f, a, v in jconfig.RUNTIME_CAPS}
    got = {f: (bool(a(_ns("port", runtime_, over))), v[runtime_])
           for f, a, v in tconfig.RUNTIME_CAPS}
    # the port leaves out the row of the field it does not have
    assert set(want) - set(got) == {"buffer donation"}
    assert set(got) <= set(want)
    # no feature is deferred any more: every row's verdict is JAX's
    for f, (active, verdict) in got.items():
        assert active == want[f][0], f
        assert verdict == want[f][1], f


def _cfgs(over):
    """The same config in both packages, or the error each raises."""
    out = {}
    for pkg, mod, plan, comp, rep in (
            ("port", tconfig, FaultPlan, CompressionConfig, ReputationConfig),
            ("jax", jconfig, JPlan, JComp, JRep)):
        kw = dict(runtime="dist", sync=over.get("sync", "async"),
                  mode=over.get("mode", "server"), num_clients=8,
                  eval_every=over.get("eval_every", 0),
                  aggregator=over.get("aggregator", "mean"),
                  faults=plan(**over.get("faults", {})),
                  compression=comp(kind=over.get("compression", "none")),
                  reputation=rep(enabled=over.get("reputation", False)),
                  ledger=mod.LedgerConfig(enabled=over.get("ledger", False)),
                  dist=mod.DistConfig(
                      peers=4, checkpoint_every_versions=0, buffer=2,
                      dispatch=over.get("dispatch", "leader")))
        for k in ("faithful", "tp", "sp", "rounds_per_dispatch",
                  "lora_rank", "lora_ranks", "registry_size"):
            if k in over:
                kw[k] = over[k]
        try:
            out[pkg] = mod.FedConfig(**kw)
        except ValueError as e:
            out[pkg] = str(e)
    return out


CONSTRUCT = [g for g in GRID if g[0] not in ("anomaly", "gossip_krum")]


@pytest.mark.parametrize("name,over", CONSTRUCT,
                         ids=[g[0] for g in CONSTRUCT])
def test_dist_configs_construct_or_refuse_as_jax(name, over):
    """Every dist config constructs in the port exactly when it does in
    JAX, refusing with JAX's own message, except the deferred features,
    which the port refuses as "not ported yet"."""
    got, want = _cfgs(over)["port"], _cfgs(over)["jax"]
    if isinstance(got, str) and "not ported yet" in got:
        return
    if isinstance(want, str) or isinstance(got, str):
        assert got == want
    else:
        assert got.runtime == want.runtime == "dist"


def test_deferred_dist_features_raise_not_ported_yet():
    # no dist feature of the grid is deferred any more: the ported
    # fault-tolerance, adversarial and chaos halves, gossip dispatch and
    # LoRA over dist run; partitions, reputation, the byzantine, wire,
    # limp and resource lanes, gossip and uniform-rank adapters run, the
    # robust rules take JAX's buffer preconditions, churn and host crash
    # JAX's own rejections, the storage lane JAX's checks, gossip JAX's
    # refusals of compression, heterogeneous ranks JAX's refusal
    for name, over in GRID:
        got = _cfgs(over)["port"]
        assert not (isinstance(got, str) and "not ported yet" in got), name
    for name in ("partition", "churn", "crash", "storage", "reputation",
                 "robust", "byz", "wire", "limp", "resource", "gossip",
                 "gossip_partition", "gossip_compress", "lora",
                 "hetero_lora"):
        over = dict(GRID)[name]
        got, want = _cfgs(over)["port"], _cfgs(over)["jax"]
        assert not (isinstance(got, str) and "not ported yet" in got), name
        assert (got if isinstance(got, str) else "ok") == (
            want if isinstance(want, str) else "ok"), name
    assert tconfig.FedConfig(runtime="dist", sync="async", eval_every=0,
                             dist=tconfig.DistConfig(peers=2)
                             ).dist.checkpoint_every_versions == 1
    assert tconfig.FedConfig(
        runtime="dist", sync="async", eval_every=0,
        dist=tconfig.DistConfig(peers=4, dispatch="gossip",
                                checkpoint_every_versions=0)
    ).dist.dispatch == "gossip"
    # Llama over dist constructs, with JAX's verdicts
    llama = {}
    for pkg, mod in (("port", tconfig), ("jax", jconfig)):
        llama[pkg] = mod.FedConfig(
            runtime="dist", sync="async", eval_every=0, model="tiny-llama",
            dist=mod.DistConfig(peers=2, checkpoint_every_versions=0))
    assert llama["port"].model == llama["jax"].model == "tiny-llama"
    assert ([(f, a, v) for f, a, v in tconfig.capability_table(llama["port"])]
            == [(f, a, v) for f, a, v in
                jconfig.capability_table(llama["jax"])
                if f != "buffer donation"])


def _dist_cfg(**kw):
    base = dict(
        name="dist_smoke", runtime="dist", mode="server", sync="async",
        model="tiny-bert", dataset="synthetic", num_clients=4, num_rounds=3,
        seq_len=16, batch_size=4, max_local_batches=2, eval_every=0,
        vocab_size=512,
        partition=tconfig.PartitionConfig(kind="iid", iid_samples=8),
        ledger=tconfig.LedgerConfig(enabled=True),
        compression=CompressionConfig(kind="int8+topk"),
        dist=tconfig.DistConfig(peers=2, buffer_timeout_s=5.0,
                                idle_timeout_s=60.0, peer_deadline_s=150.0,
                                checkpoint_every_versions=0))
    base.update(kw)
    return tconfig.FedConfig(**base)


def test_cfg_json_round_trip():
    cfg = _dist_cfg(faults=FaultPlan(straggler_prob=0.5,
                                     straggler_rounds=(1, 2)),
                    param_dtype="bfloat16")
    back = launch.cfg_from_json(launch.cfg_to_json(cfg))
    assert back == cfg
    assert isinstance(back.faults.straggler_rounds, tuple)
    assert launch.cfg_from_json(launch.cfg_to_json(
        dataclasses.replace(cfg, faults=None))).faults is None
    with pytest.raises(ValueError, match="unknown fields"):
        launch.cfg_from_json(launch.cfg_to_json(cfg).replace(
            '"num_rounds"', '"num_roundz"'))


@pytest.mark.parametrize("leader,base", [(5, 5), (5, 2), (0, 0), (2, 7)])
def test_measured_staleness_equals_jax(leader, base):
    assert runtime.measured_staleness(leader, base) == \
        jrt.measured_staleness(leader, base)


def test_apply_merge_equals_jax():
    """The leader's FedBuff step: the port's ``_apply_merge`` against
    JAX's ``PeerRuntime._apply_merge`` called on a stand-in ``self`` whose
    engine is the JAX ``FedEngine`` of ``_peer_engine_cfg``, with the same
    deltas and alphas (rtol 1e-6)."""
    import jax
    import jax.numpy as jnp

    from bcfl_tpu.fed.engine import FedEngine as JEngine
    from bcfl_tpu_torch.fed.engine import FedEngine

    jcfg = jconfig.FedConfig(
        runtime="dist", sync="async", model="tiny-bert",
        dataset="synthetic", num_clients=4, seq_len=16, batch_size=4,
        max_local_batches=1, eval_every=0, vocab_size=512,
        partition=jconfig.PartitionConfig(kind="iid", iid_samples=8),
        staleness_decay=0.5, async_server_lr=0.7,
        dist=jconfig.DistConfig(peers=2, checkpoint_every_versions=0))
    jeng = JEngine(jrt._peer_engine_cfg(jcfg, 2))
    flat = jax.tree_util.tree_flatten_with_path(jeng.trainable0)[0]
    names = ["/".join(str(getattr(p, "key", p)) for p in path)
             for path, _ in flat]
    rng = np.random.default_rng(0)
    base = [np.asarray(x, np.float32) for _, x in flat]
    updates = []
    for staleness in (0, 2, 1):
        deltas = [rng.normal(size=(2,) + b.shape).astype(np.float32) * 1e-2
                  for b in base]
        n_ex = np.array([4.0, 6.0], np.float32)
        alpha = (np.ones(2, np.float32) * np.float32(0.5 ** staleness)
                 * n_ex)
        updates.append((deltas, alpha, float(n_ex.sum())))

    jself = types.SimpleNamespace(
        eng=jeng, cfg=jcfg,
        trainable=jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jeng.trainable0),
            [jnp.asarray(b) for b in base]))
    jrt.PeerRuntime._apply_merge(jself, [
        {"deltas": jeng.mesh.shard_clients(jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jeng.trainable0),
            [jnp.asarray(d) for d in deltas])),
         "alpha": alpha, "base_w": bw} for deltas, alpha, bw in updates])
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jself.trainable)]

    tcfg = _dist_cfg(staleness_decay=0.5, async_server_lr=0.7,
                     compression=CompressionConfig(kind="none"))
    teng = FedEngine(runtime._peer_engine_cfg(tcfg, 2), device="cpu")
    # a runtime shell (no sockets, no threads) holding what the step reads
    tself = runtime.PeerRuntime.__new__(runtime.PeerRuntime)
    tself.__dict__.update(
        eng=teng, cfg=tcfg, device=torch.device("cpu"),
        trainable={n: torch.from_numpy(b.copy()) for n, b in zip(names,
                                                                 base)})
    tself._apply_merge([
        {"deltas": {n: torch.from_numpy(d) for n, d in zip(names, deltas)},
         "alpha": alpha, "base_w": bw} for deltas, alpha, bw in updates])
    for n, w in zip(names, want):
        np.testing.assert_allclose(tself.trainable[n].numpy(), w,
                                   rtol=1e-6, atol=1e-7, err_msg=n)


def test_dist_loopback_two_peers(tmp_path):
    """Two port peer processes over loopback, on the CPU: every assertion
    of JAX's ``test_dist_loopback_two_peers``."""
    from bcfl_tpu_torch.dist import run_dist
    from bcfl_tpu_torch.telemetry import collate_run

    # buffer=2: each merge waits (up to buffer_timeout_s) for both peers'
    # updates. A peer is a fresh interpreter, and on a loaded host one can
    # start seconds after the other; with merge-on-arrival (buffer 0) a
    # leader that starts first can reach the target version on its own
    # updates alone (seen under the full xdist suite), leaving nothing to
    # be stale. Waiting for the follower makes its in-flight updates, based
    # on the version before the broadcast it has not adopted yet, merge
    # one version late.
    cfg = _dist_cfg(dist=tconfig.DistConfig(
        peers=2, buffer=2, buffer_timeout_s=20.0, idle_timeout_s=60.0,
        peer_deadline_s=150.0, checkpoint_every_versions=0))
    result = run_dist(cfg, str(tmp_path / "run"), deadline_s=170.0,
                      device="cpu", threads=2)
    assert result["process_count"] == 2
    assert result["returncodes"] == {"0": 0, "1": 0}, result["log_tails"]
    assert result["ok"], result["log_tails"]
    reports = result["reports"]
    assert all(reports[p]["status"] == "ok" for p in (0, 1))
    assert all(reports[p]["final_version"] >= cfg.num_rounds for p in (0, 1))
    # the staleness distribution is MEASURED (arrival order), and the
    # concurrent follower is genuinely stale
    staleness = [s for p in (0, 1) for s in reports[p]["staleness_values"]]
    assert staleness and any(s > 0 for s in staleness), staleness
    # every peer's chain replica verifies, and the replicas agree
    assert all(reports[p]["chain_ok"] for p in (0, 1))
    assert reports[0]["chain_head"] == reports[1]["chain_head"]
    assert reports[0]["final_eval"] is not None
    # every merged arrival authenticated against its announced digests
    assert all(a["auth"] == [1.0, 1.0] for m in reports[0]["merges"]
               for a in m["arrivals"])
    # the adversarial surfaces with their lanes off: JAX's exact
    # off-report, and no tracker
    for p in (0, 1):
        assert reports[p]["byzantine"] == {"armed": False, "injected": {},
                                           "total": 0}
        assert reports[p]["reputation"] is None
        assert reports[p]["restored_reputation"] is None
        assert all(m["robust"] is None and not m["robust_degraded"]
                   for m in reports[p]["merges"])
    # the report's port fields: the kernel counters (the CPU runs the
    # plain versions: no launch) and no device peak on the CPU
    assert reports[1]["kernel_launches"]["topk_select"] == 0
    assert reports[1]["peak_gb"] is None
    # telemetry: both peers streamed, the causal timeline has zero
    # invariant violations
    assert len(result["event_streams"]) == 2, result["event_streams"]
    col = collate_run(result["run_dir"])
    assert col["ok"], col["violations"]
    t = col["timeline"]
    assert t["merges"]["count"] >= cfg.num_rounds
    assert t["merges"]["arrivals"] == t["merges"]["unique_update_ids"]
    assert t["message_latency_s"]["n"] > 0
    assert any(int(k) > 0 for k in t["staleness"])
    # both peers closed their streams cleanly (run.end) and flushed
    ends = [e for e in col["ordered"] if e["ev"] == "run.end"]
    assert {e["peer"] for e in ends} == {0, 1}


def test_cli_runs_dist_and_refuses_its_deferred_flags(tmp_path, capsys,
                                                     monkeypatch):
    from bcfl_tpu_torch.entrypoints.__main__ import main as cli

    # the CLI has no thread flag: one CPU thread per spawned peer, as the
    # other loopback runs use, so that peers under a busy xdist suite do
    # not oversubscribe the host past the 150 s deadline
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rc = cli(["--preset", "smoke", "--device", "cpu", "--runtime", "dist",
              "--peers", "2", "--clients", "4", "--rounds", "2",
              "--seq-len", "16", "--batch-size", "4",
              "--max-local-batches", "1", "--ledger", "--compress", "int8",
              "--dist-buffer", "2", "--dist-quorum", "0.5",
              "--dist-pipeline-depth", "3", "--dist-deadline", "150",
              "--dist-run-dir", str(tmp_path / "cli")])
    out = capsys.readouterr().out
    assert rc == 0, out
    import json

    summary = json.loads(out)
    assert summary["ok"] and summary["invariants_ok"]
    assert summary["final_versions"] == {"0": 2, "1": 2}
    for flags, msg in ((["--peers", "2"], "only applies to --runtime dist"),
                       (["--runtime", "dist", "--resume"],
                        "peer crash/rejoin is driven by")):
        with pytest.raises(SystemExit, match=msg):
            cli(["--preset", "smoke", "--device", "cpu", "--clients", "4"]
                + flags)
