"""The port's partition, fork and heal path (``bcfl_tpu_torch/dist``)
against the JAX package: ``PartitionGate`` with a plan over a grid of
peers and local rounds; the global leader's reconcile (``_handle_reconcile``)
beside JAX's on stand-in runtimes, its merged chain byte for byte and its
model consensus at rtol 1e-6; the capability rows of partitions, storage
faults, churn and host crash with JAX's verdicts; and a 2-peer loopback
run on the CPU with a partition and a SIGKILLed, resumed peer that passes
every gate of ``scripts/dist_async.py``'s ``analyze``, with
``build_cfg``'s settings."""

import importlib.util
import os
import types

import numpy as np
import pytest
import torch

from bcfl_tpu import config as jconfig
from bcfl_tpu.dist import runtime as jrt
from bcfl_tpu.dist import transport as jtr
from bcfl_tpu.faults import FaultPlan as JPlan
from bcfl_tpu.ledger import ledger as jl
from bcfl_tpu_torch import config as tconfig
from bcfl_tpu_torch.compression import CompressionConfig
from bcfl_tpu_torch.dist import runtime as trt
from bcfl_tpu_torch.dist import transport as ttr
from bcfl_tpu_torch.faults import FaultPlan
from bcfl_tpu_torch.ledger import ledger as tl

pytestmark = pytest.mark.dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ the gate


PLANS = [
    dict(partition_groups=((0, 1), (2, 3, 4)), partition_rounds=(2, 3, 4)),
    dict(partition_groups=((0,),), partition_rounds=(1, 5)),
    dict(partition_count=2, partition_rounds=(0, 1, 2), seed=3),
    dict(partition_count=3, partition_rounds=tuple(range(4, 9)), seed=8),
    dict(),
]


@pytest.mark.parametrize("kw", PLANS, ids=[str(i) for i in range(len(PLANS))])
def test_partition_gate_equals_jax(kw):
    peers = 5
    clock = {"r": 0}
    t = ttr.PartitionGate(FaultPlan(**kw) if kw else None, peers,
                          version_fn=lambda: clock["r"])
    j = jtr.PartitionGate(JPlan(**kw) if kw else None, peers,
                          version_fn=lambda: clock["r"])
    for r in range(10):
        clock["r"] = r
        assert t.components() == j.components(), r
        # unknown senders (out of range, -1) included: dropped, no crash
        for a in range(-1, peers + 1):
            assert t.component_of(a) == j.component_of(a), (r, a)
            for b in range(-1, peers + 1):
                assert t.allowed(a, b) == j.allowed(a, b), (r, a, b)


def test_gate_drops_count_on_send_and_receive():
    """A blocked pair is dropped at the sender and, on the receiver's own
    clock, at the receiver: both count in dropped_by_gate."""
    from bcfl_tpu_torch.dist import free_ports

    clock = {"r": 0}
    plan = FaultPlan(partition_groups=((0,), (1,)), partition_rounds=(5,))
    ports = free_ports(2)
    addrs = [("127.0.0.1", p) for p in ports]
    a = ttr.PeerTransport(0, addrs, gate=ttr.PartitionGate(
        plan, 2, lambda: clock["r"]))
    b = ttr.PeerTransport(1, addrs, gate=ttr.PartitionGate(
        plan, 2, lambda: 5))
    a.start()
    b.start()
    try:
        assert a.send(1, {"type": "ping"}) is True  # a's clock: no span
        assert b.recv(timeout_s=2.0) is None
        assert b.stats()["dropped_by_gate"] == 1
        clock["r"] = 5
        assert a.send(1, {"type": "ping"}) is False
        assert a.send_async(1, {"type": "ping"}) is False
        assert a.stats()["dropped_by_gate"] == 2
    finally:
        a.close()
        b.close()


# ------------------------------------------------------------ the reconcile


def _chains(mod, tree, prefix=3, k=2):
    a = mod.Ledger()
    for i in range(prefix):
        a.append(0, i, tree(i))
    b = mod.Ledger.from_json(a.to_json())
    for i in range(k):
        a.append(1 + i, 0, tree(100 + i))
        b.append(1 + i, 2, tree(200 + i))
    return a, b


def _np_tree(i):
    rng = np.random.default_rng(i)
    return {"w": rng.normal(size=(3, 2)).astype(np.float32)}


def _stand_in(mod, chain, trainable, solo_arrivals):
    """A runtime shell with exactly what ``_handle_reconcile`` reads."""
    merges = [types.SimpleNamespace(solo=True, arrivals=[{}] * n)
              for n in solo_arrivals]
    merges.append(types.SimpleNamespace(solo=False, arrivals=[{}] * 9))
    rt = types.SimpleNamespace(
        cfg=types.SimpleNamespace(ledger=types.SimpleNamespace(
            use_native=True)),
        peer_id=0, chain=chain, trainable=trainable, version=7,
        merges=merges, reconcile=None, broadcasts=[], _reconciled={})
    rt._head = lambda: rt.chain.head.hex()
    rt._note_version = lambda: None
    rt._maybe_checkpoint = lambda: None
    rt._broadcast_global = lambda healed, full=False: rt.broadcasts.append(
        healed)
    rt._solo_weight = lambda: mod.PeerRuntime._solo_weight(rt)
    rt._cast = lambda t: t
    return rt


@pytest.mark.parametrize("tamper", [False, True])
def test_handle_reconcile_equals_jax(tamper):
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    names = ["enc/w", "enc/b", "head/w"]
    shapes = [(16, 8), (8,), (8, 3)]
    mine = [rng.normal(size=s).astype(np.float32) for s in shapes]
    theirs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    ja, jb = _chains(jl, _np_tree)
    ta, tb = _chains(tl, lambda i: {k: torch.from_numpy(v)
                                    for k, v in _np_tree(i).items()})
    rows = tb.segment(0)
    assert rows == jb.segment(0)
    if tamper:
        rows = [dict(r) for r in rows]
        rows[4]["digest"] = "ff" * 32
    header = {"from": 2, "version": 5, "rows": rows, "weight": 3.0}

    jself = _stand_in(jrt, ja, {n: jnp.asarray(x) for n, x in
                                zip(names, mine)}, [2, 1])
    jrt.PeerRuntime._handle_reconcile(
        jself, header, {"model": {n: jnp.asarray(x)
                                  for n, x in zip(names, theirs)}})
    tself = _stand_in(trt, ta, {n: torch.from_numpy(x.copy()) for n, x in
                                zip(names, mine)}, [2, 1])
    trt.PeerRuntime._handle_reconcile(
        tself, header, {"model": {n: torch.from_numpy(x.copy())
                                  for n, x in zip(names, theirs)}})

    jrec, trec = jself.reconcile, tself.reconcile
    assert set(trec) == set(jrec)
    for key in jrec:
        if key != "wall_s":
            assert trec[key] == jrec[key], key
    assert tself.broadcasts == jself.broadcasts == [not tamper]
    assert tself.chain.to_json() == jself.chain.to_json()
    assert tself.version == jself.version
    if tamper:
        assert trec["segment_rejected_at"] == 1  # row 4, past the fork at 3
        return
    assert trec["forked"] and trec["fork_point"] == 3
    assert trec["merged_entries"] == 4 and trec["chain_ok"]
    for n in names:
        np.testing.assert_allclose(tself.trainable[n].numpy(),
                                   np.asarray(jself.trainable[n]),
                                   rtol=1e-6, atol=0, err_msg=n)
    # a retried offer of the merged fork is answered with the healed state
    # and merged no second time (JAX would merge it again)
    sent = []
    tself.transport = types.SimpleNamespace(
        send=lambda to, h, trees: sent.append((to, h["healed"],
                                               h["chain_start"])))
    tself._global_frame = lambda start, healed=False: trt.PeerRuntime.\
        _global_frame(tself, start, healed)
    before = {n: x.clone() for n, x in tself.trainable.items()}
    version, chain = tself.version, tself.chain.to_json()
    trt.PeerRuntime._handle_reconcile(
        tself, header, {"model": {n: torch.from_numpy(x.copy())
                                  for n, x in zip(names, theirs)}})
    assert sent == [(2, True, 0)]
    assert tself.version == version and tself.chain.to_json() == chain
    assert all(torch.equal(before[n], tself.trainable[n]) for n in names)


# ------------------------------------------------------------ capability rows


ROWS = ("chaos: transport partition", "chaos: churn", "chaos: host crash",
        "chaos: storage faults")


def _verdicts(faults):
    out = {}
    for pkg, mod, plan in (("port", tconfig, FaultPlan),
                           ("jax", jconfig, JPlan)):
        ns = types.SimpleNamespace(faults=plan(**faults))
        out[pkg] = {f: (bool(a(ns)), v["dist"])
                    for f, a, v in mod.RUNTIME_CAPS if f in ROWS}
    return out


@pytest.mark.parametrize("faults", [
    dict(partition_groups=((0,), (1,)), partition_rounds=(1,)),
    dict(storage_prob=0.5),
    dict(sync_tamper=((0, 1),)),
    dict(churn_leave=((1, 1),)),
    dict(crash_at_round=2),
], ids=["partition", "storage", "sync_tamper", "churn", "crash"])
def test_dist_capability_rows_equal_jax(faults):
    got = _verdicts(faults)
    assert len(got["port"]) == 4
    assert got["port"] == got["jax"]
    kw = dict(runtime="dist", sync="async", eval_every=0, num_clients=4,
              ledger_on=True)
    for pkg, mod, plan in (("port", tconfig, FaultPlan),
                           ("jax", jconfig, JPlan)):
        kw_pkg = dict(kw)
        kw_pkg.pop("ledger_on")
        try:
            res = mod.FedConfig(ledger=mod.LedgerConfig(enabled=True),
                                faults=plan(**faults),
                                dist=mod.DistConfig(peers=2), **kw_pkg)
        except ValueError as e:
            res = str(e)
        got[pkg] = res if isinstance(res, str) else "ok"
    assert got["port"] == got["jax"]


# ------------------------------------------------------------ 2-peer run


def _dist_async():
    spec = importlib.util.spec_from_file_location(
        "dist_async", os.path.join(REPO, "scripts", "dist_async.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_two_peer_partition_and_kill_passes_dist_async_gates(tmp_path):
    """``build_cfg``'s run (tiny-bert, 4 clients, 8 versions, seq 16,
    stragglers 0.3 / 0.5 s, a checkpoint every version, partition 2:4 over
    peers (0,) | (1,), peer 1 SIGKILLed after its first checkpoint and
    restarted with --resume) through the port, graded by JAX's own
    ``analyze``. ``buffer=2`` makes the whole-network leader wait for both
    peers (a component of one merges alone), so the leader cannot run to
    the target before the follower is up."""
    from bcfl_tpu_torch.dist import run_dist

    cfg = tconfig.FedConfig(
        name="dist_async", runtime="dist", mode="server", sync="async",
        model="tiny-bert", dataset="synthetic", num_clients=4, num_rounds=8,
        seq_len=16, batch_size=4, max_local_batches=2, eval_every=0,
        seed=42, vocab_size=512,
        partition=tconfig.PartitionConfig(kind="iid", iid_samples=8),
        ledger=tconfig.LedgerConfig(enabled=True),
        compression=CompressionConfig(kind="int8+topk"),
        faults=FaultPlan(straggler_prob=0.3, straggler_delay_s=0.5,
                         partition_groups=((0,), (1,)),
                         partition_rounds=(2, 3)),
        dist=tconfig.DistConfig(peers=2, buffer=2, buffer_timeout_s=10.0,
                                idle_timeout_s=120.0, peer_deadline_s=240.0,
                                checkpoint_every_versions=1))
    result = run_dist(cfg, str(tmp_path / "run"), deadline_s=260.0,
                      device="cpu", threads=2, kill_peer=1)
    record = _dist_async().analyze(result, cfg, partitioned=True, killed=1)
    assert record["ok"], (record["gates"], result["log_tails"])
    assert set(record["gates"]) == {
        "all_peers_completed", "staleness_measured_nonzero",
        "zero_invariant_violations", "ledger_forked_two_heads",
        "reconcile_merged_chain_verifies", "post_heal_heads_agree",
        "chains_verify", "killed_peer_resumed_from_checkpoint"}
    assert sum(record["invariants"].values()) == 0
    reports = result["reports"]
    # both components committed solo merges, and the resumed peer restored
    # the round the harness kept for it, bit for bit
    assert reports[0]["solo_merges"] > 0 and reports[1]["solo_merges"] > 0
    kill = result["kill"]
    restored = reports[1]["restored"]
    assert restored["version"] == kill["round"]
    state = torch.load(os.path.join(kill["kept"], f"round_{kill['round']:06d}",
                                    "state.pt"), weights_only=True)
    assert restored["trainable_digest"] == tl.params_digest(
        state["trainable"], use_native=False).hex()
    assert restored["ef_residual_digest"] == tl.params_digest(
        state["ef_residual"], use_native=False).hex()
    # the dead incarnation's report was kept beside the resumed one's
    assert [r["incarnation"] for r in result["incarnation_reports"][1]] == [1]
    assert reports[1]["incarnation"] == 2


def test_broadcasts_past_the_target_carry_the_whole_chain():
    """Mid-run a broadcast carries the chain suffix since the last one;
    at or past the target version it carries the whole chain, and a
    follower whose replica diverged (it served a state sync and holds its
    own commitment row) rebuilds its replica from that broadcast and
    adopts, where a suffix would have sent it back for a HELLO."""
    from bcfl_tpu_torch.metrics.tracing import StepClock

    led = tl.Ledger()
    for i in range(4):
        led.append_digest(0, i, bytes([i + 1]) * 32, 8)
    sent = []
    leader = trt.PeerRuntime.__new__(trt.PeerRuntime)
    leader.__dict__.update(
        cfg=types.SimpleNamespace(num_rounds=3, dist=types.SimpleNamespace(
            pipeline=False)),
        chain=led, version=2, peer_id=0, _last_broadcast_len=2,
        trainable={"w": torch.ones(2)},
        gate=ttr.PartitionGate(None, 2),
        transport=types.SimpleNamespace(
            send=lambda to, h, trees: sent.append(h)))
    leader._broadcast_global(healed=False)
    assert sent[-1]["chain_start"] == 2 and len(sent[-1]["chain"]) == 2
    # the follower served a state sync at version 2: its replica ends in
    # its own commitment row, which the leader's chain does not hold
    follower = trt.PeerRuntime.__new__(trt.PeerRuntime)
    replica = tl.Ledger.from_json(led.to_json())
    replica.commit_state(2, 1, bytes(32))
    follower.__dict__.update(
        cfg=types.SimpleNamespace(ledger=types.SimpleNamespace(
            use_native=True), num_rounds=3),
        chain=replica, eng=types.SimpleNamespace(ledger=replica),
        version=2, peer_id=1, _needs_bootstrap=False,
        _pending_reconcile=False, adopted=[], clock=StepClock(),
        hellos=[])
    follower._cast = lambda t: t
    follower._note_version = lambda: None
    follower._maybe_checkpoint = lambda: None
    follower._request_resync = follower.hellos.append
    led.append_digest(1, 0, b"\x09" * 32, 8)
    leader.version = 3
    leader._broadcast_global(healed=False)
    frame = dict(sent[-1], **{"from": 0})
    assert frame["chain_start"] == 0 and len(frame["chain"]) == len(led)
    follower._handle_global(frame, {"model": {"w": torch.ones(2)}})
    assert follower.version == 3 and follower.adopted == [3]
    assert follower.chain.head == led.head and not follower.hellos
