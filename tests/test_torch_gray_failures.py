"""The port's limp and resource lanes against the JAX package's: the plan's
``limp_action``, ``limp_throttle`` (direction keying and ``limp_oneway``)
and ``resource_action`` draws bit for bit over seeded grids, disabled lanes
drawing nothing, JAX's validation messages and config gates; the runtime's
``_durable_write`` ladder under injected depths 1-3 against JAX's, with
JAX's ``resource.inject`` events; ``_events_write_fault`` and the event
writer shedding, never raising; the train-seam stall and the transport's
throttle pacing; gossip's ``hedge_neighbors`` against JAX's; the harness's
SIGSTOP/SIGCONT limp leg; and JAX's 3-peer tiny-bert loopback in which the
limping peer is down-weighted but never quarantined
(``tests/test_gray_failures.py::test_three_peer_loopback_limping_peer_
never_quarantined``)."""

import time
import types

import pytest
import torch

from bcfl_tpu import telemetry as jtel
from bcfl_tpu.dist import runtime as jrt
from bcfl_tpu.faults import FaultPlan as JPlan
from bcfl_tpu.faults.plan import RESOURCE_SEAMS as J_SEAMS
from bcfl_tpu_torch import telemetry as ttel
from bcfl_tpu_torch.config import DistConfig
from bcfl_tpu_torch.dist import runtime as trt
from bcfl_tpu_torch.dist.harness import free_ports
from bcfl_tpu_torch.dist.transport import LimpChaos, PeerTransport
from bcfl_tpu_torch.faults import FaultPlan
from bcfl_tpu_torch.faults.plan import RESOURCE_CLASSES, RESOURCE_SEAMS

pytestmark = [pytest.mark.dist, pytest.mark.faults]


# ------------------------------------------------------------ limp lane

LIMP_PLANS = [
    dict(seed=9, limp_peers=(1, 2), limp_prob=0.5, limp_stall_s=0.7,
         limp_throttle_bps=65536.0, limp_rounds=tuple(range(1, 30))),
    dict(seed=9, limp_peers=(1,), limp_prob=0.5, limp_stall_s=0.0,
         limp_throttle_bps=65536.0),
    dict(seed=4, limp_peers=(3,), limp_prob=0.35, limp_stall_s=2.0,
         limp_oneway=True, limp_throttle_bps=67108864.0),
    dict(seed=0, limp_prob=0.8, limp_stall_s=0.4),
]


@pytest.mark.parametrize("kw", LIMP_PLANS,
                         ids=["span", "throttle", "oneway", "every_peer"])
def test_limp_draws_equal_jax(kw):
    t, j = FaultPlan(**kw), JPlan(**kw)
    assert t.limp_enabled == j.limp_enabled and t.enabled == j.enabled
    fired = 0
    for r in range(30):
        for src in range(4):
            got = t.limp_action(r, src)
            assert got == j.limp_action(r, src)
            fired += got is not None
            for dst in range(4):
                if dst != src:
                    assert t.limp_throttle(r, src, dst) == \
                        j.limp_throttle(r, src, dst)
            assert t._is_limp_peer(src) == j._is_limp_peer(src)
    assert fired > 0


def test_limp_throttle_direction_keyed():
    plan = FaultPlan(seed=9, limp_peers=(1,), limp_prob=0.5,
                     limp_stall_s=0.0, limp_throttle_bps=65536.0)
    grid = [(r, s, d) for r in range(40) for s in range(3)
            for d in range(3) if s != d]
    draws = {k: plan.limp_throttle(*k) for k in grid}
    # only directions touching the limp peer are eligible
    assert all(v is None for (r, s, d), v in draws.items()
               if s != 1 and d != 1)
    # the ordered pair draws independently
    assert [r for r in range(40)
            if (draws[(r, 1, 0)] is None) != (draws[(r, 0, 1)] is None)]
    assert {v for v in draws.values() if v is not None} == {65536.0}
    one = FaultPlan(seed=9, limp_peers=(1,), limp_prob=1.0,
                    limp_throttle_bps=65536.0, limp_oneway=True)
    assert all(one.limp_throttle(r, 0, 1) is None for r in range(20))
    assert any(one.limp_throttle(r, 1, 0) for r in range(20))


# -------------------------------------------------------- resource lane

RESOURCE_PLANS = [
    dict(seed=13, resource_peers=(0, 2), resource_prob=0.5,
         resource_rounds=tuple(range(1, 30))),
    dict(seed=13, resource_prob=1.0, resource_classes=("emfile",)),
    dict(seed=21, resource_prob=1.0, resource_peers=(0,)),
]


@pytest.mark.parametrize("kw", RESOURCE_PLANS,
                         ids=["span", "emfile", "every_write"])
def test_resource_draws_equal_jax(kw):
    t, j = FaultPlan(**kw), JPlan(**kw)
    assert RESOURCE_SEAMS == J_SEAMS
    fired = 0
    for seam in RESOURCE_SEAMS:
        for c in range(30):
            for p in range(3):
                got = t.resource_action(seam, c, p)
                assert got == j.resource_action(seam, c, p)
                if got is not None:
                    fired += 1
                    assert got["cls"] in RESOURCE_CLASSES
                    assert got["depth"] in (1, 2, 3)
    assert fired > 0
    for plan in (t, j):
        with pytest.raises(ValueError):
            plan.resource_action("bogus_seam", 1, 0)


def test_disabled_lanes_are_passthrough_in_both():
    for plan in (FaultPlan(), JPlan()):
        assert not plan.limp_enabled and not plan.resource_enabled
        for r in range(25):
            for p in range(4):
                assert plan.limp_action(r, p) is None
                assert all(plan.limp_throttle(r, p, d) is None
                           for d in range(4) if d != p)
        assert all(plan.resource_action(s, c, p) is None
                   for s in RESOURCE_SEAMS for c in range(25)
                   for p in range(4))


VACUOUS = [
    dict(seed=1, limp_peers=(0,)),
    dict(seed=1, limp_prob=0.5, limp_stall_s=0.0, limp_throttle_bps=0.0),
    dict(seed=1, limp_prob=0.5, limp_rounds=()),
    dict(seed=1, limp_rounds=(2,)),
    dict(seed=1, limp_prob=0.5, limp_stall_s=-1.0),
    dict(seed=1, limp_prob=0.5, limp_throttle_bps=float("nan")),
    dict(seed=1, limp_prob=1.5),
    dict(seed=1, limp_peers=(0, 0), limp_prob=0.5),
    dict(seed=1, limp_peers=[0], limp_prob=0.5),
    dict(seed=1, limp_prob=0.5, limp_rounds=[1]),
    dict(seed=1, resource_peers=(0,)),
    dict(seed=1, resource_peers=(1, 1), resource_prob=0.5),
    dict(seed=1, resource_prob=0.5, resource_classes=()),
    dict(seed=1, resource_prob=0.5, resource_classes=("bogus",)),
    dict(seed=1, resource_prob=1.5),
    dict(seed=1, resource_rounds=(3,)),
    dict(seed=1, resource_prob=0.5, resource_rounds=()),
]


@pytest.mark.parametrize("kw", VACUOUS,
                         ids=[str(i) for i in range(len(VACUOUS))])
def test_vacuous_gray_plans_rejected_as_jax(kw):
    msgs = []
    for plan in (FaultPlan, JPlan):
        with pytest.raises(ValueError) as e:
            plan(**kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("lane", ["limp", "resource"])
@pytest.mark.parametrize("case", ["local", "bad_peer", "ok"])
def test_config_gray_lane_gates_equal_jax(lane, case):
    from bcfl_tpu import config as jconfig
    from bcfl_tpu_torch import config as tconfig

    out = []
    for mod, plan in ((tconfig, FaultPlan), (jconfig, JPlan)):
        peer = 5 if case == "bad_peer" else 0
        faults = plan(seed=1, **{f"{lane}_peers": (peer,),
                                 f"{lane}_prob": 0.5})
        kw = dict(dataset="synthetic", model="tiny-bert", num_clients=4,
                  num_rounds=2, seq_len=16, batch_size=4,
                  max_local_batches=2, faults=faults,
                  partition=mod.PartitionConfig(kind="iid", iid_samples=8))
        if case != "local":
            kw.update(runtime="dist", mode="server", sync="async",
                      eval_every=0, dist=mod.DistConfig(peers=2))
        try:
            cfg = mod.FedConfig(**kw)
            out.append(("ok", cfg.runtime))
        except ValueError as e:
            out.append(("err", str(e)))
    assert out[0] == out[1]
    assert out[0][0] == ("ok" if case == "ok" else "err")


# ---------------------------------------------------- the durability ladder


class _LadderHost:
    """The shell ``_durable_write`` reads, the two remedy rungs recorded."""

    def __init__(self, plan):
        self.cfg = types.SimpleNamespace(faults=plan)
        self.peer_id = 0
        self.rungs = []

    def _emergency_gc(self, seam):
        self.rungs.append(("gc", seam))

    def _shed_telemetry(self, seam):
        self.rungs.append(("shed", seam))


def _counters_by_depth(plan, seam):
    out = {}
    for c in range(200):
        act = plan.resource_action(seam, c, 0)
        if act is not None:
            out.setdefault(act["depth"], c)
        if set(out) == {1, 2, 3}:
            return out
    raise AssertionError(f"depths seen: {sorted(out)}")


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("seam", ["checkpoint", "ledger"])
def test_durable_write_injected_depths_equal_jax(depth, seam, tmp_path):
    """An injected depth-d fault fails the first d attempts: depth 1 is
    cleared by the GC rung, depth 2 by the shed rung, depth 3 raises
    DurabilityError with the write never run; one ``resource.inject`` per
    injected attempt, fields as JAX's."""
    kw = dict(seed=21, resource_prob=1.0, resource_peers=(0,))
    counter = _counters_by_depth(FaultPlan(**kw), seam)[depth]
    out = {}
    for pkg, rt, tele, plan in (("port", trt, ttel, FaultPlan(**kw)),
                                ("jax", jrt, jtel, JPlan(**kw))):
        stream = str(tmp_path / f"{pkg}.jsonl")
        tele.install(tele.EventWriter(stream, peer=0, run="ladder"))
        host = _LadderHost(plan)
        ran = []
        try:
            got = rt.PeerRuntime._durable_write(
                host, seam, counter, lambda: ran.append(1) or "ok")
        except rt.DurabilityError:
            got = "raise"
        finally:
            tele.uninstall()
        evs = [{k: e[k] for k in ("seam", "cls", "counter", "depth",
                                  "attempt", "errno")}
               for e in tele.read_stream(stream)[0]
               if e["ev"] == "resource.inject"]
        out[pkg] = (got, ran, host.rungs, evs)
    assert out["port"] == out["jax"]
    got, ran, rungs, evs = out["port"]
    assert len(evs) == depth
    assert [e["attempt"] for e in evs] == list(range(depth))
    assert rungs == [("gc", seam), ("shed", seam)][:min(depth, 2)]
    assert got == ("raise" if depth == 3 else "ok")
    assert ran == ([] if depth == 3 else [1])


def test_durability_exit_code_distinct():
    assert trt.DurabilityError.EXIT_CODE == jrt.DurabilityError.EXIT_CODE
    assert trt.DurabilityError.EXIT_CODE != trt.ResumeError.EXIT_CODE


# -------------------------------------------------------- the events seam


def test_events_write_fault_draws_and_raises_as_jax():
    plan_kw = dict(seed=21, resource_prob=1.0, resource_peers=(0,))
    got = []
    for rt, plan in ((trt, FaultPlan(**plan_kw)), (jrt, JPlan(**plan_kw))):
        host = types.SimpleNamespace(
            cfg=types.SimpleNamespace(faults=plan), peer_id=0,
            _events_fault_busy=False, _events_flush_n=0)
        with pytest.raises(OSError) as ei:
            rt.PeerRuntime._events_write_fault(host, 1024)
        assert host._events_flush_n == 1 and not host._events_fault_busy
        # the busy flag keeps the inject event's own flush from drawing
        host._events_fault_busy = True
        rt.PeerRuntime._events_write_fault(host, 1024)
        assert host._events_flush_n == 1
        got.append(ei.value.errno)
    assert got[0] == got[1] and got[0] in (28, 24)


def test_event_writer_flush_fault_sheds_never_raises(tmp_path):
    """The events seam never reaches the exit rung: a failed flush turns
    shedding on, ``write.shed`` lands in the next flush, and the emitting
    thread never sees the error. JAX drops the faulted batch; the port
    keeps it (nothing reached the file) and writes it with the next
    flush, in order."""
    out = {}
    for name, tele in (("port", ttel), ("jax", jtel)):
        stream = str(tmp_path / f"{name}.jsonl")
        w = tele.EventWriter(stream, peer=0, run="enospc", flush_every=1)
        fired = {"n": 0}

        def fault(nbytes):
            if fired["n"] == 0:
                fired["n"] = 1
                raise OSError(28, "No space left on device")

        w.write_fault = fault
        tele.install(w)
        try:
            tele.emit("detector", target=1,
                      **{"from": "reachable", "to": "suspect"})
            assert w.shedding
            tele.emit("detector", target=2,
                      **{"from": "suspect", "to": "down"})
            dropped = w.dropped
        finally:
            tele.uninstall()
        events, _ = tele.read_stream(stream)
        sheds = [(e["seam"], e["errno"]) for e in events
                 if e["ev"] == "write.shed"]
        targets = [e["target"] for e in events if e["ev"] == "detector"]
        assert [e["seq"] for e in events] == sorted(e["seq"] for e in events)
        out[name] = (sheds, targets, dropped)
    assert out["jax"] == ([("events", 28)], [2], 1)
    assert out["port"] == ([("events", 28)], [1, 2], 0)


def test_a_faulted_flush_keeps_the_receivers_ground_truth(tmp_path):
    """Why the port keeps a faulted batch: JAX's writer drops the
    never-sampled ``recv`` of an acked frame with it, and the shared
    ``acked_not_lost`` invariant then reports a frame the receiver did
    enqueue as lost; the port's stream keeps it."""
    from bcfl_tpu.telemetry.invariants import acked_not_lost as j_inv
    from bcfl_tpu_torch.telemetry.invariants import acked_not_lost as t_inv

    verdicts = {}
    for name, tele, inv in (("port", ttel, t_inv), ("jax", jtel, j_inv)):
        recv_path = str(tmp_path / f"{name}_events_peer1.jsonl")
        w = tele.EventWriter(recv_path, peer=1, run="gap", flush_every=1)
        fired = {"n": 0}

        def fault(nbytes):
            if fired["n"] == 0:
                fired["n"] = 1
                raise OSError(28, "No space left on device")

        w.write_fault = fault
        tele.install(w)
        try:
            tele.emit("recv", disposition="accepted", src=0, msg_epoch=1,
                      msg_id=7, type="global")
            tele.emit("run.end", status="ok")
        finally:
            tele.uninstall()
        recv_events, _ = tele.read_stream(recv_path)
        send = {"v": 1, "ev": "send", "run": "gap", "peer": 0, "pid": 1,
                "seq": 0, "t_wall": 0.0, "t_mono": 0.0, "to": 1, "ok": True,
                "msg_id": 7, "msg_epoch": 1, "type": "global",
                "wall_s": 0.1}
        verdicts[name] = len(inv([send] + recv_events))
    assert verdicts == {"port": 0, "jax": 1}


def test_runtime_installs_the_events_seam_only_when_armed(tmp_path):
    """``PeerRuntime.__init__``'s wiring, on a stand-in: the writer's
    ``write_fault`` is the runtime's ``_events_write_fault`` exactly when
    the resource lane is armed, and its first draw fails a real flush."""
    plan = FaultPlan(seed=21, resource_prob=1.0, resource_peers=(0,))
    stream = str(tmp_path / "events_peer0.jsonl")
    w = ttel.EventWriter(stream, peer=0, run="seam", flush_every=1)
    ttel.install(w)
    try:
        rt = trt.PeerRuntime.__new__(trt.PeerRuntime)
        rt.cfg = types.SimpleNamespace(faults=plan)
        rt.peer_id = 0
        rt._events_flush_n = 0
        rt._events_fault_busy = False
        w.write_fault = rt._events_write_fault
        ttel.emit("detector", target=1,
                  **{"from": "reachable", "to": "suspect"})
        assert w.shedding and w.dropped == 0
    finally:
        ttel.uninstall()
    evs = ttel.read_stream(stream)[0]
    inj = [e for e in evs if e["ev"] == "resource.inject"]
    assert inj and inj[0]["seam"] == "events" and inj[0]["counter"] == 0
    assert inj[0] == {**inj[0], **plan.resource_action("events", 0, 0)}


# ------------------------------------------------ stall and throttle seams


def test_limp_stall_at_the_train_seam(tmp_path):
    plan = FaultPlan(seed=0, limp_peers=(0,), limp_prob=1.0,
                     limp_stall_s=0.2, limp_rounds=(1,))
    rt = trt.PeerRuntime.__new__(trt.PeerRuntime)
    rt.cfg = types.SimpleNamespace(faults=plan)
    rt.peer_id = 0
    stream = str(tmp_path / "events_peer0.jsonl")
    ttel.install(ttel.EventWriter(stream, peer=0, run="stall"))
    try:
        t0 = time.monotonic()
        rt._limp_stall(0)  # out of the span: no stall
        assert time.monotonic() - t0 < 0.1
        rt._limp_stall(1)
        assert time.monotonic() - t0 >= 0.2
    finally:
        ttel.uninstall()
    stalls = [e for e in ttel.read_stream(stream)[0]
              if e["ev"] == "limp.inject"]
    assert [(e["kind"], e["round"], e["stall_s"]) for e in stalls] == [
        ("stall", 1, 0.2)]


def test_throttled_direction_paces_the_send():
    """A throttled direction paces each attempt by the frame's wire time
    at the degraded rate; the other direction is untouched."""
    ports = free_ports(2)
    addrs = [("127.0.0.1", p) for p in ports]
    pol = DistConfig(peers=2, send_retries=1, send_deadline_s=10.0)
    plan = FaultPlan(seed=0, limp_peers=(0,), limp_prob=1.0,
                     limp_stall_s=0.0, limp_throttle_bps=1 << 20,
                     limp_oneway=True)
    b = PeerTransport(1, addrs, policy=pol,
                      limp=LimpChaos(plan, lambda: 0))
    b.start()
    a = PeerTransport(0, addrs, policy=pol, limp=LimpChaos(plan, lambda: 0))
    a.start()
    try:
        tree = {"x": torch.zeros(1 << 17)}  # 512 KiB: ~0.5 s at 1 MiB/s
        t0 = time.monotonic()
        assert a.send(1, {"type": "update"}, {"payload": tree}) is True
        assert time.monotonic() - t0 >= 0.45
        assert a.stats()["limp_paced"] == 1
        t0 = time.monotonic()
        assert b.send(0, {"type": "update"}, {"payload": tree}) is True
        assert b.stats()["limp_paced"] == 0  # B -> A is not the limp side
    finally:
        a.close()
        b.close()


def test_hedge_neighbors_equal_jax():
    from bcfl_tpu.dist.gossip import hedge_neighbors as jhedge
    from bcfl_tpu_torch.dist.gossip import hedge_neighbors

    live = (0, 1, 2, 3, 4, 5)
    cases = [
        ((1, 2, 4), {2: 3.5, 4: 0.1}),
        ((1, 4), {2: 3.5, 4: 0.1}),
        ((1, 2), {p: 9.0 for p in live}),
        ((3, 5), {3: 2.0, 5: 2.5, 1: 1.9}),
    ]
    for seed in (0, 7):
        for rnd in range(4):
            for nbrs, susp in cases:
                got = hedge_neighbors(seed, rnd, 0, live, nbrs, susp, 2.0)
                assert got == jhedge(seed, rnd, 0, live, nbrs, susp, 2.0)
    new, dropped = hedge_neighbors(7, 3, 0, live, (1, 2, 4),
                                   {2: 3.5, 4: 0.1}, 2.0)
    assert dropped == (2,) and 2 not in new and len(new) == 3


# ------------------------------------------------------ loopback (3 peers)


def test_three_peer_loopback_limping_peer_never_quarantined(tmp_path):
    """JAX's loopback on the port: peer 2 limps (seeded train-seam stalls
    and a direction-keyed throttle) the whole run and the harness freezes
    it twice (SIGSTOP/SIGCONT). The federation completes, the limp
    injections and phi samples are in the streams, the stalls are exactly
    the plan's draws for the rounds peer 2 ran, it is never quarantined,
    and the invariants (slowness_is_not_malice included) are clean."""
    from bcfl_tpu_torch import config as tconfig
    from bcfl_tpu_torch.dist import run_dist
    from bcfl_tpu_torch.reputation import ReputationConfig
    from bcfl_tpu_torch.telemetry import collate, read_stream

    plan = FaultPlan(seed=11, limp_peers=(2,), limp_prob=0.8,
                     limp_stall_s=0.4, limp_throttle_bps=262144.0)
    cfg = tconfig.FedConfig(
        name="gray_loopback", runtime="dist", mode="server", sync="async",
        model="tiny-bert", dataset="synthetic", vocab_size=512,
        num_clients=6, num_rounds=3, seq_len=16, batch_size=4,
        max_local_batches=2, eval_every=0, seed=11,
        partition=tconfig.PartitionConfig(kind="iid", iid_samples=8),
        reputation=ReputationConfig(enabled=True),
        faults=plan,
        dist=tconfig.DistConfig(peers=3, buffer_timeout_s=5.0,
                                idle_timeout_s=90.0, peer_deadline_s=280.0,
                                checkpoint_every_versions=0))
    res = run_dist(cfg, str(tmp_path / "gray"), deadline_s=320.0,
                   device="cpu", threads=1,
                   limp={"peer": 2, "pause_s": 0.5, "period_s": 1.0,
                         "cycles": 2})
    assert res["ok"], (res["returncodes"], res["log_tails"])
    assert [c["cycle"] for c in res["limp"]] == [1, 2]
    assert all(c["peer"] == 2 and c["pause_s"] == 0.5 for c in res["limp"])
    evs = [e for p in res["event_streams"] for e in read_stream(p)[0]]
    limps = [e for e in evs if e["ev"] == "limp.inject"]
    assert {e["kind"] for e in limps} <= {"stall", "throttle"}
    stalls = sorted(e["round"] for e in limps if e["kind"] == "stall")
    assert stalls and {e["peer"] for e in limps if e["kind"] == "stall"} \
        == {2}
    # throttles pace only directions touching the limp peer
    assert all(e["peer"] == 2 or e["dst"] == 2 for e in limps
               if e["kind"] == "throttle")
    ran = res["reports"][2]["local_rounds"]
    assert stalls == [r for r in range(ran)
                      if plan.limp_action(r, 2) is not None]
    assert any(e["ev"] == "detector.phi" for e in evs)
    assert [e for e in evs if e["ev"] == "rep.transition"
            and e.get("to") == "quarantined"
            and e.get("scope") == "peer"] == []
    for p, rep in res["reports"].items():
        assert rep["status"] == "ok", (p, rep)
    col = collate(res["event_streams"])
    assert col["ok"], col["violations"]
    assert col["invariants"]["slowness_is_not_malice"] == 0
