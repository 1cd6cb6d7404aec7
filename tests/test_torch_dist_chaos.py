"""The port's wire chaos lane against the JAX package's: the plan's
``wire_actions`` over a seeded grid of ``(round, src, dst, msg_id,
attempt)`` and its validation messages; ``_corrupt_parts`` and
``write_frame(corrupt_frac=...)`` byte for byte; JAX's
``tests/test_wire_chaos.py`` transport cases on the port's
``PeerTransport`` over loopback (a drop exhausts the budget, a duplicate is
deduplicated, corruption is caught by the CRC and healed by a retry, the
pipelined sender under chaos, a reorder hold and the clock pinned at
enqueue); the default phi detector's SUSPECT and REACHABLE round trip
under a lane that drops a round's every attempt, in both packages; the ``--chaos-wire`` flags parsed and refused as JAX parses and
refuses them; a follower that honors a shutdown only after the frames held
before it; and a 3-peer CPU loopback run of the leadered path with
``int8+topk`` under the wire lane, graded by JAX's
``scripts/dist_chaos.py`` wire-leg gates."""

import socket
import threading
import types

import numpy as np
import pytest
import torch

from bcfl_tpu.dist import wire as jw
from bcfl_tpu.faults import FaultPlan as JPlan
from bcfl_tpu_torch.config import DistConfig
from bcfl_tpu_torch.dist import wire as tw
from bcfl_tpu_torch.dist.harness import free_ports
from bcfl_tpu_torch.dist.transport import PeerTransport, WireChaos
from bcfl_tpu_torch.faults import FaultPlan

pytestmark = pytest.mark.dist


# ------------------------------------------------------------ the draws

PLANS = [
    dict(seed=3, wire_drop_prob=0.5, wire_dup_prob=0.5,
         wire_corrupt_prob=0.5, wire_rounds=(2, 3)),
    dict(seed=11, wire_drop_prob=0.2, wire_dup_prob=0.2,
         wire_reorder_prob=0.2, wire_corrupt_prob=0.05),
    dict(seed=0, wire_delay_prob=0.7, wire_delay_s=0.3,
         wire_reorder_prob=0.4, wire_reorder_hold_s=0.1),
]


@pytest.mark.parametrize("kw", PLANS, ids=["span", "chaos_leg", "delay"])
def test_wire_actions_equal_jax(kw):
    t, j = FaultPlan(**kw), JPlan(**kw)
    assert t.wire_enabled == j.wire_enabled and t.enabled == j.enabled
    n = 0
    for rnd in range(5):
        for src in range(3):
            for dst in range(3):
                for msg_id in (0, 1, 7):
                    for attempt in range(3):
                        got = t.wire_actions(rnd, src, dst, msg_id, attempt)
                        assert got == j.wire_actions(rnd, src, dst, msg_id,
                                                     attempt)
                        n += got is not None
    assert n > 0


BAD_WIRE = [
    dict(wire_drop_prob=1.5),
    dict(wire_delay_prob=0.5, wire_delay_s=-1.0),
    dict(wire_reorder_prob=0.5, wire_reorder_hold_s=float("inf")),
    dict(wire_rounds=(0, 1)),
    dict(wire_drop_prob=0.5, wire_rounds=()),
    dict(wire_drop_prob=0.5, wire_rounds=[0, 1]),
]


@pytest.mark.parametrize("kw", BAD_WIRE,
                         ids=[str(i) for i in range(len(BAD_WIRE))])
def test_wire_plan_validation_equals_jax(kw):
    msgs = []
    for plan in (FaultPlan, JPlan):
        with pytest.raises(ValueError) as e:
            plan(**kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ------------------------------------------------- in-flight corruption


def _streamed(write, *args, **kw):
    """The bytes ``write(sock, *args)`` streams, read off a socketpair."""
    a, b = socket.socketpair()
    chunks = []

    def reader():
        while True:
            c = b.recv(1 << 16)
            if not c:
                return
            chunks.append(c)

    t = threading.Thread(target=reader)
    t.start()
    n = write(a, *args, **kw)
    a.close()
    t.join()
    b.close()
    out = b"".join(chunks)
    assert n == len(out)
    return out


def _trees(seed):
    rng = np.random.default_rng(seed)
    j = {"layer/kernel": rng.normal(size=(64, 33)).astype(np.float32),
         "layer/bias": rng.normal(size=(33,)).astype(np.float32),
         "codes": rng.integers(-127, 128, (5, 300)).astype(np.int8),
         "idx": rng.integers(0, 1 << 20, (7,)).astype(np.int32),
         "scalar": np.float32(2.5)}
    t = {k: torch.from_numpy(np.array(v)) for k, v in j.items()}
    return t, j


FRACS = [[0.0], [0.999999], [0.5, 0.5], [0.1, 0.2, 0.7, 0.9],
         [0.0001, 0.3333, 0.6667, 0.99]]


@pytest.mark.parametrize("fracs", FRACS, ids=[str(i) for i in range(5)])
def test_corrupted_frame_bytes_equal_jax(fracs):
    header = {"type": "update", "round": 3, "from": 1, "msg_id": 9}
    t, j = _trees(len(fracs))
    clean = _streamed(tw.write_frame, header, {"payload": t})
    got = _streamed(tw.write_frame, header, {"payload": t},
                    corrupt_frac=fracs)
    want = _streamed(jw.write_frame, header, {"payload": j},
                     corrupt_frac=fracs)
    assert got == want
    # the prefix (and its CRC) is the clean frame's; only payload bytes
    # flipped, each position once (an even count of one position cancels)
    assert got[:tw.PREFIX_LEN] == clean[:tw.PREFIX_LEN]
    total = len(clean) - tw.PREFIX_LEN
    flips = {}
    for f in fracs:
        pos = min(int(f * total), total - 1)
        flips[pos] = flips.get(pos, 0) + 1
    diff = {i - tw.PREFIX_LEN for i, (a, b) in enumerate(zip(got, clean))
            if a != b}
    assert diff == {p for p, n in flips.items() if n % 2}
    a, b = socket.socketpair()
    try:
        a.sendall(got)
        if diff:
            with pytest.raises(tw.CrcError):
                tw.read_frame(b, timeout_s=5.0)
        else:  # the flips cancelled: the frame is the clean one
            assert tw.read_frame(b, timeout_s=5.0)[0] == header
    finally:
        a.close()
        b.close()


def test_corrupt_parts_copies_only_the_touched_pieces():
    big = np.arange(1 << 16, dtype=np.uint8)
    parts = [b"head", memoryview(big), b"tail"]
    out = tw._corrupt_parts(parts, [1, 4 + 10, 4 + (1 << 16) + 3])
    assert out == jw._corrupt_parts(list(parts),
                                    [1, 4 + 10, 4 + (1 << 16) + 3])
    assert out[0] == bytes([ord("h"), ord("e") ^ 0xFF]) + b"ad"
    assert out[2] == b"tai" + bytes([ord("l") ^ 0xFF])
    assert out[1][10] == 10 ^ 0xFF and big[10] == 10  # the input is intact
    untouched = tw._corrupt_parts(parts, [2])
    assert untouched[1] is parts[1]  # no flip landed: no copy
    assert tw._corrupt_parts(parts, [-1]) == parts


# ------------------------------------------- the transport over loopback


def _policy(**kw):
    base = dict(peers=2, send_retries=2, retry_base_s=0.01,
                retry_max_s=0.05, send_deadline_s=3.0, suspect_after=1,
                down_after=3, probe_interval_s=30.0)
    base.update(kw)
    return DistConfig(**base)


def _pair():
    ports = free_ports(2)
    return [("127.0.0.1", p) for p in ports]


def test_chaos_drop_exhausts_budget_and_dup_is_deduped():
    addrs = _pair()
    b = PeerTransport(1, addrs, policy=_policy())
    b.start()
    try:
        a = PeerTransport(
            0, addrs, policy=_policy(),
            chaos=WireChaos(FaultPlan(wire_drop_prob=1.0), lambda: 0))
        assert a.send(1, {"type": "ping"}) is False
        assert a.chaos_injected["drop"] == 3  # the attempt + 2 retries
        assert b.recv(0.3) is None
        c = PeerTransport(
            0, addrs, policy=_policy(),
            chaos=WireChaos(FaultPlan(wire_dup_prob=1.0), lambda: 0))
        c._next_msg_id[1] = 100  # an id space apart from `a`'s
        assert c.send(1, {"type": "ping"}) is True
        assert b.recv(2.0) is not None
        assert b.recv(0.5) is None
        assert b.dups_dropped >= 1
        assert c.stats()["chaos_injected"]["dup"] == 1
    finally:
        b.close()


def _phi_walk(tr, chaos_cls, plan_cls, dist_cls, addrs, clock):
    """The phi detector's states toward peer 1 as ``tr``'s transport sends
    a ping under a wire lane that drops every attempt of round 0, then
    one of round 1 (lane off): after the failed send, then after the
    delivered one."""
    b = tr.PeerTransport(1, addrs, policy=dist_cls(**PHI_POLICY))
    b.start()
    try:
        a = tr.PeerTransport(
            0, addrs, policy=dist_cls(**PHI_POLICY),
            chaos=chaos_cls(plan_cls(wire_drop_prob=1.0, wire_rounds=(0,)),
                            lambda: clock[0]))
        walk = [a.send(1, {"type": "ping"}), a.detector.state_of(1)]
        clock[0] = 1
        walk += [a.send(1, {"type": "ping"}), a.detector.state_of(1)]
        assert b.recv(3.0) is not None
        return walk
    finally:
        b.close()


PHI_POLICY = dict(peers=2, send_retries=2, retry_base_s=0.01,
                  retry_max_s=0.05, send_deadline_s=3.0, detector="phi",
                  probe_interval_s=0.05)


def test_phi_detector_round_trip_under_the_wire_lane_equals_jax():
    """The default phi detector under the wire lane, with no inbound frame
    between the failures: every attempt of round 0 dropped (3 failures in
    a row) leaves the destination SUSPECT, and the round-1 delivery brings
    it back to REACHABLE, in both packages' transports."""
    from bcfl_tpu.config import DistConfig as JDist
    from bcfl_tpu.dist import transport as jt
    from bcfl_tpu_torch.dist import transport as tt

    want = [False, "suspect", True, "reachable"]
    assert _phi_walk(tt, WireChaos, FaultPlan, DistConfig, _pair(),
                     [0]) == want
    assert _phi_walk(jt, jt.WireChaos, JPlan, JDist, _pair(), [0]) == want


def test_chaos_corruption_is_caught_by_crc_and_healed_by_retry():
    addrs = _pair()
    b = PeerTransport(1, addrs, policy=_policy())
    b.start()
    try:
        class OneShot:
            """Corrupt attempt 0 only: the retry goes through clean."""

            def __init__(self):
                self.plan = FaultPlan(wire_corrupt_prob=1.0)

            def actions(self, src, dst, msg_id, attempt, clock=None):
                if attempt > 0:
                    return None
                return self.plan.wire_actions(0, src, dst, msg_id, attempt)

        a = PeerTransport(0, addrs, policy=_policy(), chaos=OneShot())
        x = torch.tensor([1.0, 2.0, 3.0, 4.0])
        assert a.send(1, {"type": "ping"}, {"t": {"x": x}}) is True
        assert a.retries == 1 and a.chaos_injected["corrupt"] == 1
        got = b.recv(3.0)
        assert got is not None
        assert torch.equal(got[1]["t"]["x"], x)
        assert b.crc_drops == 1  # the damaged copy died before parsing
    finally:
        b.close()


def test_send_async_under_wire_chaos_dedup_and_drop():
    addrs = _pair()
    b = PeerTransport(1, addrs, policy=_policy())
    b.start()
    dup = PeerTransport(
        0, addrs, policy=_policy(),
        chaos=WireChaos(FaultPlan(wire_dup_prob=1.0), lambda: 0))
    try:
        for i in range(4):
            assert dup.send_async(1, {"type": "ping", "n": i}) is True
        assert dup.flush_sends(timeout_s=10.0) is True
        got = []
        msg = b.recv(2.0)
        while msg is not None:
            got.append(msg[0]["n"])
            msg = b.recv(0.3)
        assert got == [0, 1, 2, 3]  # once each, in order
        assert b.dups_dropped >= 4
        drop = PeerTransport(
            0, addrs, policy=_policy(),
            chaos=WireChaos(FaultPlan(wire_drop_prob=1.0), lambda: 0))
        drop._next_msg_id[1] = 100
        assert drop.send_async(1, {"type": "ping"}) is True
        assert drop.flush_sends(timeout_s=10.0) is True
        assert drop.send_failures == 1
        assert drop.chaos_injected["drop"] == 3
        assert b.recv(0.3) is None
    finally:
        b.close()
        dup.close()


def test_reorder_hold_lets_a_later_frame_overtake():
    addrs = _pair()
    b = PeerTransport(1, addrs, policy=_policy())
    b.start()
    try:
        class HoldFirst:
            def actions(self, src, dst, msg_id, attempt, clock=None):
                return {"drop": False, "dup": False,
                        "reorder_s": 0.4 if msg_id == 0 else 0.0,
                        "delay_s": 0.0, "corrupt": False,
                        "corrupt_pos": (0.0,) * 4}

        a = PeerTransport(0, addrs, policy=_policy(), chaos=HoldFirst())
        assert a.send(1, {"type": "ping", "n": 0}) is True
        assert a.send(1, {"type": "ping", "n": 1}) is True
        assert b.stats()["reorders_held"] == 1
        assert b.wait_held(0.01) is False  # still held
        first = b.recv(1.0)
        assert first[0]["n"] == 1 and "chaos_hold_s" not in first[0]
        assert b.wait_held(2.0) is True
        assert b.recv(1.0)[0]["n"] == 0
        assert a.chaos_injected["reorder"] == 1
    finally:
        b.close()


def test_send_async_pins_the_chaos_clock_at_enqueue():
    """A frame's fate is the draw of the round that produced it: the lane
    clock moves on while the worker is still busy, the draws do not."""
    seen = []
    clock = {"r": 0}

    class Spy(WireChaos):
        def actions(self, src, dst, msg_id, attempt, clock=None):
            seen.append((msg_id, clock))
            return super().actions(src, dst, msg_id, attempt, clock=clock)

    addrs = _pair()
    b = PeerTransport(1, addrs, policy=_policy())
    b.start()
    a = PeerTransport(0, addrs, policy=_policy(pipeline_depth=4),
                      chaos=Spy(FaultPlan(wire_dup_prob=0.5),
                                lambda: clock["r"]))
    try:
        for r in range(3):
            clock["r"] = r
            assert a.send_async(1, {"type": "ping", "n": r}) is True
        clock["r"] = 99
        assert a.flush_sends(timeout_s=10.0) is True
        assert sorted(set(seen)) == [(0, 0), (1, 1), (2, 2)]
    finally:
        b.close()
        a.close()


# ----------------------------------------------- shutdown after a hold


def test_shutdown_waits_for_frames_held_before_it():
    """A reorder hold can release the leader's final global after its
    shutdown arrived; the follower handles the held global before it
    stops (stopping at once ends it a version short)."""
    from bcfl_tpu_torch.dist import runtime as trt

    addrs = _pair()
    b = PeerTransport(1, addrs, policy=_policy())
    b.start()
    try:
        class HoldGlobal:
            def actions(self, src, dst, msg_id, attempt, clock=None):
                return {"drop": False, "dup": False,
                        "reorder_s": 0.3 if msg_id == 0 else 0.0,
                        "delay_s": 0.0, "corrupt": False,
                        "corrupt_pos": (0.0,) * 4}

        a = PeerTransport(0, addrs, policy=_policy(), chaos=HoldGlobal())
        assert a.send(1, {"type": "global", "version": 6}) is True
        assert a.send(1, {"type": "shutdown", "version": 6}) is True
        rt = trt.PeerRuntime.__new__(trt.PeerRuntime)
        rt.transport = b
        rt._intake_thread = None
        rt._stop = rt._stopping = False
        rt.cfg = types.SimpleNamespace(faults=FaultPlan(
            wire_reorder_prob=0.2, wire_reorder_hold_s=0.3))
        handled = []
        rt._handle_global = lambda h, t: handled.append(h["version"])
        msg = b.recv(2.0)
        assert msg[0]["type"] == "shutdown"  # it overtook the global
        rt._handle(*msg)
        assert rt._stop and handled == [6]
    finally:
        b.close()


# ------------------------------------------------------------------- CLI


BAD_WIRE_FLAGS = [
    ["--chaos-wire", "drop"],
    ["--chaos-wire", "bogus=0.1"],
    ["--chaos-wire", "delay-s=0.5,hold-s=0.1"],
    ["--chaos-wire-rounds", "1:3", "--chaos-seed", "2",
     "--chaos-dropout", "0.5"],
    ["--chaos-wire", "drop=0.1", "--chaos-wire-rounds", "3"],
    ["--chaos-wire", "drop=0.1", "--chaos-wire-rounds", "3:3"],
]


@pytest.mark.parametrize("flags", BAD_WIRE_FLAGS,
                         ids=[str(i) for i in range(len(BAD_WIRE_FLAGS))])
def test_cli_refuses_wire_flags_as_jax(flags):
    from bcfl_tpu.entrypoints.__main__ import main as jmain
    from bcfl_tpu_torch.entrypoints.__main__ import main as tmain

    msgs = []
    for main in (tmain, jmain):
        with pytest.raises(SystemExit) as e:
            main(["--preset", "smoke"] + flags)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_cli_parses_wire_flags_as_jax():
    from bcfl_tpu_torch.entrypoints.__main__ import build_config, build_parser

    cfg = build_config(build_parser().parse_args([
        "--runtime", "dist", "--peers", "3", "--clients", "6", "--ledger",
        "--chaos-wire", "drop=0.2, dup=0.2,reorder=0.2,corrupt=0.05,"
        "hold-s=0.1,delay=0.5,delay-s=0.3",
        "--chaos-wire-rounds", "1:4", "--chaos-seed", "5"]))
    assert cfg.faults == FaultPlan(
        seed=5, wire_drop_prob=0.2, wire_dup_prob=0.2, wire_reorder_prob=0.2,
        wire_corrupt_prob=0.05, wire_reorder_hold_s=0.1, wire_delay_prob=0.5,
        wire_delay_s=0.3, wire_rounds=(1, 2, 3))
    assert cfg.runtime == "dist"


# --------------------------------------------------- 3-peer loopback run


def test_three_peer_loopback_codec_under_wire_chaos(tmp_path):
    """The leadered path with ``int8+topk`` and the ledger under JAX's
    chaos wire leg (drop/dup/reorder 0.2; corrupt 0.15 here, for a 3-peer
    run's fewer frames): every peer ends
    ok with one verifying chain head, the streams show no invariant
    violation over a nonzero merge count, and retries, duplicates
    dropped, CRC drops and reorder holds all happened (JAX's
    ``scripts/dist_chaos.py`` wire-leg gates, the detector round trip
    included). The counter detector (``detector="fixed"``) makes
    ``suspect_after=1`` hold: every failed attempt is a SUSPECT and the
    next delivery to or from that peer a REACHABLE, so the round trip
    follows from the retries (the default phi detector ignores
    ``suspect_after`` and needs two failures in a row with no inbound
    frame between them, which a loaded host's interleaving can deny; its
    round trip under the wire lane is held by
    ``test_phi_detector_round_trip_under_the_wire_lane_equals_jax``).
    ``buffer=3`` makes every merge wait for all three peers, so every
    version puts both followers' updates on the faulty wire however the
    host schedules the peers."""
    from bcfl_tpu_torch import config as tconfig
    from bcfl_tpu_torch.compression import CompressionConfig
    from bcfl_tpu_torch.dist import run_dist
    from bcfl_tpu_torch.telemetry import collate

    cfg = tconfig.FedConfig(
        name="chaos_loopback", runtime="dist", mode="server", sync="async",
        model="tiny-bert", dataset="synthetic", vocab_size=512,
        num_clients=6, num_rounds=10, seq_len=16, batch_size=4,
        max_local_batches=2, eval_every=0, seed=42,
        partition=tconfig.PartitionConfig(kind="iid", iid_samples=8),
        ledger=tconfig.LedgerConfig(enabled=True),
        compression=CompressionConfig(kind="int8+topk"),
        faults=FaultPlan(seed=2, wire_drop_prob=0.2, wire_dup_prob=0.2,
                         wire_reorder_prob=0.2, wire_reorder_hold_s=0.2,
                         wire_corrupt_prob=0.15),
        dist=tconfig.DistConfig(peers=3, buffer=3, buffer_timeout_s=10.0,
                                suspect_after=1, detector="fixed",
                                idle_timeout_s=90.0, peer_deadline_s=240.0,
                                checkpoint_every_versions=0))
    res = run_dist(cfg, str(tmp_path / "chaos"), deadline_s=280.0,
                   device="cpu", threads=1)
    assert res["ok"], (res["returncodes"], res["log_tails"])
    reports = res["reports"]
    assert {r["chain_head"] for r in reports.values()} != {None}
    assert len({r["chain_head"] for r in reports.values()}) == 1
    assert all(r["chain_ok"] for r in reports.values())
    col = collate(res["event_streams"])
    assert col["ok"], col["violations"]
    assert col["timeline"]["merges"]["count"] > 0
    tot = {k: sum(r["transport"][k] for r in reports.values())
           for k in ("retries", "dups_dropped", "crc_drops",
                     "reorders_held")}
    assert all(v > 0 for v in tot.values()), tot
    assert col["timeline"]["detector_suspect_roundtrips"] > 0
    inj = {}
    for r in reports.values():
        for k, v in r["transport"]["chaos_injected"].items():
            inj[k] = inj.get(k, 0) + v
    assert inj["drop"] and inj["dup"] and inj["reorder"] and inj["corrupt"]
