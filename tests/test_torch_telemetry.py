"""The port's telemetry (``bcfl_tpu_torch/telemetry``) against the JAX
package's: the same event streams give the same collated timeline and
invariant verdicts, the writers write the same records, and the events the
port used to leave out (``rep.evidence``, ``rep.transition``,
``ckpt.save``, ``ckpt.restore``, ``scrub``, ``phase``) now appear with
JAX's fields."""

import json
import os

import numpy as np
import pytest
import torch

from bcfl_tpu import telemetry as J
from bcfl_tpu.reputation import ReputationConfig as JRepCfg
from bcfl_tpu.reputation import ReputationTracker as JTracker
from bcfl_tpu_torch import telemetry as T
from bcfl_tpu_torch.reputation import ReputationConfig, ReputationTracker

pytestmark = pytest.mark.telemetry

STAMPS = ("pid", "seq", "t_wall", "t_mono")


def _ev(ev, peer, seq, t, pid=None, **fields):
    rec = {"v": 1, "ev": ev, "run": "fx", "peer": peer,
           "pid": pid if pid is not None else 1000 + peer, "seq": seq,
           "t_wall": t, "t_mono": t}
    rec.update(fields)
    return rec


def _send(peer, seq, t, to, msg_id, mtype="update"):
    return _ev("send", peer, seq, t, to=to, type=mtype, ok=True,
               msg_id=msg_id, msg_epoch=1, attempts=1, wall_s=0.01,
               bytes=1000)


def _recv(peer, seq, t, src, msg_id):
    return _ev("recv", peer, seq, t, src=src, msg_epoch=1, msg_id=msg_id,
               disposition="accepted", type="update")


def _merge(peer, seq, t, version, arrivals, component=(0, 1), **kw):
    return _ev("merge", peer, seq, t, version=version, leader=peer,
               arrivals=arrivals, rejected=[], solo=False, degraded=False,
               component=list(component), wall_s=0.01, **kw)


def _arrival(peer, msg_id, staleness=0):
    return {"peer": peer, "msg_id": msg_id, "msg_epoch": 1,
            "staleness": staleness, "latency_s": 0.01, "weight": 1.0}


def _clean():
    return [
        _send(1, 0, 10.0, to=0, msg_id=0),
        _recv(0, 0, 10.2, src=1, msg_id=0),
        _merge(0, 1, 11.0, 1, [_arrival(1, 0)], chain_len=2, head8="aa",
               rewrite=False),
        _send(1, 1, 11.5, to=0, msg_id=1),
        _recv(0, 2, 11.7, src=1, msg_id=1),
        _merge(0, 3, 12.0, 2, [_arrival(1, 1, staleness=1)], chain_len=4,
               head8="bb", rewrite=False),
        _ev("round", 1, 2, 12.5, round=0, wall_s=0.4),
        _ev("phase", 0, 4, 12.6, name="train", wall_s=0.3),
        _ev("run.end", 1, 3, 20.0, status="ok"),
        _ev("run.end", 0, 5, 20.0, status="ok"),
    ]


def _fixture(name):
    ev = _clean()
    if name == "double_merge":
        ev[5]["arrivals"] = [_arrival(1, 0)]
    elif name == "lost_ack":
        del ev[4]
    elif name == "cross_partition":
        ev[2]["component"] = [0, 2]
    elif name == "quarantine_no_evidence":
        ev.append(_ev("rep.transition", 0, 6, 13.0, client=1, trust=0.1,
                      scope="peer", **{"from": "suspect",
                                       "to": "quarantined"}))
    elif name == "shrinking_chain":
        ev.append(_ev("ledger", 0, 6, 14.0, op="append", chain_len=1,
                      rewrite=False, head8="cc"))
    return ev


FIXTURES = ["clean", "double_merge", "lost_ack", "cross_partition",
            "quarantine_no_evidence", "shrinking_chain", "torn_tail"]


def _write(tmp_path, events, torn=False):
    by_peer = {}
    for e in events:
        by_peer.setdefault(e["peer"], []).append(e)
    for p, evs in by_peer.items():
        with open(tmp_path / f"events_peer{p}.jsonl", "w") as f:
            for e in evs:
                f.write(json.dumps(e) + "\n")
            if torn:
                f.write('{"v": 1, "ev": "round", "pe')


@pytest.mark.parametrize("name", FIXTURES)
def test_collate_run_equals_jax(tmp_path, name):
    _write(tmp_path, _fixture("clean" if name == "torn_tail" else name),
           torn=name == "torn_tail")
    got = T.collate_run(str(tmp_path))
    want = J.collate_run(str(tmp_path))
    assert json.dumps(got, sort_keys=True, default=str) == json.dumps(
        want, sort_keys=True, default=str)
    assert got["ok"] == (name in ("clean", "torn_tail"))


def test_catalogues_equal_jax():
    assert T.EVENT_TYPES == J.EVENT_TYPES
    assert T.SCHEMA_VERSION == J.SCHEMA_VERSION
    assert list(T.INVARIANTS) == list(J.INVARIANTS)


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in STAMPS}


def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_writers_write_the_same_records(tmp_path):
    recs = {}
    for name, mod in (("port", T), ("jax", J)):
        path = str(tmp_path / f"events_{name}.jsonl")
        w = mod.EventWriter(path, peer=3, run="w", sample=0.5)
        w.emit("run.start", role="peer")
        w.emit("merge", version=1, leader=0, arrivals=[], rejected=[],
               solo=False, degraded=False, component=[0, 1],
               trust=np.float32(0.5))
        w.emit("no.such.event", x=1)  # a counted drop in both
        for i in range(8):
            w.emit_sampled("send.attempt", (3, 0, i, 1), to=0, msg_id=i,
                           attempt=1, outcome="x")
        w.close()
        recs[name] = [_strip(r) for r in _read(path)]
    assert recs["port"] == recs["jax"]


def _capture(mod, tmp_path, name, fn):
    path = str(tmp_path / f"events_{name}.jsonl")
    mod.install(mod.EventWriter(path, peer=None, run="cap"))
    try:
        fn()
    finally:
        mod.flush()
        mod.uninstall()
    return [_strip(r) for r in _read(path)]


def test_reputation_events_equal_jax(tmp_path):
    faults = [np.array([0.0, 1.0, 0.2, 0.0]), np.array([0.0, 1.0, 0.9, 0.0]),
              np.array([0.0, 0.0, 1.0, 0.0]), np.array([0.0, 0.0, 0.0, 0.0])]

    def drive(tracker):
        def fn():
            for f in faults:
                tracker.observe(f)
        return fn

    kw = dict(enabled=True, quarantine_rounds=1)
    got = _capture(T, tmp_path, "port",
                   drive(ReputationTracker(ReputationConfig(**kw), 4)))
    want = _capture(J, tmp_path, "jax",
                    drive(JTracker(JRepCfg(**kw), 4)))
    assert got == want
    kinds = {e["ev"] for e in got}
    assert {"rep.evidence", "rep.transition"} <= kinds
    assert any(e["ev"] == "rep.transition" and e["to"] == "quarantined"
               for e in got)


def test_checkpoint_events_carry_jax_fields(tmp_path):
    """``save_checkpoint`` / ``restore_latest`` / ``scrub`` emit
    ``ckpt.save`` (step, dir, wall_s, chain_len, gc), ``ckpt.restore``
    (step, dir) and ``scrub`` (status, dir, newest_intact, damaged, torn),
    the fields of ``bcfl_tpu/checkpoint/checkpoint.py``'s emits."""
    from bcfl_tpu_torch.checkpoint import (restore_latest, save_checkpoint,
                                           scrub)
    from bcfl_tpu_torch.ledger import Ledger

    led = Ledger()
    led.append_digest(0, 1, b"\x01" * 32, 10)
    ck = str(tmp_path / "ck")

    def fn():
        save_checkpoint(ck, 0, {"w": torch.ones(3)}, led.to_json())
        save_checkpoint(ck, 1, {"w": torch.zeros(3)}, led.to_json(),
                        keep_last=1)
        restore_latest(ck)
        scrub(ck)
        scrub(str(tmp_path / "empty"))

    evs = _capture(T, tmp_path, "ck", fn)
    saves = [e for e in evs if e["ev"] == "ckpt.save"]
    assert [sorted(set(e) - {"v", "ev", "run", "peer"}) for e in saves] \
        == [["chain_len", "dir", "gc", "step", "wall_s"]] * 2
    assert [(e["step"], e["chain_len"], e["gc"]) for e in saves] == [
        (0, 1, 0), (1, 1, 1)]
    (restore,) = [e for e in evs if e["ev"] == "ckpt.restore"]
    assert restore["step"] == 1 and restore["dir"] == os.path.abspath(ck)
    scrubs = [e for e in evs if e["ev"] == "scrub"]
    assert [sorted(set(e) - {"v", "ev", "run", "peer"}) for e in scrubs] \
        == [["damaged", "dir", "newest_intact", "status", "torn"]] * 2
    assert [(e["status"], e["newest_intact"]) for e in scrubs] == [
        ("clean", 1), ("empty", None)]
    for e in saves + scrubs + [restore]:
        for f in J.EVENT_TYPES[e["ev"]]:
            assert f in e


def test_step_clock_spans_land_as_phase_events(tmp_path):
    from bcfl_tpu_torch.metrics import StepClock

    def fn():
        clock = StepClock()
        with clock.phase("train"):
            pass
        clock.record("ledger", 0.25)

    evs = _capture(T, tmp_path, "clock", fn)
    assert [(e["ev"], e["name"]) for e in evs] == [("phase", "train"),
                                                  ("phase", "ledger")]
    assert evs[1]["wall_s"] == 0.25


def test_engine_streams_events_and_collates(tmp_path):
    """A local run with ``telemetry_dir`` streams its phases, rounds,
    ledger commits and reputation events, and the stream collates with
    zero violations (the same contract as the JAX engine's)."""
    from bcfl_tpu_torch.config import FedConfig, LedgerConfig, PartitionConfig
    from bcfl_tpu_torch.entrypoints import run

    cfg = FedConfig(model="tiny-bert", dataset="synthetic", num_clients=2,
                    num_rounds=2, seq_len=16, batch_size=4,
                    max_local_batches=1, max_eval_batches=1, vocab_size=512,
                    partition=PartitionConfig(kind="iid", iid_samples=8),
                    ledger=LedgerConfig(enabled=True),
                    reputation=ReputationConfig(enabled=True),
                    telemetry_dir=str(tmp_path))
    run(cfg, device="cpu", verbose=False)
    evs = _read(tmp_path / "events_engine.jsonl")
    kinds = [e["ev"] for e in evs]
    assert kinds[0] == "run.start" and kinds[-1] == "run.end"
    assert kinds.count("round") == 2
    assert {"phase", "ledger"} <= set(kinds)
    col = T.collate_run(str(tmp_path))
    assert col["ok"], col["violations"]
    assert J.collate_run(str(tmp_path))["ok"]
