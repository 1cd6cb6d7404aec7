"""The port's storage repair end to end on CPU loopback, held to JAX's
assertions (``tests/test_storage_faults.py::
test_three_peer_loopback_storage_repair``): three peers, peer 2
SIGKILLed once a checkpoint is committed, its newest meta sidecar
bit-flipped while it is down, restarted with ``--resume --bootstrap``.
The startup scrub flags the damage, the repair is a chain-verified
STATE_SYNC adopt, the fleet completes with agreeing heads, and the whole
invariant suite is clean over the collated streams. ``buffer=3`` with a
long ``buffer_timeout_s`` keeps the leader from running to the target
while peer 2 is down, so there is a live fleet to repair from; 8
versions and a kill 3 s in keep the kill well before the end.

A second run arms the in-process lanes instead: the seeded storage draw
damages peer 1's own commits, and the leader tampers its first serve to a
bootstrapping peer 2 (``sync_tamper``), which refuses it and adopts a
clean transfer."""

import pytest

from bcfl_tpu_torch import config as tconfig
from bcfl_tpu_torch.faults import FaultPlan

pytestmark = [pytest.mark.dist, pytest.mark.faults]


def _cfg(**kw):
    base = dict(
        name="storage_loopback", runtime="dist", mode="server",
        sync="async", model="tiny-bert", dataset="synthetic",
        num_clients=6, num_rounds=8, seq_len=16, batch_size=4,
        max_local_batches=2, eval_every=0, seed=42, vocab_size=512,
        partition=tconfig.PartitionConfig(kind="iid", iid_samples=8),
        ledger=tconfig.LedgerConfig(enabled=True),
        dist=tconfig.DistConfig(peers=3, buffer=3, buffer_timeout_s=30.0,
                                idle_timeout_s=120.0, peer_deadline_s=280.0,
                                checkpoint_every_versions=1,
                                checkpoint_keep_last=2, suspect_after=1,
                                quorum_frac=0.9))
    base.update(kw)
    return tconfig.FedConfig(**base)


def _events(res):
    from bcfl_tpu_torch.telemetry import read_stream

    return [e for p in res["event_streams"] for e in read_stream(p)[0]]


def test_three_peer_loopback_storage_repair(tmp_path):
    from bcfl_tpu_torch.dist import run_dist
    from bcfl_tpu_torch.telemetry import collate

    res = run_dist(_cfg(), str(tmp_path / "run"), deadline_s=320.0,
                   device="cpu", threads=2,
                   churn={"peer": 2, "cycles": 1, "period_s": 3.0,
                          "downtime_s": 1.0, "stop_after_s": 150.0,
                          "damage": ["meta_flip"], "bootstrap": True})
    assert res["ok"], (res["returncodes"], res["log_tails"])
    assert res["churn"], "the supervised kill never fired"
    assert (res["churn"][0].get("damage") or {}).get("cls") == "meta_flip", \
        res["churn"]
    evs = _events(res)
    assert any(e["ev"] == "scrub" and e.get("status") == "damaged"
               for e in evs), "the bit-flip never surfaced in a scrub"
    assert any(e["ev"] == "state.sync.verify" and e.get("ok")
               for e in evs), "no chain-verified transfer"
    adopts = [e for e in evs if e["ev"] == "state.sync.adopt"]
    assert adopts, "the damaged peer never adopted a repair"
    col = collate(res["event_streams"])
    assert col["ok"], col["violations"]
    assert col["invariants"]["repair_authenticated"] == 0
    assert col["invariants"]["no_rollback_readmission"] == 0
    reports = res["reports"]
    assert len({r["chain_head"] for r in reports.values()}) == 1
    assert reports[2]["repaired"]["reason"] in ("damaged", "rollback")
    assert reports[2]["incarnation"] == 2


def test_seeded_storage_lane_and_tampered_serve(tmp_path):
    from bcfl_tpu_torch.dist import run_dist
    from bcfl_tpu_torch.telemetry import collate

    plan = FaultPlan(seed=4, storage_peers=(1,), storage_prob=1.0,
                     storage_classes=("payload_flip", "ledger"),
                     storage_rounds=(1,), sync_tamper=((0, 2),))
    res = run_dist(_cfg(faults=plan), str(tmp_path / "run"),
                   deadline_s=320.0, device="cpu", threads=2,
                   churn={"peer": 2, "cycles": 1, "period_s": 3.0,
                          "downtime_s": 1.0, "stop_after_s": 150.0,
                          "damage": ["delete"], "bootstrap": True})
    assert res["ok"], (res["returncodes"], res["log_tails"])
    evs = _events(res)
    chaos = [e for e in evs if e["ev"] == "chaos" and e["lane"] == "storage"]
    assert [e["peer"] for e in chaos] == [1]
    assert chaos[0]["action"] == plan.storage_action(1, 1)["cls"]
    serves = [e for e in evs if e["ev"] == "state.sync.serve"]
    assert serves and serves[0]["to"] == 2 and serves[0]["tampered"]
    refusals = [e for e in evs if e["ev"] == "state.sync.refuse"]
    assert [e["reason"] for e in refusals][:1] == ["digest_mismatch"]
    verdicts = [e["ok"] for e in evs if e["ev"] == "state.sync.verify"]
    assert verdicts[:2] == [False, True], verdicts
    adopts = [e for e in evs if e["ev"] == "state.sync.adopt"]
    assert [e["peer"] for e in adopts] == [2]
    col = collate(res["event_streams"])
    assert col["ok"], col["violations"]
    assert len({r["chain_head"] for r in res["reports"].values()}) == 1
