"""The port's storage repair end to end on CPU loopback, held to JAX's
assertions (``tests/test_storage_faults.py::
test_three_peer_loopback_storage_repair``): three peers, peer 2
SIGKILLed once a checkpoint is committed, its newest meta sidecar
bit-flipped while it is down, restarted with ``--resume --bootstrap``.
The startup scrub flags the damage, the repair is a chain-verified
STATE_SYNC adopt, the fleet completes with agreeing heads, and the whole
invariant suite is clean over the collated streams. ``buffer=3`` with a
long ``buffer_timeout_s`` keeps the leader from running to the target
while peer 2 is down, so there is a live fleet to repair from; 10
versions and a kill at peer 2's first committed checkpoint keep the kill
well before the end. The leader, the quorum and the followers wait out a
restart that a loaded host slows down (each peer is a fresh interpreter),
and every assertion names the run's timeline, so a failure says which
step went wrong.

A second run arms the in-process lanes instead: the seeded storage draw
damages peer 1's own commits, and the leader tampers its first serve to a
bootstrapping peer 2 (``sync_tamper``), which refuses it and adopts a
clean transfer. Its kill waits on the event it needs, peer 2's first
committed checkpoint, with no window on the wall clock: a loaded host
that starts peer 2 late delays the kill, it does not skip it."""

import pytest

from bcfl_tpu_torch import config as tconfig
from bcfl_tpu_torch.faults import FaultPlan

pytestmark = [pytest.mark.dist, pytest.mark.faults]


def _cfg(**kw):
    base = dict(
        name="storage_loopback", runtime="dist", mode="server",
        sync="async", model="tiny-bert", dataset="synthetic",
        num_clients=6, num_rounds=10, seq_len=16, batch_size=4,
        max_local_batches=2, eval_every=0, seed=42, vocab_size=512,
        partition=tconfig.PartitionConfig(kind="iid", iid_samples=8),
        ledger=tconfig.LedgerConfig(enabled=True),
        dist=tconfig.DistConfig(peers=3, buffer=3, buffer_timeout_s=60.0,
                                idle_timeout_s=240.0, peer_deadline_s=400.0,
                                checkpoint_every_versions=1,
                                checkpoint_keep_last=2, suspect_after=1,
                                quorum_frac=0.9))
    base.update(kw)
    return tconfig.FedConfig(**base)


def _events(res):
    from bcfl_tpu_torch.telemetry import read_stream

    return [e for p in res["event_streams"] for e in read_stream(p)[0]]


#: the events that tell a repair run's story, and the fields worth showing
_STORY = ("run.start", "run.end", "merge", "detector", "quorum.below",
          "scrub", "state.sync.request", "state.sync.serve",
          "state.sync.verify", "state.sync.refuse", "state.sync.adopt")
_FIELDS = ("version", "status", "target", "from", "to", "ok", "reason",
           "alive", "resumed")


def _timeline(res, evs=None) -> str:
    """The run's churn record and its story events in wall-clock order,
    one line each, seconds from the first event: what a failed assertion
    prints."""
    evs = sorted((e for e in (evs if evs is not None else _events(res))
                  if e["ev"] in _STORY), key=lambda e: e["t_wall"])
    t0 = evs[0]["t_wall"] if evs else 0.0
    lines = [f"returncodes {res['returncodes']}, churn {res['churn']}, "
             f"wall {res['wall_s']:.1f} s"]
    for e in evs:
        fields = {k: e[k] for k in _FIELDS if k in e}
        if e["ev"] == "merge":
            fields["from_peers"] = sorted({a.get("peer")
                                           for a in e.get("arrivals", ())})
        lines.append(f"{e['t_wall'] - t0:7.2f} peer {e['peer']} {e['ev']} "
                     f"{fields}")
    return "\n".join(lines)


def test_three_peer_loopback_storage_repair(tmp_path):
    from bcfl_tpu_torch.dist import run_dist
    from bcfl_tpu_torch.telemetry import collate

    # the churn loop fires at its first check after period_s at which peer
    # 2 has a committed checkpoint: a fresh interpreter takes longer than
    # 1 s to commit one, so this is peer 2's first commit
    res = run_dist(_cfg(), str(tmp_path / "run"), deadline_s=460.0,
                   device="cpu", threads=2,
                   churn={"peer": 2, "cycles": 1, "period_s": 1.0,
                          "downtime_s": 1.0, "stop_after_s": 200.0,
                          "damage": ["meta_flip"], "bootstrap": True})
    evs = _events(res)
    story = _timeline(res, evs)
    assert res["ok"], (story, res["log_tails"])
    assert res["churn"], f"the supervised kill never fired\n{story}"
    assert (res["churn"][0].get("damage") or {}).get("cls") == "meta_flip", \
        story
    assert any(e["ev"] == "scrub" and e.get("status") == "damaged"
               for e in evs), f"the bit-flip never surfaced in a scrub\n{story}"
    assert any(e["ev"] == "state.sync.verify" and e.get("ok")
               for e in evs), f"no chain-verified transfer\n{story}"
    adopts = [e for e in evs if e["ev"] == "state.sync.adopt"]
    assert adopts, f"the damaged peer never adopted a repair\n{story}"
    col = collate(res["event_streams"])
    assert col["ok"], (col["violations"], story)
    assert col["invariants"]["repair_authenticated"] == 0, story
    assert col["invariants"]["no_rollback_readmission"] == 0, story
    reports = res["reports"]
    assert len({r["chain_head"] for r in reports.values()}) == 1, story
    assert reports[2]["repaired"]["reason"] in ("damaged", "rollback"), story
    assert reports[2]["incarnation"] == 2, story


def test_seeded_storage_lane_and_tampered_serve(tmp_path):
    from bcfl_tpu_torch.dist import run_dist
    from bcfl_tpu_torch.telemetry import collate

    plan = FaultPlan(seed=4, storage_peers=(1,), storage_prob=1.0,
                     storage_classes=("payload_flip", "ledger"),
                     storage_rounds=(1,), sync_tamper=((0, 2),))
    # peer 2 is killed at the harness's first check after its first
    # committed checkpoint (period 0, no stop window) and restarted at once
    res = run_dist(_cfg(faults=plan), str(tmp_path / "run"),
                   deadline_s=460.0, device="cpu", threads=2,
                   churn={"peer": 2, "cycles": 1, "period_s": 0.0,
                          "downtime_s": 0.0, "damage": ["delete"],
                          "bootstrap": True})
    evs = _events(res)
    story = _timeline(res, evs)
    assert res["ok"], (res["returncodes"], res["log_tails"], story)
    assert res["churn"], f"the supervised kill never fired\n{story}"
    chaos = [e for e in evs if e["ev"] == "chaos" and e["lane"] == "storage"]
    assert [e["peer"] for e in chaos] == [1], story
    assert chaos[0]["action"] == plan.storage_action(1, 1)["cls"], story
    serves = [e for e in evs if e["ev"] == "state.sync.serve"]
    assert serves and serves[0]["to"] == 2 and serves[0]["tampered"], story
    refusals = [e for e in evs if e["ev"] == "state.sync.refuse"]
    assert [e["reason"] for e in refusals][:1] == ["digest_mismatch"], story
    verdicts = [e["ok"] for e in evs if e["ev"] == "state.sync.verify"]
    assert verdicts[:2] == [False, True], (verdicts, story)
    adopts = [e for e in evs if e["ev"] == "state.sync.adopt"]
    assert [e["peer"] for e in adopts] == [2], story
    col = collate(res["event_streams"])
    assert col["ok"], (col["violations"], story)
    assert len({r["chain_head"] for r in res["reports"].values()}) == 1, \
        story
