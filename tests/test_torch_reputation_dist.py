"""The port's per-peer reputation (``bcfl_tpu_torch/reputation/dist.py``)
against JAX's ``bcfl_tpu/reputation/dist.py``: the reserved ledger rows
encoded and decoded bit for bit; ``commit_transitions`` on the port's
ledger reaching JAX's chain head for the same transitions; ``absorb_rows``;
a scripted evidence sequence through every ``note_*`` lane driving state,
timer, trust, slowness and gate to JAX's values exactly, with the same
evidence events; the checkpoint round trip bit for bit through the port's
checkpoint files; the quarantine invariants on JAX's event fixtures;
and a 3-peer CPU loopback run whose quarantining leader is SIGKILLed and
resumed, graded by ``scripts/dist_byzantine.py``'s resume gates (the
tracker restored bit for bit from the file, the adversary never
readmitted, no post-quarantine merge across both incarnations)."""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from bcfl_tpu import telemetry as jtel
from bcfl_tpu.ledger import Ledger as JLedger
from bcfl_tpu.reputation import ReputationConfig as JRepCfg
from bcfl_tpu.reputation import dist as jrd
from bcfl_tpu_torch import telemetry as ttel
from bcfl_tpu_torch.ledger import Ledger as TLedger
from bcfl_tpu_torch.reputation import ReputationConfig
from bcfl_tpu_torch.reputation import dist as trd

pytestmark = pytest.mark.dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


ROWS = [(0, 0, 0, 0, 1.0), (2, 2, 7, 3, 0.3168), (4, 3, 2, 1, 0.7),
        (1, 1, -1, 0, 0.5999999999999999), (7, 2, 100000, 9, 1e-300)]


@pytest.mark.parametrize("row", ROWS, ids=[str(i) for i in range(len(ROWS))])
def test_rep_rows_equal_jax(row):
    peer = row[0]
    digest = trd.encode_rep_row(*row)
    assert digest == jrd.encode_rep_row(*row) and len(digest) == 32
    client = trd.rep_row_client(peer)
    assert client == jrd.rep_row_client(peer) == trd.REP_CLIENT_BASE - peer
    assert trd.decode_rep_row(client, digest) == jrd.decode_rep_row(
        client, digest)
    # ordinary ids, foreign bytes, a mismatched peer binding, a bad state
    bad_state = trd.encode_rep_row(peer, 9, 0, 0, 1.0)
    for c, d in ((5, digest), (client, os.urandom(32)),
                 (trd.rep_row_client(peer + 1), digest), (client, b"x"),
                 (client, bad_state)):
        assert trd.decode_rep_row(c, d) == jrd.decode_rep_row(c, d) is None
    assert trd._ROW_FMT == jrd._ROW_FMT and trd._ROW_MAGIC == jrd._ROW_MAGIC


def _both(peers=4, self_id=0, **cfg_kw):
    return (trd.DistReputationTracker(ReputationConfig(enabled=True,
                                                       **cfg_kw),
                                      peers, self_id),
            jrd.DistReputationTracker(JRepCfg(enabled=True, **cfg_kw),
                                      peers, self_id))


def _assert_same(t, j):
    for k in ("trust", "state", "timer", "quarantine_events",
              "rounds_quarantined"):
        a, b = getattr(t.tracker, k), getattr(j.tracker, k)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    assert t._slow.tobytes() == j._slow.tobytes()
    assert t._pending.tobytes() == j._pending.tobytes()
    assert t.report() == j.report()
    for p in range(t.peers):
        assert t.gate(p) == j.gate(p)
        assert t.is_quarantined(p) == j.is_quarantined(p)
    assert t.quarantined_peers() == j.quarantined_peers()


# (method, args) per step; None closes a merge with the listed arrivals
SCRIPT = [
    ("note_auth_failure", (3, 1.0)), ("note_outlier", (1, 5.0)),
    ("note_staleness", (2, 4)), ("note_staleness", (2, 5)),
    ("note_slowness", (1, 0.3)), ("note_slowness", (2, 0.0)),
    ("observe_merge", ([0, 1, 2],)),
    ("note_auth_failure", (3, 0.5)), ("note_replay", (1, "fork lineage "
                                                       "mismatch")),
    ("note_detector_down", (2,)), ("note_outlier", (0, None)),
    ("note_slowness", (1, 1.7)),
    ("observe_merge", ([1, 3],)),
    ("note_auth_failure", (3, 1.0)), ("note_outlier", (1, 2.0)),
    ("note_auth_failure", (9, 1.0)), ("note_slowness", (-1, 0.5)),
    ("observe_merge", ([],)),
    ("note_replay", (2, "unknown base version")),
    ("observe_merge", ([0, 1, 2, 3],)),
    ("observe_merge", ([0, 1, 2, 3],)),
    ("note_outlier", (1, None)), ("note_auth_failure", (1, 1.0)),
    ("observe_merge", ([1],)),
    ("observe_merge", ([0, 2],)),
    ("observe_merge", ([1, 3],)),
    ("note_auth_failure", (3, 1.0)),
    ("observe_merge", ([3],)),
    ("observe_merge", ([0, 1, 2, 3],)),
]


def test_scripted_evidence_drives_the_tracker_as_jax(tmp_path):
    """Every ``note_*`` lane, quarantine, probation readmission and a
    repeat offense on probation, the slowness EWMA and the gate: the
    arrays after each step bit for bit JAX's, the transitions and the
    evidence events equal."""
    t, j = _both(quarantine_rounds=2, probation_rounds=2)
    jpath, tpath = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    jtel.install(jtel.EventWriter(str(jpath), peer=0, run="x"))
    ttel.install(ttel.EventWriter(str(tpath), peer=0, run="x"))
    seen = set()
    try:
        for name, args in SCRIPT:
            assert getattr(t, name)(*args) == getattr(j, name)(*args), name
            _assert_same(t, j)
            seen.update(t.tracker.state_names())
    finally:
        jtel.flush()
        ttel.flush()
        jtel.uninstall()
        ttel.uninstall()
    assert seen == {"healthy", "suspect", "quarantined", "probation"}

    def events(path):
        skip = {"t_wall", "t_mono", "pid", "seq", "run", "v"}
        return [{k: v for k, v in e.items() if k not in skip}
                for e in map(json.loads, open(path))
                if e["ev"].startswith("rep.")]

    assert events(tpath) == events(jpath) and events(tpath)


def test_commit_and_absorb_reach_jax_chain_head():
    t, j = _both(peers=3)
    for _ in range(2):
        t.note_auth_failure(2, 1.0)
        j.note_auth_failure(2, 1.0)
        tr_t = t.observe_merge([1, 2])
        tr_j = j.observe_merge([1, 2])
        assert tr_t == tr_j
    assert t.is_quarantined(2) and ("suspect", "quarantined") == tr_t[0][1:]
    tchain, jchain = TLedger(use_native=False), JLedger(use_native=False)
    for chain in (tchain, jchain):
        chain.append_digest(0, 4, b"\x01" * 32, 100)  # an ordinary row
    assert (t.commit_transitions(tchain, 5, tr_t)
            == j.commit_transitions(jchain, 5, tr_j) == len(tr_t))
    assert tchain.head.hex() == jchain.head.hex()
    assert tchain.segment(0) == jchain.segment(0)
    assert tchain.verify_chain() == -1
    assert t.commit_transitions(None, 5, tr_t) == 0
    assert t.commit_transitions(tchain, 6, []) == 0
    # a follower inherits the verdict from the adopted segment
    ft, fj = _both(peers=3, self_id=1)
    rows = tchain.segment(0)
    assert ft.absorb_rows(rows) == fj.absorb_rows(rows) == len(tr_t)
    _assert_same(ft, fj)
    assert ft.is_quarantined(2)
    assert ft.tracker.trust[2] == t.tracker.trust[2]
    # malformed rows are skipped, never raise; a peer out of range too
    junk = [{"bad": 1}, None, {"client": "x"},
            {"client": trd.rep_row_client(7),
             "digest": trd.encode_rep_row(7, 2, 1, 1, 0.1).hex()}]
    assert ft.absorb_rows(junk) == fj.absorb_rows(junk) == 0


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    """The tracker through the port's checkpoint files (``rep_*`` keys as
    tensors) restores bit for bit, the report's hex trust included."""
    from bcfl_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint

    a, ja = _both()
    for tr in (a, ja):
        tr.note_auth_failure(1, 1.0)
        tr.note_outlier(2, distance=5.0)
        tr.note_staleness(3, tr.cfg.staleness_limit + 3)
        tr.note_slowness(3, 0.37)
        tr.observe_merge([1, 2, 3])
    state = a.checkpoint_state()
    assert set(state) == set(ja.checkpoint_state())
    save_checkpoint(str(tmp_path), 3, dict(state, version=np.int64(3)))
    _, back, _ = restore_checkpoint(str(tmp_path), 3)
    b, _ = _both()
    b.restore(back)
    _assert_same(b, ja)
    assert b.report()["trust_hex"] == a.report()["trust_hex"]
    assert b.report()["slow_hex"] == a.report()["slow_hex"]


# ------------------------------------------------------------ loopback


def _dist_byzantine():
    spec = importlib.util.spec_from_file_location(
        "dist_byzantine", os.path.join(REPO, "scripts", "dist_byzantine.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quarantining_leader_killed_and_resumed(tmp_path):
    """The resume leg of ``scripts/dist_byzantine.py``: the byzantine run
    of ``test_torch_dist_byzantine.py`` to the script's 8 versions, peer 0
    (the quarantining leader) SIGKILLed once its version-5 checkpoint is
    committed (the script's default) and restarted with ``--resume``.
    Chaos seed 12 makes the adversary's first two updates forgeries (the
    byzantine clock reads the round after the one trained), so the
    quarantine lands two merges in whatever the host's load, well before
    the kill. Every assertion of the
    loopback test, plus the script's resume gates: the leader killed and
    resumed, its restored tracker bit for bit the kept checkpoint file's,
    the adversary restored quarantined and never readmitted, the verdict
    within the evidence budget, one head."""
    from test_torch_dist_byzantine import byz_cfg, check_byz_run

    from bcfl_tpu_torch.dist import run_dist
    from bcfl_tpu_torch.reputation.lifecycle import STATE_NAMES

    cfg = byz_cfg(idle_timeout_s=120.0)
    cfg = cfg.replace(num_rounds=8, faults=dataclasses.replace(cfg.faults,
                                                               seed=12))
    res = run_dist(cfg, str(tmp_path / "resume"), deadline_s=320.0,
                   device="cpu", threads=2, kill_peer=0,
                   kill_after_version=5)
    col = check_byz_run(res)
    reports, kill = res["reports"], res["kill"]
    leader = reports[0]
    assert kill is not None and kill["restarted"]
    assert leader["resumed"] is True and leader["status"] == "ok"
    restored = leader["restored_reputation"]
    assert restored and leader["restored_from_version"] == kill["round"]
    state = torch.load(os.path.join(kill["kept"], f"round_{kill['round']:06d}",
                                    "state.pt"), weights_only=True)
    assert restored["trust_hex"] == [float(t).hex()
                                     for t in state["rep_trust"].tolist()]
    assert restored["state"] == [STATE_NAMES[int(s)]
                                 for s in state["rep_state"]]
    assert restored["timer"] == [int(t) for t in state["rep_timer"]]
    assert restored["quarantine_events"] == [
        int(x) for x in state["rep_quarantine_events"]]
    # no readmission: restored quarantined, quarantined at the end, and no
    # merge of either incarnation took a post-quarantine arrival
    assert restored["state"][2] == "quarantined"
    assert leader["reputation"]["state"][2] == "quarantined"
    pids = {e["pid"] for e in col["ordered"] if e.get("peer") == 0}
    assert len(pids) == 2 and col["invariants"]["no_quarantined_merge"] == 0
    # the resumed leader re-declared the restored verdict in its stream
    assert any(e["ev"] == "rep.transition" and e.get("from") == "restored"
               and e["pid"] == leader["pid"] for e in col["ordered"])
    # JAX's own record of the verdict and the consensus
    db = _dist_byzantine()
    quar = db._quarantine_record(reports, 2, col["ordered"])
    assert quar["quarantined_at_version"] is not None
    assert quar["quarantined_at_version"] <= max(cfg.num_rounds // 2, 3)
    assert all(s == "quarantined" for s in quar["state_per_peer"].values())
    cons = db._consensus(reports)
    assert cons["one_head"] and cons["chains_ok"]


# ------------------------------------------- no_quarantined_merge invariant


def _ev(ev, seq, t, pid=7001, **fields):
    rec = {"v": 1, "ev": ev, "run": "fx", "peer": "A", "pid": pid,
           "seq": seq, "t_wall": t, "t_mono": t}
    rec.update(fields)
    return rec


def _qtrans(seq, t, client, to="quarantined", scope="peer", pid=7001,
            frm="suspect"):
    return _ev("rep.transition", seq, t, pid=pid, client=client,
               scope=scope, trust=0.3, **{"from": frm, "to": to})


def _mrg(seq, t, version, from_peers, pid=7001):
    return _ev("merge", seq, t, pid=pid, version=version, leader="A",
               arrivals=[{"peer": p, "msg_id": i, "msg_epoch": 1}
                         for i, p in enumerate(from_peers)],
               rejected=[], solo=False, degraded=False, component=[0, 1, 2])


# JAX's cases (``tests/test_dist_byzantine.py``): a post-quarantine merge,
# the gate holding, a client-scoped lifecycle, a new incarnation with and
# without the restored re-declaration, readmission on probation, and a
# quarantine with only slowness evidence before it
STREAMS = {
    "post_quarantine_merge": [_mrg(1, 10.0, 1, [1, 2]),
                              _qtrans(2, 11.0, 2),
                              _mrg(3, 12.0, 2, [1, 2])],
    "gate_held": [_qtrans(1, 10.0, 2), _mrg(2, 11.0, 1, [0, 1])],
    "client_scope": [_qtrans(1, 10.0, 2, scope="client"),
                     _mrg(2, 11.0, 1, [2])],
    "new_incarnation": [_qtrans(1, 10.0, 2, pid=7001),
                        _mrg(1, 20.0, 5, [2], pid=7002)],
    "redeclared": [_qtrans(1, 10.0, 2, pid=7001),
                   _qtrans(1, 19.0, 2, pid=7002, frm="restored"),
                   _mrg(2, 20.0, 5, [2], pid=7002)],
    "readmitted": [_qtrans(1, 10.0, 2), _qtrans(2, 12.0, 2, to="probation"),
                   _mrg(3, 13.0, 2, [2])],
    "slowness_only": [_ev("rep.dist_evidence", 1, 9.0, target=2,
                          source="slowness", fault=0.9),
                      _qtrans(2, 10.0, 2)],
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_quarantine_invariants_equal_jax(name):
    from bcfl_tpu.telemetry import invariants as jinv
    from bcfl_tpu_torch.telemetry import invariants as tinv

    events = STREAMS[name]
    for rule in ("no_quarantined_merge", "slowness_is_not_malice",
                 "quarantine_evidence"):
        got = getattr(tinv, rule)(events)
        assert got == getattr(jinv, rule)(events), rule
    fired = tinv.no_quarantined_merge(events)
    assert bool(fired) is (name in ("post_quarantine_merge", "redeclared"))
