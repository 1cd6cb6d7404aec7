"""The port's storage fault lane and state-sync repair gates against the
JAX package: the fault plan's ``storage_action`` / ``sync_tamper_action``
draws bit for bit over a seeded grid and JAX's plan checks; for every
damage class of ``STORAGE_CLASSES``, ``apply_storage_fault`` on a
committed 3-round directory followed by ``classify_round`` / ``scrub`` /
``restore_latest`` gives the status JAX gives on its own format (a small
state and a large one, where the largest byte range is the pickled
structure and then a tensor); retention and ``keep_meta``; the config's
storage-lane checks with JAX's messages; and ``_handle_state_sync``'s two
gates on a stand-in runtime (mirrors ``tests/test_storage_faults.py``)."""

import os
import shutil
import types

import numpy as np
import pytest
import torch

from bcfl_tpu import checkpoint as jck
from bcfl_tpu import config as jconfig
from bcfl_tpu.faults import FaultPlan as JPlan
from bcfl_tpu.ledger.ledger import Ledger as JLedger
from bcfl_tpu_torch import checkpoint as tck
from bcfl_tpu_torch import config as tconfig
from bcfl_tpu_torch.checkpoint.checkpoint import _remove_round
from bcfl_tpu_torch.faults import FaultPlan
from bcfl_tpu_torch.faults.plan import STORAGE_CLASSES
from bcfl_tpu_torch.ledger.ledger import GENESIS, Ledger, params_digest

pytestmark = [pytest.mark.dist, pytest.mark.faults]


# ------------------------------------------------------------ seeded draws


@pytest.mark.parametrize("seed,peers,prob,classes,rounds,delete_last", [
    (5, (1, 2), 0.5, STORAGE_CLASSES, tuple(range(1, 40)), 1),
    (11, None, 1.0, ("delete", "rollback"), None, 3),
    (0, (0,), 0.75, ("meta_flip", "torn", "ledger"), (2, 5, 9), 2),
])
def test_storage_draws_equal_jax(seed, peers, prob, classes, rounds,
                                 delete_last):
    kw = dict(seed=seed, storage_peers=peers, storage_prob=prob,
              storage_classes=classes, storage_rounds=rounds,
              storage_delete_last=delete_last,
              sync_tamper=((0, 1), (2, 0), (1, 3)))
    t, j = FaultPlan(**kw), JPlan(**kw)
    grid = [(v, p) for v in range(48) for p in range(4)]
    draws = [t.storage_action(v, p) for v, p in grid]
    assert draws == [j.storage_action(v, p) for v, p in grid]
    assert any(draws), "the armed lane never fired"
    tam = [(s, r, n) for s in range(4) for r in range(4) for n in range(3)]
    assert ([t.sync_tamper_action(*x) for x in tam]
            == [j.sync_tamper_action(*x) for x in tam])
    assert t.storage_enabled == j.storage_enabled


VACUOUS = [
    dict(storage_peers=(0,)),
    dict(storage_prob=0.5, storage_rounds=()),
    dict(storage_rounds=(2,)),
    dict(storage_prob=0.5, storage_classes=("bogus",)),
    dict(storage_prob=0.5, storage_classes=()),
    dict(storage_delete_last=0),
    dict(sync_tamper=((0, 0),)),
    dict(sync_tamper=((0, 1), (0, 1))),
    dict(storage_prob=1.5),
    dict(storage_peers=(1, 1), storage_prob=0.5),
    dict(storage_peers=[1], storage_prob=0.5),
    dict(storage_prob=0.5, storage_rounds=[1]),
]


@pytest.mark.parametrize("kw", VACUOUS, ids=[str(i) for i in range(len(VACUOUS))])
def test_vacuous_storage_plans_refused_as_jax(kw):
    with pytest.raises(ValueError) as j:
        JPlan(seed=1, **kw)
    with pytest.raises(ValueError) as t:
        FaultPlan(seed=1, **kw)
    assert str(t.value) == str(j.value)


# ------------------------------------------------- damage x classification


def _state(v: float, big: bool):
    if big:
        w = np.random.default_rng(int(v)).normal(size=(512, 512))
        return {"trainable": {"w": w.astype(np.float32)},
                "seed": np.int64(42)}
    return {"trainable": {"w": np.full((8, 4), v, np.float32)},
            "seed": np.int64(42)}


def _ledger_json(mod, n: int) -> str:
    led = mod()
    for i in range(n):
        led.append(i, i % 2, {"w": np.full((4,), float(i), np.float32)})
    return led.to_json()


@pytest.fixture(scope="module")
def seeds(tmp_path_factory):
    """Three committed rounds with embedded ledgers, in each package's
    format, for a small and a large state (built once, copied per
    class)."""
    out = {}
    for big in (False, True):
        for pkg, save, led in (("jax", jck.save_checkpoint, JLedger),
                               ("port", tck.save_checkpoint, Ledger)):
            d = str(tmp_path_factory.mktemp(f"{pkg}_{big}") / "ck")
            for r in range(3):
                state = _state(float(r), big)
                if pkg == "port":
                    state = {"trainable": {"w": torch.from_numpy(
                        state["trainable"]["w"])}, "seed": state["seed"]}
                save(d, r, state, ledger_json=_ledger_json(led, r + 1))
            out[(pkg, big)] = d
    return out


def _damaged(mod, seed_dir, tmp_path, cls, frac):
    d = str(tmp_path / os.path.basename(os.path.dirname(seed_dir)))
    shutil.copytree(seed_dir, d)
    rec = mod.apply_storage_fault(d, {"cls": cls, "frac": frac,
                                      "delete_last": 1})
    status = mod.classify_round(d, 2)[0]
    rep = mod.scrub(d)
    latest = mod.restore_latest(d)
    return rec, status, rep, latest


@pytest.mark.parametrize("big", [False, True], ids=["small", "large"])
@pytest.mark.parametrize("cls", STORAGE_CLASSES)
def test_damage_class_status_equals_jax(cls, big, seeds, tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jrec, jstatus, jrep, jlatest = _damaged(
        jck, seeds[("jax", big)], tmp_path / "j", cls, 0.4)
    trec, tstatus, trep, tlatest = _damaged(
        tck, seeds[("port", big)], tmp_path / "t", cls, 0.4)
    assert trec["cls"] == jrec["cls"] == cls
    assert trec["round"] == jrec["round"] == 2
    assert tstatus == jstatus, (cls, tstatus, jstatus)
    assert tck.restore_checkpoint(os.path.dirname(
        trec.get("file") or "x"), 2) is None
    assert trep["rounds"] == jrep["rounds"]
    assert trep["damaged"] == jrep["damaged"]
    assert trep["newest_intact"] == jrep["newest_intact"] == 1
    assert bool(trep["torn"]) == bool(jrep["torn"]) == (cls == "torn")
    assert not trep["empty"]
    for key in ("rounds", "row", "now_newest"):
        assert trec.get(key) == jrec.get(key), key
    # bounded fallback: every class leaves round 1 intact and restorable
    assert tlatest[0] == jlatest[0] == 1
    np.testing.assert_array_equal(tlatest[1]["trainable"]["w"].numpy(),
                                  np.asarray(jlatest[1]["trainable"]["w"]))
    assert Ledger.from_json(tlatest[2]).verify_chain() == -1


def test_byte_classes_target_the_largest_range(seeds, tmp_path):
    """payload_flip lands in the pickled structure of a small state and in
    the tensor bytes of a large one, as JAX's lands in the orbax metadata
    and then in the array data; truncate always cuts the archive."""
    for big, member, status in ((False, "data.pkl", "unrestorable"),
                                (True, "data/0", "digest_mismatch")):
        for cls, want in (("payload_flip", status),
                          ("truncate", "unrestorable")):
            sub = tmp_path / f"{cls}_{big}"
            sub.mkdir()
            rec, got, _rep, _latest = _damaged(tck, seeds[("port", big)],
                                               sub, cls, 0.4)
            assert rec["file"] == "round_000002/state.pt"
            assert rec["member"].endswith(member), rec
            assert got == want, (cls, big, got)


def test_scrub_clean_and_empty(seeds, tmp_path):
    rep = tck.scrub(seeds[("port", False)])
    jrep = jck.scrub(seeds[("jax", False)])
    assert rep["rounds"] == jrep["rounds"]
    assert not rep["damaged"] and not rep["torn"] and not rep["empty"]
    assert rep["newest_intact"] == 2
    assert tck.scrub(str(tmp_path / "nothing"))["empty"]
    assert tck.apply_storage_fault(str(tmp_path / "nothing"),
                                   {"cls": "torn", "frac": 0.1}) is None
    with pytest.raises(ValueError, match="unknown storage damage class"):
        d = str(tmp_path / "ck")
        shutil.copytree(seeds[("port", False)], d)
        tck.apply_storage_fault(d, {"cls": "bogus"})


# ----------------------------------------------------------------- retention


def test_retention_and_keep_meta(tmp_path):
    d = str(tmp_path / "ck")
    for r in range(5):
        tck.save_checkpoint(d, r, {"w": torch.full((2,), float(r))},
                            ledger_json=_ledger_json(Ledger, r + 1),
                            keep_last=2)
    rep = tck.scrub(d)
    assert [r for r, _s in rep["rounds"]] == [3, 4]
    assert not rep["damaged"] and rep["newest_intact"] == 4
    # keep_meta: the dir goes, the sidecar stays as evidence ("deleted")
    _remove_round(d, 3, keep_meta=True)
    assert tck.classify_round(d, 3)[0] == "deleted"
    _remove_round(d, 3, keep_meta=False)
    assert tck.classify_round(d, 3)[0] == "missing"
    assert [r for r, _s in tck.scrub(d)["rounds"]] == [4]
    # keep_last=1: the round just committed always stays restorable
    d1 = str(tmp_path / "ck1")
    for r in range(3):
        tck.save_checkpoint(d1, r, {"w": torch.zeros(2)}, keep_last=1)
        assert tck.restore_latest(d1)[0] == r


# --------------------------------------------------- the config's checks


def _cfg_pair(faults, **dist_kw):
    out = {}
    ledger = dist_kw.pop("_ledger", True)
    for name, mod, plan in (("port", tconfig, FaultPlan),
                            ("jax", jconfig, JPlan)):
        kw = dict(runtime="dist", mode="server", sync="async", eval_every=0,
                  dataset="synthetic", model="tiny-bert", num_clients=4,
                  num_rounds=2, seq_len=16, batch_size=4,
                  ledger=mod.LedgerConfig(enabled=ledger),
                  faults=plan(**faults), dist=mod.DistConfig(**dist_kw))
        try:
            out[name] = mod.FedConfig(**kw)
        except ValueError as e:
            out[name] = str(e)
    return out


@pytest.mark.parametrize("faults,dist_kw", [
    (dict(seed=1, storage_peers=(0,), storage_prob=0.5),
     dict(peers=2, _ledger=False)),
    (dict(seed=1, storage_peers=(0,), storage_prob=0.5),
     dict(peers=2, checkpoint_every_versions=0)),
    (dict(seed=1, storage_peers=(5,), storage_prob=0.5), dict(peers=2)),
    (dict(seed=1, sync_tamper=((0, 7),)), dict(peers=2)),
    (dict(seed=1, storage_peers=(1,), storage_prob=0.5),
     dict(peers=2, checkpoint_keep_last=3)),
    (dict(seed=1, sync_tamper=((0, 1),)), dict(peers=2)),
])
def test_storage_lane_config_checks_equal_jax(faults, dist_kw):
    got = _cfg_pair(faults, **dict(dist_kw))
    if isinstance(got["jax"], str):
        assert got["port"] == got["jax"]
    else:
        assert not isinstance(got["port"], str), got["port"]
        assert got["port"].faults.storage_enabled
        assert (got["port"].dist.checkpoint_keep_last
                == got["jax"].dist.checkpoint_keep_last)


# ------------------------------------------------- STATE_SYNC receiver gates


def _mk_runtime(chain):
    """A PeerRuntime shell with exactly the state ``_handle_state_sync``
    reads: no sockets and no engine, the adopt hooks identity stubs."""
    from bcfl_tpu_torch.dist.runtime import PeerRuntime
    from bcfl_tpu_torch.metrics.tracing import StepClock

    rt = PeerRuntime.__new__(PeerRuntime)
    rt.peer_id = 1
    rt.cfg = types.SimpleNamespace(
        ledger=types.SimpleNamespace(use_native=True),
        dist=types.SimpleNamespace(checkpoint_every_versions=0),
        param_dtype="float32")
    rt.chain = chain
    rt.eng = types.SimpleNamespace(ledger=chain)
    rt.clock = StepClock()
    rt.trainable = None
    rt.version = 0
    rt.adopted = []
    rt._needs_bootstrap = True
    rt._bootstrap_reason = "damaged"
    rt._repaired = None
    rt.rep = None  # no per-peer tracker to absorb the adopted rows
    rt._last_sync_req = 99.0
    rt._cast = lambda t: t
    rt._note_version = lambda: None
    return rt


def _server_rows(model, version=3, server=0, n=4):
    led = Ledger(True)
    for i in range(n):
        led.append_digest(i, i % 2, bytes([i + 1]) * 32, 64)
    led.commit_state(version, server, params_digest(model, True))
    return led


def _recv_chain(rows, upto):
    led = Ledger(True)
    assert led.append_rows(rows[:upto]) == -1
    return led


def test_state_sync_gates_refuse_and_adopt(tmp_path):
    from bcfl_tpu_torch import telemetry as T
    from bcfl_tpu_torch.dist.runtime import _tamper_tree
    from bcfl_tpu_torch.telemetry import read_stream
    from bcfl_tpu_torch.telemetry.invariants import repair_authenticated

    model = {"enc/w": torch.arange(32, dtype=torch.float32).reshape(8, 4),
             "enc/b": torch.ones(4)}
    server = _server_rows(model)
    rows = server.segment(0)
    # the server side's in-flight tamper flips one byte of one leaf and
    # leaves the served tree itself untouched
    tampered = _tamper_tree(model, 0.3)
    assert params_digest(tampered) != params_digest(model)
    assert torch.equal(model["enc/w"],
                       torch.arange(32, dtype=torch.float32).reshape(8, 4))

    stream = str(tmp_path / "events_peer1.jsonl")
    T.install(T.EventWriter(stream, peer=1, run="needles"))
    try:
        # tampered payload: the refingerprint misses the committed row
        rt = _mk_runtime(_recv_chain(rows, 2))
        rt._handle_state_sync({"from": 0, "version": 3, "chain": rows},
                              {"model": tampered})
        assert rt._needs_bootstrap and rt._last_sync_req == 0.0

        # forged row: the segment no longer verifies from genesis
        forged = [dict(r) for r in rows]
        forged[1]["digest"] = "ab" * 32
        rt = _mk_runtime(_recv_chain(rows, 2))
        rt._handle_state_sync({"from": 0, "version": 3, "chain": forged},
                              {"model": model})
        assert rt._needs_bootstrap

        # forked history: the receiver's surviving prefix disagrees
        alt = Ledger(True)
        alt.append_digest(0, 99, b"\x77" * 32, 64)
        rt = _mk_runtime(alt)
        rt._handle_state_sync({"from": 0, "version": 3, "chain": rows},
                              {"model": model})
        assert rt._needs_bootstrap

        # rolled-back server: a strict prefix of what the receiver holds
        rt = _mk_runtime(_recv_chain(rows, len(rows)))
        rt._handle_state_sync({"from": 0, "version": 3, "chain": rows[:3]},
                              {"model": model})
        assert rt._needs_bootstrap

        # no commitment row for the claimed (version, server)
        rt = _mk_runtime(_recv_chain(rows, 2))
        rt._handle_state_sync({"from": 0, "version": 9, "chain": rows},
                              {"model": model})
        assert rt._needs_bootstrap

        # empty chain
        rt = _mk_runtime(_recv_chain(rows, 2))
        rt._handle_state_sync({"from": 0, "version": 3, "chain": []},
                              {"model": model})
        assert rt._needs_bootstrap

        # the clean serve: adopted, the replica rebuilt, the repair noted
        rt = _mk_runtime(_recv_chain(rows, 2))
        rt._handle_state_sync({"from": 0, "version": 3, "chain": rows},
                              {"model": model})
        assert not rt._needs_bootstrap
        assert rt.version == 3 and rt.adopted == [3]
        assert rt.trainable is model
        assert len(rt.chain) == len(rows) and rt.chain.verify_chain() == -1
        assert rt.eng.ledger is rt.chain
        assert rt._repaired == {"from": 0, "version": 3,
                                "reason": "damaged"}
        # a late serve after the repair is audited but never adopted
        rt._last_sync_req = 99.0
        rt._handle_state_sync({"from": 0, "version": 4, "chain": rows},
                              {"model": model})
        assert rt.version == 3 and rt.adopted == [3]
        assert rt._last_sync_req == 99.0
    finally:
        T.uninstall()

    events, _meta = read_stream(stream)
    refusals = [e for e in events if e["ev"] == "state.sync.refuse"]
    assert [e["reason"] for e in refusals] == [
        "digest_mismatch", "bad_links", "forked_prefix", "forked_prefix",
        "no_commitment", "no_chain", "no_commitment"]
    verdicts = [e["ok"] for e in events if e["ev"] == "state.sync.verify"]
    assert verdicts == [False] * 6 + [True, False]
    adopts = [e for e in events if e["ev"] == "state.sync.adopt"]
    assert len(adopts) == 1 and adopts[0]["version"] == 3
    assert adopts[0]["chain_len"] == len(rows)
    assert repair_authenticated(events) == []
    doctored = [e for e in events if not (e["ev"] == "state.sync.verify"
                                          and e.get("ok"))]
    assert len(repair_authenticated(doctored)) == 1
    assert GENESIS == bytes(32)


# --------------------------------------------------- the durability ladder


@pytest.mark.parametrize("failures,want", [
    (0, "ok"), (1, "ok"), (2, "ok"), (3, "raise"), ("eio", "eio")])
def test_durable_write_ladder_equals_jax(failures, want, tmp_path):
    """A durable write failing with ENOSPC/EMFILE walks JAX's ladder: the
    first failure drops every retained round but the newest, the second
    sheds sampled telemetry, the third raises DurabilityError; any other
    errno propagates untouched. Both packages' ``_durable_write`` run on
    stand-in runtimes against the same failure script."""
    import errno

    from bcfl_tpu import telemetry as JT
    from bcfl_tpu.dist import runtime as jrt
    from bcfl_tpu_torch import telemetry as TT
    from bcfl_tpu_torch.dist import runtime as trt

    out = {}
    for pkg, rt_mod, tele, save in (
            ("port", trt, TT, tck.save_checkpoint),
            ("jax", jrt, JT, jck.save_checkpoint)):
        d = str(tmp_path / pkg / "ck")
        for r in range(3):
            w = np.full((2,), float(r), np.float32)
            save(d, r, {"w": torch.from_numpy(w) if pkg == "port" else w})
        rt = rt_mod.PeerRuntime.__new__(rt_mod.PeerRuntime)
        rt.peer_id = 0
        rt.ckpt_dir = d
        rt.cfg = types.SimpleNamespace(faults=JPlan())
        calls = {"n": 0}

        def fn():
            calls["n"] += 1
            if failures == "eio":
                raise OSError(errno.EIO, "io")
            if calls["n"] <= failures:
                code = errno.ENOSPC if calls["n"] % 2 else errno.EMFILE
                raise OSError(code, os.strerror(code))
            return "done"

        stream = str(tmp_path / pkg / "events_peer0.jsonl")
        tele.install(tele.EventWriter(stream, peer=0, run="ladder"))
        try:
            got = rt._durable_write("checkpoint", 0, fn)
        except rt_mod.DurabilityError:
            got = "raise"
        except OSError as e:
            got = "eio" if e.errno == errno.EIO else "other"
        finally:
            shed = tele.get_writer().shedding
            tele.uninstall()
        evs = [e["ev"] for e in tele.read_stream(stream)[0]]
        rounds = [r for r, _s in (tck if pkg == "port" else jck).scrub(d)[
            "rounds"]]
        out[pkg] = (got, calls["n"], shed, rounds,
                    [e for e in evs if e in ("gc.emergency", "write.shed")])
    assert out["port"] == out["jax"]
    assert out["port"][0] == ("done" if want == "ok" else want)
    if failures in (1, 2, 3):
        assert out["port"][3] == [2]
