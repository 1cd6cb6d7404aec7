"""The port's byzantine lane against the JAX package's: the plan's
``byz_action`` and ``byz_rng`` draws bit for bit over a seeded grid, its
validation messages and the config's dist-time checks; ``ByzantineAdversary`` (``bcfl_tpu_torch/dist/
byzantine.py``) mutating a wire tree of CPU tensors into JAX's bytes for
every behavior, the disabled lane returning the caller's own objects,
replay from an empty and a full history, equivocation per destination, a
bfloat16 leaf passed through as JAX passes it, the counters and the
``byz.inject`` event; and a 3-peer CPU loopback run with JAX's settings
(``tests/test_dist_byzantine.py::test_three_peer_loopback_quarantines_
seeded_adversary``) held to every assertion JAX makes there, plus the
``resource`` events with JAX's fields and ``detector.phi`` events in
every peer's stream."""

import copy
import json

import ml_dtypes
import numpy as np
import pytest
import torch

from bcfl_tpu import telemetry as jtel
from bcfl_tpu.dist.byzantine import ByzantineAdversary as JAdversary
from bcfl_tpu.dist.byzantine import _map_floats as j_map_floats
from bcfl_tpu.faults import BYZ_BEHAVIORS as J_BEHAVIORS
from bcfl_tpu.faults import FaultPlan as JPlan
from bcfl_tpu_torch import telemetry as ttel
from bcfl_tpu_torch.dist.byzantine import ByzantineAdversary, _map_floats
from bcfl_tpu_torch.faults import BYZ_BEHAVIORS, FaultPlan

pytestmark = pytest.mark.dist


# ------------------------------------------------------------ fixtures


def _np_tree():
    """JAX's test tree: float leaves to poison, an int leaf that rides
    along (quantized codes), a nested level."""
    return {
        "layer/w": np.arange(6, dtype=np.float32).reshape(2, 3) / 7.0,
        "layer/codes": np.arange(4, dtype=np.int8),
        "nested": {"b": np.ones((3,), np.float32),
                   "h": (np.arange(5, dtype=np.float16) - 2) / 3},
    }


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _header():
    return {"type": "update", "base_version": 3, "round": 5,
            "wire_kind": "payload", "lineage": "ab" * 32,
            "n_ex": [4, 4], "digests": ["cd" * 32, "ef" * 32],
            "sent_at": 123.0}


def _pair(plan_kw, peer=1, clock=5):
    """A JAX and a port adversary over equal plans and one clock."""
    state = {"r": clock}
    j = JAdversary(JPlan(**plan_kw), peer, clock_fn=lambda: state["r"])
    t = ByzantineAdversary(FaultPlan(**plan_kw), peer,
                           clock_fn=lambda: state["r"])
    return j, t, state


def _leaf_items(tree, prefix=""):
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(_leaf_items(v, prefix + k + "."))
        else:
            out.append((prefix + k, v))
    return out


def _assert_same_bytes(tt, jt):
    """A port tree of tensors holds JAX's numpy tree byte for byte."""
    got, want = _leaf_items(tt), _leaf_items(jt)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, n
        assert g.tobytes() == w.tobytes(), n


# ---------------------------------------------------------- plan draws


DRAW_PLANS = [
    dict(seed=11, byz_peers=(1,)),
    dict(seed=11, byz_peers=(1, 3), byz_prob=0.5),
    dict(seed=7, byz_peers=(2,), byz_behaviors=("scale", "digest_forge")),
    dict(seed=0, byz_peers=(0, 2), byz_prob=0.3, byz_scale=3.5,
         byz_behaviors=("garbage", "replay", "equivocate")),
    dict(seed=5, byz_peers=(1,), byz_rounds=(2, 3, 7)),
    dict(),
]


@pytest.mark.parametrize("kw", DRAW_PLANS,
                         ids=[str(i) for i in range(len(DRAW_PLANS))])
def test_byz_draws_equal_jax(kw):
    t, j = FaultPlan(**kw), JPlan(**kw)
    assert t.byz_enabled == j.byz_enabled
    for rnd in range(24):
        for peer in range(4):
            assert t.byz_action(rnd, peer) == j.byz_action(rnd, peer)
            for dst in range(3):
                a = t.byz_rng(rnd, peer, dst).standard_normal(5)
                b = j.byz_rng(rnd, peer, dst).standard_normal(5)
                assert a.tobytes() == b.tobytes()
    assert BYZ_BEHAVIORS == J_BEHAVIORS


BAD_PLANS = [
    dict(byz_peers=(1,), byz_prob=0.0),
    dict(byz_rounds=(1, 2)),
    dict(byz_peers=(1,), byz_rounds=()),
    dict(byz_peers=(1,), byz_behaviors=("scale", "nonsense")),
    dict(byz_peers=(1, 1)),
    dict(byz_peers=[1]),
    dict(byz_peers=(1,), byz_behaviors=()),
    dict(byz_peers=(1,), byz_scale=float("inf")),
    dict(byz_peers=(1,), byz_rounds=[1]),
]


@pytest.mark.parametrize("kw", BAD_PLANS,
                         ids=[str(i) for i in range(len(BAD_PLANS))])
def test_byz_plan_validation_equals_jax(kw):
    msgs = []
    for cls in (FaultPlan, JPlan):
        with pytest.raises(ValueError) as e:
            cls(**kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# (peers, byz_peers, aggregator, buffer): JAX's dist-time checks
# (``bcfl_tpu/config.py``: peer ids in range, not every peer an
# adversary) and the composition of the lane with a robust rule and
# reputation (``tests/test_dist_runtime.py``)
BYZ_CONFIGS = [
    (3, (1,), "trimmed_mean", 3), (2, (0, 1), "mean", 0),
    (3, (3,), "mean", 0), (3, (0, 2), "median", 3), (4, (1, 2, 3), "mean", 0),
]


@pytest.mark.parametrize("peers,byz,rule,buffer", BYZ_CONFIGS,
                         ids=[str(i) for i in range(len(BYZ_CONFIGS))])
def test_byz_config_checks_equal_jax(peers, byz, rule, buffer):
    from bcfl_tpu import config as jconfig
    from bcfl_tpu.reputation import ReputationConfig as JRep
    from bcfl_tpu_torch import config as tconfig
    from bcfl_tpu_torch.reputation import ReputationConfig

    out = []
    for mod, plan, rep in ((tconfig, FaultPlan, ReputationConfig),
                           (jconfig, JPlan, JRep)):
        try:
            cfg = mod.FedConfig(
                runtime="dist", sync="async", eval_every=0,
                num_clients=2 * peers, aggregator=rule,
                reputation=rep(enabled=True),
                faults=plan(byz_peers=byz),
                dist=mod.DistConfig(peers=peers, buffer=buffer,
                                    checkpoint_every_versions=0))
            out.append((cfg.faults.byz_enabled, cfg.reputation.enabled))
        except ValueError as e:
            out.append(str(e))
    assert out[0] == out[1]


# ------------------------------------------------- the injection seam


@pytest.mark.parametrize("behavior", [b for b in BYZ_BEHAVIORS
                                      if b != "replay"])
@pytest.mark.parametrize("dst", [0, 2])
def test_each_behavior_mutates_jax_bytes(behavior, dst):
    j, t, _ = _pair(dict(seed=11, byz_peers=(1,), byz_behaviors=(behavior,),
                         byz_scale=10.0))
    jh, jt, jact = j.corrupt_update(_header(), _np_tree(), dst=dst)
    th, tt, tact = t.corrupt_update(_header(), _torch(_np_tree()), dst=dst)
    assert tact == jact and tact["behavior"] == behavior
    assert th == jh
    _assert_same_bytes(tt, jt)
    # int leaves ride along untouched; the float parts are poisoned
    assert torch.equal(tt["layer/codes"], _torch(_np_tree())["layer/codes"])
    assert not torch.equal(tt["layer/w"], _torch(_np_tree())["layer/w"])
    assert tact["reannounce"] is (behavior in ("scale", "sign_flip",
                                               "garbage"))
    assert t.stats() == j.stats()


def test_disabled_lane_returns_the_callers_objects():
    h, tree = _header(), _torch(_np_tree())
    for kw, peer, clock in ((dict(), 1, 5),
                            (dict(seed=11, byz_peers=(1,)), 0, 5),
                            (dict(seed=11, byz_peers=(1,), byz_rounds=(9,)),
                             1, 5)):
        adv = ByzantineAdversary(FaultPlan(**kw), peer,
                                 clock_fn=lambda c=clock: c)
        h2, t2, act = adv.corrupt_update(h, tree, dst=0)
        assert act is None and h2 is h and t2 is tree
        assert adv.stats()["total"] == 0


def test_replay_with_a_full_history_resends_the_recorded_update():
    j, t, clock = _pair(dict(seed=11, byz_peers=(1,),
                             byz_behaviors=("replay",),
                             byz_rounds=tuple(range(6, 20))))
    old_h, old_np = _header(), _np_tree()
    assert j.corrupt_update(old_h, old_np, dst=0)[2] is None
    th, tt, tact = t.corrupt_update(old_h, _torch(old_np), dst=0)
    assert tact is None and th is old_h  # honest round, recorded
    clock["r"] = 6
    fresh = dict(_header(), base_version=7, round=6, lineage="99" * 32)
    jh, jt, jact = j.corrupt_update(fresh, _np_tree(), dst=0)
    th, tt, tact = t.corrupt_update(fresh, _torch(_np_tree()), dst=0)
    assert tact == jact and tact["behavior"] == "replay"
    assert th == jh and th["base_version"] == 3 and th["round"] == 5
    _assert_same_bytes(tt, jt)
    _assert_same_bytes(tt, old_np)


def test_replay_with_an_empty_history_acts_honestly_then_replays():
    j, t, clock = _pair(dict(seed=11, byz_peers=(1,),
                             byz_behaviors=("replay",)))
    h0, t0 = _header(), _torch(_np_tree())
    h, tree, act = t.corrupt_update(h0, t0, dst=0)
    assert act is None and h is h0 and tree is t0
    assert j.corrupt_update(_header(), _np_tree(), dst=0)[2] is None
    assert t.stats() == j.stats() and t.stats()["total"] == 0
    clock["r"] = 6
    fresh = dict(_header(), base_version=9, round=6)
    th, tt, tact = t.corrupt_update(fresh, _torch(_np_tree()), dst=0)
    jh, jt, jact = j.corrupt_update(fresh, _np_tree(), dst=0)
    assert tact == jact and th == jh and th["base_version"] == 3
    _assert_same_bytes(tt, jt)
    assert t.stats() == j.stats() and t.stats()["injected"]["replay"] == 1
    # the corpus is bounded at REPLAY_DEPTH, as JAX's
    for r in range(7, 20):
        clock["r"] = r
        t.corrupt_update(fresh, _torch(_np_tree()), dst=0)
        j.corrupt_update(fresh, _np_tree(), dst=0)
    assert len(t._history) == len(j._history) == t.REPLAY_DEPTH


def test_equivocation_differs_per_destination():
    kw = dict(seed=11, byz_peers=(1,), byz_behaviors=("equivocate",))

    def lie(dst):
        return _pair(kw)[1].corrupt_update(_header(), _torch(_np_tree()),
                                           dst=dst)[1]

    a, b, again = lie(0), lie(2), lie(0)
    assert torch.equal(a["layer/w"], again["layer/w"])  # same lie
    assert not torch.equal(a["layer/w"], b["layer/w"])  # another one


def test_bf16_leaf_passes_through_as_in_jax():
    """JAX's ``_map_floats`` skips an ml_dtypes bfloat16 leaf
    (``np.issubdtype(bfloat16, np.floating)`` is False); the port skips a
    torch.bfloat16 leaf, returning the same object."""
    assert not np.issubdtype(ml_dtypes.bfloat16, np.floating)
    bits = (np.arange(6, dtype=np.float32) / 3).astype(ml_dtypes.bfloat16)
    jtree = {"bf": bits, "f": np.ones(2, np.float32)}
    ttree = {"bf": torch.from_numpy(bits.view(np.int16).copy()).view(
        torch.bfloat16), "f": torch.ones(2)}
    jout = j_map_floats(jtree, lambda a: a * 25.0)
    tout = _map_floats(ttree, lambda a: a * 25.0)
    assert jout["bf"] is jtree["bf"] and tout["bf"] is ttree["bf"]
    assert (tout["f"].numpy().tobytes() == np.asarray(jout["f"]).tobytes())
    # and so through the scale behavior
    t = ByzantineAdversary(FaultPlan(seed=1, byz_peers=(0,),
                                     byz_behaviors=("scale",)), 0,
                           clock_fn=lambda: 0)
    _, out, act = t.corrupt_update(_header(), ttree, dst=1)
    assert act["behavior"] == "scale" and out["bf"] is ttree["bf"]


def test_map_floats_keeps_structure_and_0d_leaves():
    tree = _torch(_np_tree())
    tree["scalar"] = torch.tensor(2.0)
    out = _map_floats(tree, lambda a: a * 2.0)
    assert out["layer/codes"] is tree["layer/codes"]
    assert out["scalar"].shape == () and float(out["scalar"]) == 4.0
    assert torch.allclose(out["nested"]["b"], torch.full((3,), 2.0))


def test_counters_and_inject_event_equal_jax(tmp_path):
    kw = dict(seed=3, byz_peers=(1,), byz_behaviors=("sign_flip", "garbage",
                                                     "digest_forge"))
    j, t, clock = _pair(kw)
    jpath, tpath = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    jtel.install(jtel.EventWriter(str(jpath), peer=1, run="x"))
    ttel.install(ttel.EventWriter(str(tpath), peer=1, run="x"))
    try:
        for r in range(6):
            clock["r"] = r
            j.corrupt_update(_header(), _np_tree(), dst=0)
            t.corrupt_update(_header(), _torch(_np_tree()), dst=0)
    finally:
        jtel.flush()
        ttel.flush()
        jtel.uninstall()
        ttel.uninstall()
    assert t.stats() == j.stats() and t.stats()["total"] == 6

    def injects(path):
        keep = ("ev", "behavior", "round", "dst", "reannounce")
        return [{k: e.get(k) for k in keep}
                for e in map(json.loads, open(path))
                if e.get("ev") == "byz.inject"]

    assert injects(tpath) == injects(jpath) and len(injects(tpath)) == 6


def test_history_holds_deep_copies():
    t = ByzantineAdversary(FaultPlan(seed=11, byz_peers=(1,),
                                     byz_behaviors=("replay",)), 1,
                           clock_fn=lambda: 5)
    h, tree = _header(), _torch(_np_tree())
    keep = copy.deepcopy(tree)
    t.corrupt_update(h, tree, dst=0)
    tree["layer/w"].mul_(0.0)
    h["round"] = 99
    old_h, old_t = t._history[0]
    assert old_h["round"] == 5 and torch.equal(old_t["layer/w"],
                                               keep["layer/w"])


@pytest.mark.parametrize("scale,blind", [(1e-5, True), (1e-4, True),
                                         (0.02, False)])
def test_forged_codec_scales_and_the_fingerprint_as_jax(scale, blind):
    """``digest_forge`` under ``int8+topk``: a 25x forgery of the codec's
    per-chunk scales is invisible to the ledger fingerprint, in both
    packages, when the deltas are of fine-tuning size (the int8 codes and
    the top-k indices dominate the float32 folds), and seen at larger
    deltas. Such a forgery reaches the tracker only as a robust-merge
    outlier; a fix would belong to both packages."""
    import jax
    from test_torch_ledger import _payloads, _stacked_tiny_bert

    from bcfl_tpu.ledger import fingerprint as jfp
    from bcfl_tpu_torch.ledger import fingerprint as tfp

    tree_j, tree_t = _stacked_tiny_bert(scale=scale)
    pj, pt = _payloads(tree_j, tree_t)
    pj = jax.tree.map(np.asarray, pj)

    def forge(a):
        return (a * 25.0).astype(a.dtype)

    same_j = (np.asarray(jfp.client_fingerprint(pj))
              == np.asarray(jfp.client_fingerprint(j_map_floats(pj, forge))))
    same_t = (tfp.client_fingerprint(pt).numpy()
              == tfp.client_fingerprint(_map_floats(pt, forge)).numpy())
    assert bool(same_j.all()) is blind and bool(same_t.all()) is blind


# -------------------------------------------------- loopback integration


def byz_cfg(**dist_kw):
    """JAX's 3-peer loopback settings (``test_dist_byzantine.py``), in the
    port's config, with the hash vocab cut to 512 (CPU time)."""
    from bcfl_tpu_torch import config as tconfig
    from bcfl_tpu_torch.reputation import ReputationConfig

    dist = dict(peers=3, buffer=3, buffer_timeout_s=8.0,
                idle_timeout_s=90.0, peer_deadline_s=280.0,
                checkpoint_every_versions=1)
    dist.update(dist_kw)
    return tconfig.FedConfig(
        name="byz_loopback", runtime="dist", mode="server", sync="async",
        model="tiny-bert", dataset="synthetic", vocab_size=512,
        num_clients=6, num_rounds=5, seq_len=16, batch_size=4,
        max_local_batches=2, eval_every=0, seed=42,
        partition=tconfig.PartitionConfig(kind="iid", iid_samples=8),
        ledger=tconfig.LedgerConfig(enabled=True),
        aggregator="trimmed_mean",
        reputation=ReputationConfig(enabled=True, quarantine_rounds=1000),
        faults=FaultPlan(seed=7, byz_peers=(2,), byz_prob=1.0,
                         byz_behaviors=("scale", "digest_forge")),
        dist=tconfig.DistConfig(**dist))


def check_byz_run(res, adversary=2, peers=3):
    """Every assertion of JAX's loopback test; returns the collation."""
    from bcfl_tpu_torch.telemetry import collate

    assert res["ok"], (res["returncodes"], res["log_tails"])
    reports = res["reports"]
    assert len(reports) == peers
    leader = reports[0]
    rep = leader["reputation"]
    assert rep["state"][adversary] == "quarantined", rep
    assert rep["quarantine_drops"] > 0
    for p in range(1, peers):
        assert reports[p]["reputation"]["state"][adversary] == "quarantined"
    assert reports[adversary]["byzantine"]["armed"]
    assert reports[adversary]["byzantine"]["total"] > 0
    for p in range(peers):
        if p != adversary:
            assert reports[p]["byzantine"]["total"] == 0
    rules = {(m.get("robust") or {}).get("rule")
             for r in reports.values() for m in r["merges"]}
    assert "trimmed_mean" in rules
    col = collate(res["event_streams"])
    assert col["ok"], col["violations"]
    assert col["invariants"]["no_quarantined_merge"] == 0
    assert all(r.get("chain_ok") in (True, None) for r in reports.values())
    return col


def test_three_peer_loopback_quarantines_seeded_adversary(tmp_path):
    from bcfl_tpu_torch.dist import run_dist

    # a 30 s buffer timeout: with JAX's 8 s a loaded host merged a version
    # without the adversary's update, and its evidence fell short of the
    # quarantine (the trust state stayed "suspect")
    cfg = byz_cfg(resource_sample_s=1.0, buffer_timeout_s=30.0)
    res = run_dist(cfg, str(tmp_path / "byz"), deadline_s=320.0,
                   device="cpu", threads=2)
    col = check_byz_run(res)
    evs = col["ordered"]
    for p in range(3):
        mine = [e for e in evs if e.get("peer") == p]
        res_ev = [e for e in mine if e["ev"] == "resource"]
        assert res_ev, p
        for e in res_ev:
            assert {"rss_gb", "cpu_percent", "interval_s", "disk_free_bytes",
                    "disk_free_gb"} <= set(e), e
            assert e["interval_s"] == 1.0 and e["rss_gb"] > 0
        phi = [e for e in mine if e["ev"] == "detector.phi"]
        assert phi and all({"target", "phi", "state"} <= set(e)
                           for e in phi), p
    # the adversary's injections are in its stream, with JAX's fields
    inj = [e for e in evs if e["ev"] == "byz.inject"]
    assert inj and {e["peer"] for e in inj} == {2}
    assert {e["behavior"] for e in inj} <= {"scale", "digest_forge"}
    # the evidence that quarantined it is the non-slowness kind
    ev = [e for e in evs if e["ev"] == "rep.dist_evidence"
          and e.get("target") == 2]
    assert {e["source"] for e in ev} & {"ledger_auth", "robust_outlier"}


# ------------------------------------------------------------------- CLI


BAD_BYZ_FLAGS = [
    ["--chaos-byz", "1,x"],
    ["--chaos-byz", "1", "--chaos-byz-rounds", "4"],
    ["--chaos-byz", "1", "--chaos-byz-rounds", "3:3"],
    ["--chaos-byz-prob", "0.5"],
]


@pytest.mark.parametrize("flags", BAD_BYZ_FLAGS,
                         ids=[str(i) for i in range(len(BAD_BYZ_FLAGS))])
def test_cli_refuses_byz_flags_as_jax(flags):
    from bcfl_tpu.entrypoints.__main__ import main as jmain
    from bcfl_tpu_torch.entrypoints.__main__ import main as tmain

    msgs = []
    for main in (tmain, jmain):
        with pytest.raises(SystemExit) as e:
            main(["--preset", "smoke"] + flags)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_cli_parses_byz_flags_as_jax():
    from bcfl_tpu_torch.entrypoints.__main__ import build_config, build_parser

    cfg = build_config(build_parser().parse_args([
        "--runtime", "dist", "--peers", "3", "--clients", "6",
        "--dist-buffer", "3", "--aggregator", "trimmed_mean", "--ledger",
        "--reputation", "--reputation-quarantine-rounds", "1000",
        "--chaos-byz", "2", "--chaos-byz-behaviors", "scale, digest_forge",
        "--chaos-byz-prob", "0.5", "--chaos-byz-scale", "10",
        "--chaos-byz-rounds", "1:4", "--chaos-seed", "7"]))
    assert cfg.faults == FaultPlan(
        seed=7, byz_peers=(2,), byz_behaviors=("scale", "digest_forge"),
        byz_prob=0.5, byz_scale=10.0, byz_rounds=(1, 2, 3))
    assert cfg.runtime == "dist" and cfg.aggregator == "trimmed_mean"
    assert cfg.reputation.enabled and cfg.reputation.quarantine_rounds == 1000
