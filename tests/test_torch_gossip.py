"""The port's gossip dispatch (``bcfl_tpu_torch/dist/gossip.py``) against
the JAX package's: the neighbor, hello and probe draws bit for bit;
``state_digest`` over torch leaves equal to JAX's over the same numpy
arrays (numpy's dtype and shape spellings, flat keys hashing as nested
paths); ``merge_states`` bit-identical to JAX's on float32 leaves and
commutative bitwise, the union version vector and weights, the
all-eliminated and non-float cases, and the bfloat16 leaf riding the first
item as JAX's ``np.floating`` test makes it; ``RejoinGrace``; the config
rows; the runtime's hooks on stand-ins; and JAX's two loopback runs,
3 real peer processes each (``tests/test_gossip.py::
test_gossip_loopback_three_peers`` and
``test_gossip_partition_heal_loopback``), held to every assertion JAX
makes there."""

import itertools

import ml_dtypes
import numpy as np
import pytest
import torch

from bcfl_tpu.dist import gossip as jg
from bcfl_tpu_torch.dist import gossip as tg

pytestmark = pytest.mark.dist


# ------------------------------------------------------------ the draws


@pytest.mark.parametrize("topology", ["epidemic", "ring"])
def test_sample_neighbors_equal_jax(topology):
    views = [(0, 1, 2), (0, 1, 2, 3, 4), (1, 3, 4), (2,), (0, 2, 4, 5, 7)]
    for seed in (0, 42):
        for rnd in range(6):
            for peer in range(6):
                for live in views:
                    for fanout in (1, 2, 3):
                        for lane in (tg.GOSSIP_LANE, tg.HELLO_LANE):
                            assert tg.sample_neighbors(
                                seed, rnd, peer, live, fanout, topology,
                                lane=lane) == jg.sample_neighbors(
                                seed, rnd, peer, live, fanout, topology,
                                lane=lane)
    assert (tg.GOSSIP_LANE, tg.HELLO_LANE, tg.HEDGE_LANE, tg.PROBE_LANE) \
        == (jg.GOSSIP_LANE, jg.HELLO_LANE, jg.HEDGE_LANE, jg.PROBE_LANE)


def test_sample_neighbors_replayable_and_self_excluding():
    live = (0, 1, 2, 3, 4)
    a = tg.sample_neighbors(7, 3, 2, live, 2)
    assert a == tg.sample_neighbors(7, 3, 2, live, 2)
    assert len(a) == 2 and 2 not in a and set(a) <= set(live)
    assert tg.sample_neighbors(7, 3, 2, (2,), 2) == ()
    assert tg.sample_neighbors(7, 3, 2, live, 2, "ring") == (3, 4)


def test_probe_targets_equal_jax():
    for seed in (0, 5):
        for seq in range(8):
            for peer in range(5):
                for dormant in ((), (1,), (0, 3, 4), (peer,), (1, 2, 3, 4)):
                    for k in (1, 2):
                        assert tg.probe_targets(seed, seq, peer, dormant,
                                                k) == jg.probe_targets(
                            seed, seq, peer, dormant, k)


# -------------------------------------------------------------- digest


def _np_tree(seed):
    rng = np.random.default_rng(seed)
    return {"enc": {"w": rng.normal(size=(768,)).astype(np.float32),
                    "k": rng.normal(size=(3, 4)).astype(np.float32)},
            "ids": rng.integers(0, 9, (5,)).astype(np.int32),
            "s": np.float32(1.5),
            "d": rng.normal(size=(2, 2)).astype(np.float64)}


def _flat_torch(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat_torch(v, path + "/"))
        else:
            out[path] = torch.from_numpy(np.array(v))
    return out


def test_state_digest_equals_jax():
    for seed in range(3):
        j = _np_tree(seed)
        t = _flat_torch(j)
        # flat "enc/w" keys hash as JAX's nested {"enc": {"w":}} paths,
        # and a 0-d leaf spells "()"
        assert tg.state_digest(t) == jg.state_digest(j)
        assert tg.state_digest(j) == jg.state_digest(j)
    # a bf16 leaf hashes as ml_dtypes' bfloat16 array
    x = np.random.default_rng(4).normal(size=(6,)).astype(np.float32)
    jb = {"b": x.astype(ml_dtypes.bfloat16)}
    tb = {"b": torch.from_numpy(x).to(torch.bfloat16)}
    assert tg.state_digest(tb) == jg.state_digest(jb)


def test_state_digest_order_independent_value_sensitive():
    a = {"x": torch.ones(2), "y": torch.zeros(3, dtype=torch.int32)}
    b = {"y": torch.zeros(3, dtype=torch.int32), "x": torch.ones(2)}
    assert tg.state_digest(a) == tg.state_digest(b)
    c = {"x": torch.ones(2), "y": torch.tensor([0, 0, 1], dtype=torch.int32)}
    assert tg.state_digest(a) != tg.state_digest(c)
    d = {"x": torch.ones(2, dtype=torch.float64),
         "y": torch.zeros(3, dtype=torch.int32)}
    assert tg.state_digest(a) != tg.state_digest(d)


# ------------------------------------------------------------- the merge


def _state(seed, n=257):
    rng = np.random.default_rng(seed)
    return {"layer/w": rng.normal(size=(n,)).astype(np.float32),
            "layer/b": rng.normal(size=(7, 3)).astype(np.float32),
            "ids": np.arange(4, dtype=np.int32) + seed}


def _items(n_items=3):
    vvs = [[3, 1, 0], [2, 2, 0], [1, 1, 2], [0, 4, 1]]
    masses = [2.0, 1.0, 1.5, 3.0]
    trusts = [1.0, 0.8, 1.0, 0.5]
    orders = [(1, 0), (1, 0), (2, 5), (0, 3)]
    out = []
    for i in range(n_items):
        out.append({"peer": i, "order": orders[i], "state": _state(i),
                    "vv": np.asarray(vvs[i], np.int64), "mass": masses[i],
                    "trust": trusts[i]})
    return out


def _torch_items(items):
    return [dict(it, state={k: torch.from_numpy(np.array(v))
                            for k, v in it["state"].items()})
            for it in items]


@pytest.mark.parametrize("n_items", [2, 3, 4])
def test_merge_states_bit_identical_to_jax(n_items):
    items = _items(n_items)
    j_state, j_vv, j_w = jg.merge_states(items, decay=0.9)
    t_state, t_vv, t_w = tg.merge_states(_torch_items(items), decay=0.9)
    np.testing.assert_array_equal(t_vv, j_vv)
    assert t_w == j_w
    for k, v in j_state.items():
        got = t_state[k].numpy()
        assert got.dtype == np.asarray(v).dtype, k
        assert got.tobytes() == np.asarray(v).tobytes(), k
    assert tg.state_digest(t_state) == jg.state_digest(
        {k: np.asarray(v) for k, v in j_state.items()})


def test_merge_states_bitwise_commutative():
    items = _torch_items(_items(3))
    ref, ref_vv, ref_w = tg.merge_states(list(items), decay=0.9)
    for perm in itertools.permutations(items):
        st, vv, w = tg.merge_states(list(perm), decay=0.9)
        np.testing.assert_array_equal(vv, ref_vv)
        assert w == ref_w
        for k in ref:
            assert st[k].numpy().tobytes() == ref[k].numpy().tobytes(), k


def test_merge_states_union_vv_and_staleness_decay():
    fresh = {"peer": 0, "order": (1, 0), "state": {"x": torch.ones(1)},
             "vv": np.asarray([4, 0]), "mass": 1.0}
    stale = {"peer": 1, "order": (1, 0), "state": {"x": torch.zeros(1)},
             "vv": np.asarray([1, 1]), "mass": 1.0}
    _, union, w = tg.merge_states([fresh, stale], decay=0.5)
    np.testing.assert_array_equal(union, [4, 1])
    assert w == [0.5, 0.125]
    _, _, w1 = tg.merge_states([fresh, stale], decay=1.0)
    assert w1 == [1.0, 1.0]


def test_merge_states_all_eliminated_keeps_first_canonical():
    a = {"peer": 1, "order": (1, 0), "state": {"x": torch.tensor([7.0])},
         "vv": np.asarray([1, 0]), "mass": 1.0, "trust": 0.0}
    b = {"peer": 0, "order": (1, 0), "state": {"x": torch.tensor([9.0])},
         "vv": np.asarray([0, 1]), "mass": 1.0, "trust": 0.0}
    st, union, w = tg.merge_states([a, b], decay=0.9)
    assert st["x"].tolist() == [9.0]
    np.testing.assert_array_equal(union, [1, 1])
    assert w == [0.0, 0.0]


def test_merge_states_non_float_and_bf16_leaves_ride_the_first_item():
    """JAX reduces only ``np.floating`` leaves, and ml_dtypes' bfloat16 is
    none: a bf16 leaf rides the first canonical item unmerged, in both
    packages (a fix belongs in both)."""
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(5,)).astype(np.float32) for _ in range(2)]
    j_items = [{"peer": p, "order": (1, 0), "vv": np.asarray([1, 1]),
                "mass": 1.0,
                "state": {"ids": np.array([p, 8], np.int32),
                          "b": xs[p].astype(ml_dtypes.bfloat16),
                          "h": xs[p].astype(np.float16)}}
               for p in (1, 0)]
    t_items = [dict(it, state={"ids": torch.from_numpy(it["state"]["ids"]),
                               "b": torch.from_numpy(xs[it["peer"]]).to(
                                   torch.bfloat16),
                               "h": torch.from_numpy(it["state"]["h"])})
               for it in j_items]
    j_st, _, _ = jg.merge_states(j_items, decay=0.9)
    t_st, _, _ = tg.merge_states(t_items, decay=0.9)
    assert t_st["ids"].tolist() == [0, 8] == np.asarray(j_st["ids"]).tolist()
    # bf16 unmerged: peer 0's leaf verbatim, in both
    assert torch.equal(t_st["b"], t_items[1]["state"]["b"])
    assert (t_st["b"].view(torch.int16).numpy().tobytes()
            == np.asarray(j_st["b"]).tobytes())
    # float16 is np.floating: merged in float32, cast back, bit for bit
    assert t_st["h"].dtype == torch.float16
    assert t_st["h"].numpy().tobytes() == np.asarray(j_st["h"]).tobytes()
    assert not torch.equal(t_st["h"], t_items[1]["state"]["h"])


# --------------------------------------------------------------- grace


def test_rejoin_grace_lifecycle():
    for g in (tg.RejoinGrace(), jg.RejoinGrace()):
        assert not g.active(2) and g.report() == []
        g.note_rejoin(2)
        g.note_rejoin(0)
        assert g.active(2) and g.active(0) and not g.active(1)
        assert g.report() == [0, 2]
        g.note_caught_up(2)
        assert not g.active(2) and g.report() == [0]
        g.note_caught_up(2)
        assert g.report() == [0]


# -------------------------------------------------------------- config


GOSSIP_CFGS = [
    dict(dist=dict(peers=3, gossip_fanout=3)),
    dict(dist=dict(peers=4, gossip_fanout=0)),
    dict(dist=dict(peers=4, gossip_topology="star")),
    dict(dist=dict(peers=4, gossip_hello_interval_s=0.0)),
    dict(dist=dict(peers=4, gossip_fanout=1), aggregator="median"),
    dict(dist=dict(peers=4, gossip_fanout=2), aggregator="trimmed_mean"),
    dict(dist=dict(peers=4), aggregator="krum"),
    dict(dist=dict(peers=4), compress="int8"),
    dict(dist=dict(peers=4), partition=True),
    dict(dist=dict(peers=4, gossip_topology="ring")),
]


@pytest.mark.parametrize("case", GOSSIP_CFGS,
                         ids=[str(i) for i in range(len(GOSSIP_CFGS))])
def test_gossip_configs_construct_or_refuse_as_jax(case):
    from bcfl_tpu import config as jconfig
    from bcfl_tpu.compression import CompressionConfig as JComp
    from bcfl_tpu.faults import FaultPlan as JPlan
    from bcfl_tpu_torch import config as tconfig
    from bcfl_tpu_torch.compression import CompressionConfig
    from bcfl_tpu_torch.faults import FaultPlan

    out = []
    for mod, comp, plan in ((tconfig, CompressionConfig, FaultPlan),
                            (jconfig, JComp, JPlan)):
        kw = dict(runtime="dist", mode="server", sync="async", eval_every=0,
                  num_clients=8, aggregator=case.get("aggregator", "mean"),
                  compression=comp(kind=case.get("compress", "none")))
        if case.get("partition"):
            kw["faults"] = plan(partition_groups=((0, 1),),
                                partition_rounds=(1, 2))
        try:
            cfg = mod.FedConfig(**kw, dist=mod.DistConfig(
                dispatch="gossip", checkpoint_every_versions=0,
                **case["dist"]))
            out.append(("ok", cfg.dist.dispatch, cfg.dist.gossip_fanout))
        except ValueError as e:
            out.append(("err", str(e)))
    assert out[0] == out[1]


# ---------------------------------------------------- hooks on stand-ins


def _standin(peers=3, peer_id=1):
    rt = tg.GossipPeerRuntime.__new__(tg.GossipPeerRuntime)
    rt.peers, rt.peer_id = peers, peer_id
    rt.vv = np.asarray([2, 5, 1], np.int64)
    return rt


def test_hooks_ship_and_absorb_the_version_vector():
    rt = _standin()
    out = {}
    rt._sync_serve_extra(out)
    assert out == {"vv": [2, 5, 1]}
    model = {"w": torch.ones(2)}
    rt._adopt_extra({"vv": [4, 0, 1]}, {"model": model})
    assert rt.vv.tolist() == [4, 5, 1] and rt._state_np is model
    rt._adopt_extra({"vv": [9, 9]}, {"model": model})  # wrong length
    assert rt.vv.tolist() == [4, 5, 1]


def test_report_extra_before_and_after_init():
    bare = tg.GossipPeerRuntime.__new__(tg.GossipPeerRuntime)
    rep = bare._report_extra()
    assert rep["dispatch"] == "gossip" and rep["vv"] is None
    assert rep["gossip"]["exchanges"] == 0
    rt = _standin()
    rt._exchanges, rt._auth_rejects, rt._chain_merges = 4, 1, 2
    rt._peers_done = {2}
    rt._grace = tg.RejoinGrace()
    rt._grace.note_rejoin(0)
    rt.fork = {"component": [0, 1]}
    from bcfl_tpu_torch.dist.membership import MembershipView

    rt.membership = MembershipView(3, 1)
    rep = rt._report_extra()
    assert rep["vv"] == [2, 5, 1]
    assert rep["gossip"] == {"exchanges": 4, "auth_rejects": 1,
                             "chain_merges": 2, "peers_done": [2],
                             "rejoin_graced": [0],
                             "fork": {"component": [0, 1]}}
    assert rep["membership"] == rt.membership.report()


def test_checkpoint_and_restore_carry_the_vv():
    rt = _standin()
    rt.rep = None
    state = rt._checkpoint_extra()
    assert state["gossip_vv"].tolist() == [2, 5, 1]
    fresh = tg.GossipPeerRuntime.__new__(tg.GossipPeerRuntime)
    fresh.rep = None
    fresh._gossip_restored_vv = None
    fresh._restore_extra({"gossip_vv": torch.as_tensor(state["gossip_vv"])})
    assert fresh._gossip_restored_vv.tolist() == [2, 5, 1]


# ------------------------------------------------- loopback (3 peers)


def _gossip_cfg(**kw):
    from bcfl_tpu_torch import config as tconfig

    base = dict(
        name="gossip_loopback", runtime="dist", mode="server", sync="async",
        model="tiny-bert", dataset="synthetic", vocab_size=512,
        num_clients=6, num_rounds=3, seq_len=16, batch_size=4,
        max_local_batches=2, eval_every=0, seed=42,
        partition=tconfig.PartitionConfig(kind="iid", iid_samples=8),
        ledger=tconfig.LedgerConfig(enabled=True),
        dist=tconfig.DistConfig(peers=3, dispatch="gossip", gossip_fanout=2,
                                buffer_timeout_s=10.0, idle_timeout_s=90.0,
                                peer_deadline_s=150.0, suspect_after=2))
    base.update(kw)
    return tconfig.FedConfig(**base)


def test_gossip_loopback_three_peers(tmp_path):
    """One real leaderless run: 3 peer processes, epidemic fan-out 2,
    clean lanes. Every peer carries its own version clock to the horizon,
    reports dispatch 'gossip' with a verifying chain, and the collated
    streams pass every invariant with gossip.merge events present."""
    from bcfl_tpu_torch.dist import run_dist
    from bcfl_tpu_torch.telemetry import collate, read_stream

    cfg = _gossip_cfg()
    result = run_dist(cfg, str(tmp_path / "gossip_run"), deadline_s=170.0,
                      device="cpu", threads=1)
    assert result["ok"], (result["returncodes"], result["log_tails"])
    assert result["process_count"] == 3
    for p in range(3):
        rep = result["reports"][p]
        assert rep["status"] == "ok"
        assert rep["dispatch"] == "gossip"
        assert rep["final_version"] >= cfg.num_rounds, (p, rep)
        assert rep["chain_ok"] in (True, None)
        vv = rep.get("vv")
        assert vv and len(vv) == 3 and vv[p] >= cfg.num_rounds
    col = collate(result["event_streams"])
    assert col["ok"], col["violations"]
    gmerges = exchanges = 0
    for path in result["event_streams"]:
        evs, _ = read_stream(path)
        gmerges += sum(1 for e in evs if e["ev"] == "gossip.merge")
        exchanges += sum(1 for e in evs if e["ev"] == "gossip.exchange")
        assert not any(e["ev"] == "merge" for e in evs)
    assert gmerges >= 3 * cfg.num_rounds
    assert exchanges >= 3 * cfg.num_rounds


def test_gossip_partition_heal_loopback(tmp_path):
    """Split-brain survival end to end: 3 real gossip peers, a seeded
    (0,1)|(2,) cut over local rounds [1, 3), reputation and trimmed_mean
    armed. Every peer reaches its own horizon, the invariants (the
    leaderless heal and the gossip scope of no_cross_partition_merge
    included) pass, each peer records its own seeded component and a
    leaderless fork.begin/fork.heal pair, the minority peer degrades to
    the mean with a vote-floor event, and no peer is quarantined."""
    from bcfl_tpu_torch.dist import run_dist
    from bcfl_tpu_torch.faults import FaultPlan
    from bcfl_tpu_torch.reputation import ReputationConfig
    from bcfl_tpu_torch.telemetry import collate, read_stream

    cfg = _gossip_cfg(name="gossip_heal", num_rounds=4,
                      aggregator="trimmed_mean",
                      reputation=ReputationConfig(enabled=True),
                      faults=FaultPlan(partition_groups=((0, 1), (2,)),
                                       partition_rounds=(1, 2)))
    result = run_dist(cfg, str(tmp_path / "gossip_heal_run"),
                      deadline_s=170.0, device="cpu", threads=1)
    assert result["ok"], (result["returncodes"], result["log_tails"])
    for p in range(3):
        rep = result["reports"][p]
        assert rep["status"] == "ok"
        assert rep["final_version"] >= cfg.num_rounds, (p, rep)
        assert rep["chain_ok"] in (True, None)
        fork = rep["gossip"]["fork"]
        assert fork is not None, (p, rep["gossip"])
        assert fork["component"] == ([0, 1] if p in (0, 1) else [2])
    col = collate(result["event_streams"])
    assert col["ok"], col["violations"]
    assert col["invariants"]["partition_heals_leaderless"] == 0
    assert col["invariants"]["no_cross_partition_merge"] == 0
    forks = heals = floors = quarantines = 0
    for path in result["event_streams"]:
        for e in read_stream(path)[0]:
            if e["ev"] == "fork.begin":
                assert e.get("leaderless") is True, e
                forks += 1
            elif e["ev"] == "fork.heal":
                assert e.get("leaderless") is True, e
                heals += 1
            elif e["ev"] == "gossip.vote_floor":
                assert e["votes"] < e["need"]
                floors += 1
            elif (e["ev"] == "rep.transition"
                  and e.get("to") == "quarantined"):
                quarantines += 1
    assert forks >= 3 and heals >= 3, (forks, heals)
    assert floors >= 1
    assert quarantines == 0
