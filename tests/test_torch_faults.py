"""PyTorch port (``bcfl_tpu_torch``): the fault plan, the reputation
tracker, the robust aggregators, the partitioned anomaly filter and the
payload corruption against the JAX package, function by function.

- ``FaultPlan``: every draw (``dropout_keep``, ``straggler_delays``,
  ``transport_scales``, ``partition_components``, ``churn_alive``,
  ``flaky_set``, ``flaky_scales``, ``should_crash``) and the
  ``FaultInjector``'s summed scales equal the JAX package's bit for bit
  over a grid of seeds, rounds and client counts; the validation errors are
  the same messages.
- ``ReputationTracker``: the same evidence stream gives identical trust,
  states, timers and counters at every round, bit for bit.
- ``masked_median`` bit for bit, ``masked_trimmed_mean`` at rtol 1e-6 (the
  float32 sum's order), ``masked_krum`` the same selection on
  well-separated clients and then bit for bit, against ``gspmd.masked_*``
  on random stacked trees with masks (all masked, k = 1, k = 2, odd and
  even k, float32 and bfloat16 leaves).
- ``partitioned_anomaly_filter`` and ``corrupt_payload`` bit for bit.
- ``FedConfig``'s rules on the aggregator, the trim and the fault plan
  raise the JAX package's messages.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bcfl_tpu.compression import codecs as jcc
from bcfl_tpu.faults import plan as jplan
from bcfl_tpu.parallel import gspmd
from bcfl_tpu.reputation import lifecycle as jrep
from bcfl_tpu.topology import filters as jfilt
from bcfl_tpu.topology import graph as jgraph
from bcfl_tpu_torch import parallel as tpar
from bcfl_tpu_torch.compression import codecs as tcc
from bcfl_tpu_torch.faults import plan as tplan
from bcfl_tpu_torch.reputation import lifecycle as trep
from bcfl_tpu_torch.topology import filters as tfilt
from bcfl_tpu_torch.topology import graph as tgraph

# ------------------------------------------------------------- fault plan

PLANS = [
    dict(dropout_prob=0.3),
    dict(dropout_prob=0.5, dropout_rounds=(1, 3)),
    dict(straggler_prob=0.4, straggler_delay_s=12.5),
    dict(straggler_prob=1.0, straggler_rounds=(2,)),
    dict(corrupt_prob=0.35, corrupt_scale=-3.0),
    dict(corrupt_prob=0.5, corrupt_rounds=(0, 4)),
    dict(crash_at_round=3),
    dict(partition_count=2, partition_rounds=(1, 2, 3)),
    dict(partition_count=3, partition_rounds=(0,)),
    dict(partition_groups=((0,),), partition_rounds=(2, 5)),
    dict(churn_leave=((0, 2),), churn_join=((1, 3), (2, 1))),
    dict(flaky_clients=(0,), flaky_burst_len=2, flaky_on_prob=0.7),
    dict(flaky_frac=0.5, flaky_burst_len=3, flaky_on_prob=1.0,
         flaky_scale=5.0),
    dict(corrupt_prob=0.4, flaky_frac=0.6, flaky_on_prob=0.8),
]


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", PLANS, ids=[",".join(k) for k in PLANS])
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_fault_plan_draws_match_jax_bit_for_bit(kw, seed):
    jp, tp = jplan.FaultPlan(seed=seed, **kw), tplan.FaultPlan(seed=seed, **kw)
    assert tp.enabled == jp.enabled and tp.corrupts == jp.corrupts
    assert tp.partitions == jp.partitions and tp.churns == jp.churns
    for C in (3, 4, 10):
        _same(tp.flaky_set(C), jp.flaky_set(C))
        try:
            ji = jplan.FaultInjector(jp, C)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                tplan.FaultInjector(tp, C)
            assert str(got.value) == str(e)
            continue
        ti = tplan.FaultInjector(tp, C)
        for rnd in range(8):
            _same(tp.dropout_keep(rnd, C), jp.dropout_keep(rnd, C))
            _same(tp.straggler_delays(rnd, C), jp.straggler_delays(rnd, C))
            _same(tp.transport_scales(rnd, C), jp.transport_scales(rnd, C))
            _same(tp.churn_alive(rnd, C), jp.churn_alive(rnd, C))
            _same(tp.flaky_scales(rnd, C), jp.flaky_scales(rnd, C))
            _same(ti.transport_scales(rnd), ji.transport_scales(rnd))
            assert (tp.partition_components(rnd, C)
                    == jp.partition_components(rnd, C))
            assert tp.should_crash(rnd) == jp.should_crash(rnd)


BAD_PLANS = [
    dict(dropout_prob=1.5), dict(straggler_prob=-0.1),
    dict(straggler_delay_s=-1.0), dict(corrupt_scale=float("inf")),
    dict(dropout_rounds=[1, 2]), dict(crash_at_round=-1),
    dict(partition_groups=[(0, 1)], partition_rounds=(0,)),
    dict(partition_groups=(), partition_rounds=(0,)),
    dict(partition_groups=((0, 1), (1, 2)), partition_rounds=(0,)),
    dict(partition_count=1), dict(partition_count=2),
    dict(partition_count=2, partition_groups=((0,),), partition_rounds=(0,)),
    dict(partition_count=2, partition_rounds=()),
    dict(partition_rounds=(1,)), dict(partition_count=2,
                                      partition_rounds=[1]),
    dict(churn_leave=((0, -1),)), dict(churn_join=((1, 2), (1, 3))),
    dict(churn_leave=((0, 2),), churn_join=((0, 3),)),
    dict(flaky_clients=[1]), dict(flaky_frac=2.0), dict(flaky_on_prob=-1.0),
    dict(flaky_burst_len=0), dict(flaky_scale=float("nan")),
]


@pytest.mark.parametrize("kw", BAD_PLANS, ids=[str(i) for i in
                                               range(len(BAD_PLANS))])
def test_fault_plan_validation_errors_match_jax(kw):
    with pytest.raises(ValueError) as want:
        jplan.FaultPlan(**kw)
    with pytest.raises(ValueError) as got:
        tplan.FaultPlan(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw,C", [
    (dict(partition_groups=((0, 5),), partition_rounds=(0,)), 4),
    (dict(partition_groups=((0, 1), (2, 3)), partition_rounds=(0,)), 4),
    (dict(partition_groups=((0, 1, 2, 3),), partition_rounds=(0,)), 4),
    (dict(partition_count=5, partition_rounds=(0,)), 4),
    (dict(churn_leave=((4, 1),)), 4),
    (dict(flaky_clients=(7,)), 4),
])
def test_fault_injector_client_checks_match_jax(kw, C):
    def outcome(mod):
        try:
            mod.FaultInjector(mod.FaultPlan(**kw), C)
        except ValueError as e:
            return str(e)
        return None

    assert outcome(tplan) == outcome(jplan)
    with pytest.raises(ValueError) as want:
        jplan.FaultInjector(jplan.FaultPlan(corrupt_prob=0.5), 4,
                            host_tamper=lambda r, t: t)
    with pytest.raises(ValueError) as got:
        tplan.FaultInjector(tplan.FaultPlan(corrupt_prob=0.5), 4,
                            host_tamper=lambda r, t: t)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------- reputation


@pytest.mark.parametrize("kw", [
    {}, dict(ewma_alpha=0.7, quarantine_rounds=1, probation_rounds=3),
    dict(suspect_below=0.9, quarantine_below=0.6, strike_threshold=0.2,
         probation_weight=0.25),
])
def test_reputation_trajectory_matches_jax_bit_for_bit(kw):
    C = 7
    rng = np.random.default_rng(5)
    jt = jrep.ReputationTracker(jrep.ReputationConfig(enabled=True, **kw), C)
    tt = trep.ReputationTracker(trep.ReputationConfig(enabled=True, **kw), C)
    levels = np.array([0.0, 0.0, 0.25, 0.5, 1.0, 1.0])
    for rnd in range(40):
        _same(tt.gate(), jt.gate())
        fault = levels[rng.integers(0, len(levels), C)]
        active = None if rnd % 3 else rng.random(C) < 0.7
        jt.observe(fault, active=active)
        tt.observe(fault, active=active)
        for a in ("trust", "state", "timer", "quarantine_events",
                  "rounds_quarantined"):
            _same(getattr(tt, a), getattr(jt, a))
        assert tt.state_names() == jt.state_names()
    assert tt.summary() == jt.summary()
    assert tt.summary()["total_quarantine_events"] > 0
    snap = tt.checkpoint_state()
    assert sorted(snap) == sorted(jt.checkpoint_state())
    fresh = trep.ReputationTracker(tt.cfg, C)
    fresh.restore({k: torch.from_numpy(v) for k, v in snap.items()})
    for a in ("trust", "state", "timer", "quarantine_events",
              "rounds_quarantined"):
        _same(getattr(fresh, a), getattr(tt, a))


@pytest.mark.parametrize("kw", [
    dict(ewma_alpha=0.0), dict(suspect_below=0.3), dict(quarantine_rounds=0),
    dict(probation_weight=0.0), dict(w_auth=1.5), dict(staleness_limit=-1),
    dict(w_slow=1.0),
])
def test_reputation_config_errors_match_jax(kw):
    with pytest.raises(ValueError) as want:
        jrep.ReputationConfig(**kw)
    with pytest.raises(ValueError) as got:
        trep.ReputationConfig(**kw)
    assert str(got.value) == str(want.value)
    assert ([f.name for f in dataclasses.fields(trep.ReputationConfig)]
            == [f.name for f in dataclasses.fields(jrep.ReputationConfig)])


# ------------------------------------------------------- robust aggregators

MASKS = {
    "all_masked": [0, 0, 0, 0, 0, 0],
    "k1": [0, 0, 3, 0, 0, 0],
    "k2": [1, 0, 0, 0, 2, 0],
    "k3": [1, 1, 0, 1, 0, 0],
    "k4": [0.5, 1, 1, 0, 1, 0],
    "k5": [1, 1, 1, 1, 0, 7],
    "all": [1, 1, 1, 1, 1, 1],
}


def _tree(rng, dtype):
    shapes = {"enc/w": (6, 5, 7), "enc/b": (6, 9), "head": (6, 3, 2, 2)}
    t = {p: rng.standard_normal(s).astype(np.float32)
         for p, s in shapes.items()}
    fb = {p: rng.standard_normal(s[1:]).astype(np.float32)
          for p, s in shapes.items()}
    tt = {p: torch.from_numpy(x).to(dtype) for p, x in t.items()}
    tf = {p: torch.from_numpy(x).to(dtype) for p, x in fb.items()}
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def j(tree):
        return {p: jnp.asarray(x.float().numpy()).astype(jd)
                for p, x in tree.items()}

    return tt, tf, j(tt), j(tf)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mask", list(MASKS.values()), ids=list(MASKS))
def test_median_and_trimmed_mean_match_gspmd(mask, dtype):
    rng = np.random.default_rng(len(mask) + int(sum(mask) * 10))
    tt, tf, jt, jf = _tree(rng, dtype)
    w_t = torch.tensor(mask, dtype=torch.float32)
    w_j = jnp.asarray(mask, jnp.float32)
    for fb_t, fb_j in ((tf, jf), (None, None)):
        # without a fallback an all-masked round returns the plain mean of
        # the clients: a float32 sum in each package's order
        atol = 1e-7 if fb_t is None and not any(mask) else 0
        med_t = tpar.masked_median(tt, w_t, fallback=fb_t)
        med_j = gspmd.masked_median(jt, w_j, fallback=fb_j)
        for trim in (0.0, 0.2, 0.45):
            tm_t = tpar.masked_trimmed_mean(tt, w_t, trim, fallback=fb_t)
            tm_j = gspmd.masked_trimmed_mean(jt, w_j, trim, fallback=fb_j)
            for p in jt:
                assert tm_t[p].dtype == dtype
                np.testing.assert_allclose(_np(tm_t[p]), _np(tm_j[p]),
                                           rtol=1e-6, atol=atol, err_msg=p)
        for p in jt:
            assert med_t[p].dtype == dtype
            if atol:
                np.testing.assert_allclose(_np(med_t[p]), _np(med_j[p]),
                                           rtol=1e-6, atol=atol)
            else:
                np.testing.assert_array_equal(_np(med_t[p]), _np(med_j[p]))


def test_median_sorts_nan_last_like_jnp_sort():
    x = np.array([[1.0, np.nan, 3.0], [np.nan, 2.0, -np.inf],
                  [0.5, 0.25, np.inf], [2.0, 1.0, np.nan]], np.float32)
    w = [1.0, 1.0, 1.0, 0.0]
    got = tpar.masked_median({"x": torch.from_numpy(x)},
                             torch.tensor(w))["x"].numpy()
    want = np.asarray(gspmd.masked_median({"x": jnp.asarray(x)},
                                          jnp.asarray(w))["x"])
    np.testing.assert_array_equal(got, want)


def _separated(rng, C, scales, dtype):
    base = {"a": rng.standard_normal((5, 4)), "b": rng.standard_normal(9)}
    t = {p: np.stack([b + s * rng.standard_normal(b.shape) for s in scales])
         .astype(np.float32) for p, b in base.items()}
    tt = {p: torch.from_numpy(x).to(dtype) for p, x in t.items()}
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jt = {p: jnp.asarray(x.float().numpy()).astype(jd) for p, x in tt.items()}
    return tt, jt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mask", [
    [1, 1, 1, 1, 1, 1, 1, 1], [1, 0, 1, 1, 1, 0, 1, 1], [0, 1, 0, 0, 0, 0, 1, 0],
    [0, 0, 0, 0, 0, 1, 0, 0], [0] * 8])
def test_krum_selects_as_gspmd_then_bit_for_bit(mask, dtype):
    rng = np.random.default_rng(11)
    # clients at very different distances from a shared base: one clear
    # winner, scores far apart against float32 rounding
    scales = [0.1, 3.0, 0.01, 6.0, 9.0, 0.5, 20.0, 1.5]
    tt, jt = _separated(rng, 8, scales, dtype)
    fb = {p: torch.full(x.shape[1:], 7.0, dtype=dtype) for p, x in tt.items()}
    jfb = {p: jnp.asarray(x.float().numpy()).astype(jt[p].dtype)
           for p, x in fb.items()}
    w_t, w_j = torch.tensor(mask, dtype=torch.float32), jnp.asarray(
        mask, jnp.float32)
    for trim in (0.2, 0.4):
        got = tpar.masked_krum(tt, w_t, trim, fallback=fb)
        want = gspmd.masked_krum(jt, w_j, trim, fallback=jfb)
        for p in jt:
            assert got[p].dtype == dtype
            np.testing.assert_array_equal(_np(got[p]), _np(want[p]))
        if any(mask):
            picks = [c for c in range(8)
                     if all(torch.equal(got[p], tt[p][c]) for p in tt)]
            assert len(picks) == 1 and mask[picks[0]] > 0


def test_make_aggregator_names_and_unported_options():
    assert tpar.AGGREGATORS == gspmd.AGGREGATORS
    rng = np.random.default_rng(0)
    tt, _, jt, _ = _tree(rng, torch.float32)
    w = [1.0, 2.0, 0.0, 1.0, 1.0, 3.0]
    for name in gspmd.AGGREGATORS:
        got = tpar.make_aggregator(name, 0.2)(tt, torch.tensor(w), None)
        want = gspmd.make_aggregator(name, 0.2)(jt, jnp.asarray(w), None)
        for p in jt:
            np.testing.assert_allclose(got[p].numpy(), np.asarray(want[p]),
                                       rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="unknown aggregator"):
        tpar.make_aggregator("geomedian")
    # cohort mode's two-level mean and the rank-aware rule are ported
    # (tests/test_torch_lora.py holds them to JAX); the rank mask composes
    # with the mean only, as in JAX
    got = tpar.make_aggregator("mean", hierarchical_groups=2)(
        tt, torch.tensor(w), None)
    want = gspmd.make_aggregator("mean", hierarchical_groups=2)(
        jt, jnp.asarray(w), None)
    for p in jt:
        np.testing.assert_allclose(got[p].numpy(), np.asarray(want[p]),
                                   rtol=1e-6, atol=1e-7)
    for name in ("trimmed_mean", "median", "krum"):
        with pytest.raises(ValueError, match="defined for the mean only"):
            tpar.make_aggregator(name, rank_mask=torch.ones(4, 2))


def test_robust_rules_sort_a_wide_leaf_in_slabs(monkeypatch):
    """A leaf wider than one sort slab gives the bits of an unsliced
    sort."""
    rng = np.random.default_rng(3)
    x = {"w": torch.from_numpy(
        rng.standard_normal((5, 37, 11)).astype(np.float32))}
    w = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0])
    whole_med = tpar.masked_median(x, w)
    whole_tm = tpar.masked_trimmed_mean(x, w, 0.3)
    from bcfl_tpu_torch.parallel import collectives

    monkeypatch.setattr(collectives, "_SORT_SLAB", 5 * 13)
    assert torch.equal(tpar.masked_median(x, w)["w"], whole_med["w"])
    assert torch.equal(tpar.masked_trimmed_mean(x, w, 0.3)["w"],
                       whole_tm["w"])


# ---------------------------------------- partitioned filter and corruption


@pytest.mark.parametrize("name", sorted(jfilt.FILTERS))
@pytest.mark.parametrize("graph", ["reference", "random"])
def test_partitioned_anomaly_filter_matches_jax(name, graph):
    if graph == "reference":
        jg, tg = jgraph.reference_graph(), tgraph.reference_graph()
        comps = ((0, 2, 4, 6, 8), (1, 3, 5, 7), (9,))
    else:
        jg = jgraph.random_graph(12, 88.0, 496.0, seed=4)
        tg = tgraph.random_graph(12, 88.0, 496.0, seed=4)
        comps = ((0, 1, 2, 3, 4, 5), (6, 7, 8, 9, 10, 11))
    want = jfilt.partitioned_anomaly_filter(name, jg, comps, protect=(1,))
    got = tfilt.partitioned_anomaly_filter(name, tg, comps, protect=(1,))
    assert got["anomalies"] == want["anomalies"]
    _same(got["mask"], want["mask"])
    _same(got["scores"], want["scores"])


def test_corrupt_payload_matches_jax_bit_for_bit():
    rng = np.random.default_rng(9)
    comp = tcc.CompressionConfig(kind="int8+topk", stochastic=False)
    delta = {"a/kernel": torch.from_numpy(
        rng.standard_normal((4, 300, 7)).astype(np.float32)),
        "b/bias": torch.from_numpy(
            rng.standard_normal((4, 33)).astype(np.float32))}
    payload = tcc.encode_tree(comp, delta)
    scales = np.array([0.0, 1e6, -2.5, 0.0], np.float32)
    got = tcc.corrupt_payload(payload, torch.from_numpy(scales))
    want = jcc.corrupt_payload(
        {p: {k: jnp.asarray(v.numpy()) for k, v in parts.items()}
         for p, parts in payload.items()}, jnp.asarray(scales))
    for p, parts in want.items():
        assert sorted(got[p]) == sorted(parts)
        for k, v in parts.items():
            assert got[p][k].dtype == payload[p][k].dtype
            np.testing.assert_array_equal(got[p][k].numpy(), np.asarray(v))
    # integer parts pass through, float parts of a clean client too
    assert torch.equal(got["a/kernel"]["q"], payload["a/kernel"]["q"])
    assert torch.equal(got["a/kernel"]["s"][0], payload["a/kernel"]["s"][0])
    assert not torch.equal(got["a/kernel"]["s"][1],
                           payload["a/kernel"]["s"][1])


# -------------------------------------------------------------- config rules

PART = dict(partition_groups=((0, 1),), partition_rounds=(0,))
CONFIG_RULES = {
    "trim-range": (dict(aggregator="trimmed_mean", aggregator_trim=0.5), {}),
    "trim-negative": (dict(aggregator_trim=-0.1), {}),
    "corrupt-faithful": (dict(mode="serverless", faithful=True),
                         dict(corrupt_prob=0.5)),
    "flaky-faithful": (dict(mode="serverless", faithful=True),
                       dict(flaky_clients=(0,))),
    "partition-async": (dict(mode="serverless", sync="async"), PART),
    "partition-faithful": (dict(mode="serverless", faithful=True), PART),
    "partition-gossip": (dict(mode="serverless"), PART),
    "robust-faithful": (dict(mode="serverless", faithful=True,
                             aggregator="krum"), {}),
}


@pytest.mark.parametrize("case", list(CONFIG_RULES), ids=list(CONFIG_RULES))
def test_fault_and_aggregator_config_rules_match_jax(case):
    from bcfl_tpu.compression import CompressionConfig as JComp
    from bcfl_tpu.config import FedConfig as JCfg
    from bcfl_tpu_torch.compression import CompressionConfig as TComp
    from bcfl_tpu_torch.config import FedConfig as TCfg
    from bcfl_tpu_torch.config import TopologyConfig as TTopo

    kw, plan = CONFIG_RULES[case]
    errs = []
    for cfg, comp, mod in ((JCfg, JComp, jplan), (TCfg, TComp, tplan)):
        with pytest.raises(ValueError) as e:
            cfg(**kw, compression=comp(kind="none"),
                faults=mod.FaultPlan(**plan))
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    # the exact aggregate runs a partition in serverless mode
    TCfg(mode="serverless", faults=tplan.FaultPlan(**PART),
         topology=TTopo(gossip_steps=0))
