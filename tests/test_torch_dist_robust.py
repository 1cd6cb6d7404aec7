"""The port's robust merge over the dist arrival set
(``bcfl_tpu_torch/dist/robust.py``) against JAX's
``bcfl_tpu/dist/robust.py``: ``trim_count`` and ``krum_min_buffer`` over a
grid, ``combine_votes`` and ``robust_merge`` for each rule on seeded
float64 trees at rtol 1e-12 (a poisoned vote, zero-weight arrivals,
k < 3, every arrival eliminated, an even cohort), krum's pick identical
and its scores at rtol 1e-9 (the port sums distances from differences),
the tree structure and dtypes kept; the leader's ``_apply_robust_merge``
on stand-in runtimes against JAX's at rtol 1e-6; and the config's
robust preconditions against JAX's, message for message."""

import types

import numpy as np
import pytest
import torch

from bcfl_tpu import config as jconfig
from bcfl_tpu.dist import robust as jrb
from bcfl_tpu.dist import runtime as jrt
from bcfl_tpu_torch import config as tconfig
from bcfl_tpu_torch.compression import CompressionConfig
from bcfl_tpu_torch.dist import robust as trb
from bcfl_tpu_torch.dist import runtime as trt

pytestmark = pytest.mark.dist


def _np_votes(k, dim=6, poison=None, scale=100.0, dtype=np.float64, seed=0):
    """JAX's test votes: nested trees, one leaf 2-d, optionally a
    poisoned vote at ``poison``."""
    rng = np.random.default_rng(seed)
    votes = [{"w": (rng.standard_normal((2, dim)) * 0.01).astype(dtype),
              "b": {"x": (rng.standard_normal(3) * 0.01).astype(dtype)}}
             for _ in range(k)]
    if poison is not None:
        votes[poison] = {"w": np.full((2, dim), scale, dtype),
                         "b": {"x": np.full((3,), scale, dtype)}}
    return votes


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _leaves(tree):
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def _assert_tree_close(got, want, rtol):
    assert set(got) == set(want)
    for g, w in zip(_leaves(got), _leaves(want)):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=0)


@pytest.mark.parametrize("k", range(1, 12))
@pytest.mark.parametrize("trim", [0.0, 0.1, 0.2, 0.3, 0.45])
def test_trim_count_and_krum_min_buffer_equal_jax(k, trim):
    assert trb.trim_count(k, trim) == jrb.trim_count(k, trim)
    assert trb.krum_min_buffer(k, trim) == jrb.krum_min_buffer(k, trim)


def test_constants_equal_jax():
    assert trb.OUTLIER_MULT == jrb.OUTLIER_MULT
    assert trb.RULES == jrb.RULES
    assert trb.MIN_ORDER_VOTES == jrb.MIN_ORDER_VOTES


@pytest.mark.parametrize("weights", [[1.0], [1.0, 3.0], [0.5, 0.0, 2.0],
                                     [0.0, 0.0]])
def test_combine_votes_equals_jax(weights):
    votes = _np_votes(len(weights), seed=len(weights))
    got = trb.combine_votes([_torch(v) for v in votes], weights)
    _assert_tree_close(got, jrb.combine_votes(votes, weights), 1e-12)
    # a float32 peer vote stays float32
    v32 = _np_votes(len(weights), dtype=np.float32)
    got = trb.combine_votes([_torch(v) for v in v32], weights)
    _assert_tree_close(got, jrb.combine_votes(v32, weights), 1e-6)
    with pytest.raises(ValueError, match="at least one"):
        trb.combine_votes([], [])


# (k, poison position, weights): a poisoned vote, zero-weight arrivals,
# k < 3, an even cohort, all eliminated
CASES = [
    (5, 2, [1.0] * 5),
    (5, 0, [1.0, 2.0, 0.5, 1.0, 3.0]),
    (4, 3, [1.0, 1.0, 1.0, 0.0]),
    (6, 1, [1.0] * 6),
    (7, 4, [1.0, 0.0, 1.0, 1.0, 1.0, 2.0, 1.0]),
    (2, 1, [1.0, 1.0]),
    (3, None, [1.0, 1.0, 1.0]),
    (3, None, [0.0, 0.0, 0.0]),
]


@pytest.mark.parametrize("rule", ["trimmed_mean", "median", "krum"])
@pytest.mark.parametrize("k,poison,weights", CASES,
                         ids=[str(i) for i in range(len(CASES))])
@pytest.mark.parametrize("trim", [0.2, 0.4])
def test_robust_merge_equals_jax(rule, k, poison, weights, trim):
    votes = _np_votes(k, poison=poison, seed=k)
    want, wflags, winfo = jrb.robust_merge(votes, weights, rule, trim=trim)
    got, gflags, ginfo = trb.robust_merge([_torch(v) for v in votes],
                                          weights, rule, trim=trim)
    assert gflags == wflags
    assert set(ginfo) == set(winfo)
    for key in ("rule", "k", "trim_t", "empty", "krum_selected"):
        assert ginfo.get(key) == winfo.get(key), key
    if want is None:
        assert got is None and ginfo["empty"]
        return
    _assert_tree_close(got, want, 1e-12)
    if "krum_scores" in winfo:
        np.testing.assert_allclose(ginfo["krum_scores"],
                                   winfo["krum_scores"], rtol=1e-9)
    if "distances" in winfo:
        assert [d is None for d in ginfo["distances"]] == [
            d is None for d in winfo["distances"]]
        np.testing.assert_allclose(
            [d for d in ginfo["distances"] if d is not None],
            [d for d in winfo["distances"] if d is not None], rtol=1e-9)
    if poison is not None and k >= 3 and weights[poison] > 0:
        # the poison never lands, and it is the flagged arrival
        assert all(float(x.abs().max()) < 1.0 for x in _leaves(got))
        assert gflags[poison] and sum(gflags) == 1
        if rule == "krum":
            assert ginfo["krum_selected"] != poison


def test_robust_merge_structure_dtype_and_errors():
    votes = [_torch(v) for v in _np_votes(3, dtype=np.float32)]
    agg, _, _ = trb.robust_merge(votes, [1.0] * 3, "median")
    assert set(agg) == {"w", "b"} and set(agg["b"]) == {"x"}
    assert agg["w"].dtype == torch.float32 and agg["w"].shape == (2, 6)
    with pytest.raises(ValueError, match="unknown robust rule"):
        trb.robust_merge(votes, [1.0] * 3, "mean")
    with pytest.raises(ValueError, match="at least one"):
        trb.robust_merge([], [], "median")


def test_krum_picks_as_jax_where_jax_formula_cancels():
    """Large, nearly equal votes: the port's distances from differences
    keep the honest pairs apart where ``|a|^2 + |b|^2 - 2ab`` cancels;
    on these inputs both still pick the same vote."""
    rng = np.random.default_rng(5)
    base = rng.standard_normal(64) * 1e3
    votes = [{"w": base + rng.standard_normal(64) * (1e-2 if i != 3
                                                      else 10.0)}
             for i in range(5)]
    want = jrb.robust_merge(votes, [1.0] * 5, "krum")[2]
    got = trb.robust_merge([_torch(v) for v in votes], [1.0] * 5,
                           "krum")[2]
    assert got["krum_selected"] == want["krum_selected"] != 3


# --------------------------------------------- the leader's robust step


@pytest.mark.parametrize("rule", ["trimmed_mean", "median", "krum"])
def test_apply_robust_merge_equals_jax(rule):
    """The port's ``_apply_robust_merge`` against JAX's
    ``PeerRuntime._apply_robust_merge`` on stand-in selves: five updates
    from four peers (peer 2 sends two, peer 3 a poisoned one), the same
    deltas and alphas; the stepped global at rtol 1e-6, the flags on the
    records and the info's rule parameters equal."""
    import jax
    import jax.numpy as jnp

    from bcfl_tpu.fed.engine import FedEngine as JEngine
    from bcfl_tpu_torch.fed.engine import FedEngine

    jcfg = jconfig.FedConfig(
        runtime="dist", sync="async", model="tiny-bert",
        dataset="synthetic", num_clients=10, seq_len=16, batch_size=4,
        max_local_batches=1, eval_every=0, vocab_size=512,
        partition=jconfig.PartitionConfig(kind="iid", iid_samples=8),
        staleness_decay=0.5, async_server_lr=0.7, aggregator=rule,
        dist=jconfig.DistConfig(peers=5, buffer=5,
                                checkpoint_every_versions=0))
    jeng = JEngine(jrt._peer_engine_cfg(jcfg, 2))
    flat = jax.tree_util.tree_flatten_with_path(jeng.trainable0)[0]
    names = ["/".join(str(getattr(p, "key", p)) for p in path)
             for path, _ in flat]
    rng = np.random.default_rng(1)
    base = [np.asarray(x, np.float32) for _, x in flat]
    senders = [(0, 0), (1, 1), (2, 2), (2, 0), (3, 1)]
    updates = []
    for peer, staleness in senders:
        shift = 5.0 if peer == 3 else 1e-2
        deltas = [rng.normal(size=(2,) + b.shape).astype(np.float32) * shift
                  for b in base]
        n_ex = np.array([4.0, 6.0], np.float32)
        alpha = np.float32(0.5 ** staleness) * n_ex
        updates.append((peer, deltas, alpha, float(n_ex.sum())))

    def jtree(leaves):
        return jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jeng.trainable0),
            [jnp.asarray(x) for x in leaves])

    jself = types.SimpleNamespace(eng=jeng, cfg=jcfg, peer_id=0, rep=None,
                                  _jax=jax, trainable=jtree(base))
    jself._cast = lambda t: jrt.PeerRuntime._cast(jself, t)
    jrecs = [{"peer": p} for p, *_ in updates]
    jinfo = jrt.PeerRuntime._apply_robust_merge(jself, [
        {"deltas": jeng.mesh.shard_clients(jtree(d)), "alpha": a,
         "base_w": bw, "rec": r}
        for (_, d, a, bw), r in zip(updates, jrecs)])
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jself.trainable)]

    tcfg = tconfig.FedConfig(
        runtime="dist", sync="async", model="tiny-bert",
        dataset="synthetic", num_clients=10, seq_len=16, batch_size=4,
        max_local_batches=1, eval_every=0, vocab_size=512,
        partition=tconfig.PartitionConfig(kind="iid", iid_samples=8),
        staleness_decay=0.5, async_server_lr=0.7, aggregator=rule,
        compression=CompressionConfig(kind="none"),
        dist=tconfig.DistConfig(peers=5, buffer=5,
                                checkpoint_every_versions=0))
    teng = FedEngine(trt._peer_engine_cfg(tcfg, 2), device="cpu")
    # a runtime shell (no sockets, no threads) holding what the step reads
    tself = trt.PeerRuntime.__new__(trt.PeerRuntime)
    tself.__dict__.update(
        eng=teng, cfg=tcfg, device=torch.device("cpu"), peer_id=0, rep=None,
        trainable={n: torch.from_numpy(b.copy()) for n, b in zip(names,
                                                                 base)})
    trecs = [{"peer": p} for p, *_ in updates]
    tinfo = tself._apply_robust_merge([
        {"deltas": {n: torch.from_numpy(x) for n, x in zip(names, d)},
         "alpha": a, "base_w": bw, "rec": r}
        for (_, d, a, bw), r in zip(updates, trecs)])
    for n, w in zip(names, want):
        np.testing.assert_allclose(tself.trainable[n].numpy(), w,
                                   rtol=1e-6, atol=1e-7, err_msg=n)
    assert trecs == jrecs and trecs[4].get("outlier")
    for key in ("rule", "k", "trim_t", "krum_selected",
                "krum_selected_peer", "votes_by_peer"):
        assert tinfo.get(key) == jinfo.get(key), key
    assert tinfo["rule_device"] == "cpu" and tinfo["rule_s"] >= 0.0


# ---------------------------------------------- config preconditions


PRECONDITIONS = [
    ("trimmed_mean", 2, 0.2), ("trimmed_mean", 3, 0.2),
    ("median", 1, 0.2), ("median", 0, 0.2), ("median", 4, 0.2),
    ("krum", 4, 0.2), ("krum", 5, 0.2), ("krum", 6, 0.3),
    ("krum", 6, 0.1), ("mean", 1, 0.2),
]


@pytest.mark.parametrize("rule,buffer,trim", PRECONDITIONS,
                         ids=[f"{r}-{b}-{t}" for r, b, t in PRECONDITIONS])
def test_robust_preconditions_equal_jax(rule, buffer, trim):
    out = {}
    for pkg, mod in (("port", tconfig), ("jax", jconfig)):
        try:
            cfg = mod.FedConfig(
                runtime="dist", sync="async", eval_every=0, num_clients=6,
                aggregator=rule, aggregator_trim=trim,
                dist=mod.DistConfig(peers=6, buffer=buffer,
                                    checkpoint_every_versions=0))
            out[pkg] = cfg.aggregator
        except ValueError as e:
            out[pkg] = str(e)
    assert out["port"] == out["jax"]
