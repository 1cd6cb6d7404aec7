"""PyTorch port (``bcfl_tpu_torch``): the latency graph and the anomaly
filters against the JAX package, bit for bit.

Both are host numpy. On ``reference_graph()`` and on ``random_graph(n,
seed)`` for n in {4, 7, 10}: the bandwidth and weight matrices, the
weighted degree, ``shortest_path_times``, ``info_passing_time`` with and
without anomalies, straggler delays, an exact byte count and a restricted
node set, every filter (PageRank scores, DBSCAN, modified Z, community)
and the gate ``anomaly_filter`` returns, the Metropolis mixing matrix, and
the subgraph. Equality is exact (``assert_array_equal``).
"""

import numpy as np
import pytest

from bcfl_tpu.topology import filters as jfilt
from bcfl_tpu.topology import graph as jgraph
from bcfl_tpu_torch.topology import filters as tfilt
from bcfl_tpu_torch.topology import graph as tgraph

GRAPHS = [("reference", None), ("random", 4), ("random", 7), ("random", 10)]


def _pair(kind, n, seed=3):
    if kind == "reference":
        return jgraph.reference_graph(), tgraph.reference_graph()
    return (jgraph.random_graph(n, seed=seed),
            tgraph.random_graph(n, seed=seed))


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


@pytest.mark.parametrize("kind,n", GRAPHS)
def test_graph_matrices_match_jax(kind, n):
    jg, tg = _pair(kind, n)
    _eq(tg.bandwidth_mbps, jg.bandwidth_mbps)
    assert tg.n == jg.n
    _eq(tg.edge_weights(), jg.edge_weights())
    _eq(tg.undirected_weights(), jg.undirected_weights())
    _eq(tg.weighted_degree(), jg.weighted_degree())
    for gb in (0.4036, 0.043):
        _eq(tg.shortest_path_times(gb), jg.shortest_path_times(gb))
        keep = list(range(0, tg.n, 2))
        _eq(tg.shortest_path_times(gb, keep), jg.shortest_path_times(gb, keep))
    nodes = [tg.n - 1, 0, 1]
    _eq(tg.subgraph(nodes).bandwidth_mbps, jg.subgraph(nodes).bandwidth_mbps)


@pytest.mark.parametrize("kind,n", GRAPHS)
def test_info_passing_time_matches_jax(kind, n):
    jg, tg = _pair(kind, n)
    rng = np.random.default_rng(tg.n)
    delay = rng.uniform(0.0, 3.0, tg.n)
    cases = [
        dict(payload_gb=0.4036),
        dict(payload_gb=0.4036, source=0),
        dict(payload_gb=0.0, payload_bytes=123_456_789),
        dict(payload_gb=0.4036, anomalies=[tg.n - 1, 2 % tg.n] if tg.n > 2
             else []),
        dict(payload_gb=0.043, extra_delay=delay),
        dict(payload_gb=0.043, anomalies=[0], source=1, extra_delay=delay,
             payload_bytes=46_170_898),
        dict(payload_gb=0.4036, source=1, restrict=[1, 0]),
        dict(payload_gb=0.4036, source=1, restrict=[1]),
    ]
    for kw in cases:
        assert tg.info_passing_time(**kw) == jg.info_passing_time(**kw), kw
    with pytest.raises(ValueError, match="anomaly set"):
        tg.info_passing_time(0.4, source=0, anomalies=[0])


@pytest.mark.parametrize("kind,n", GRAPHS)
@pytest.mark.parametrize("name", ["pagerank", "dbscan", "zscore",
                                  "community"])
def test_filters_match_jax(kind, n, name):
    jg, tg = _pair(kind, n)
    ja, js = jfilt.FILTERS[name](jg)
    ta, ts = tfilt.FILTERS[name](tg)
    assert ta == ja
    _eq(ts, js)
    for protect in ((), (1,), (0, 1)):
        jgate = jfilt.anomaly_filter(name, jg, protect=protect)
        tgate = tfilt.anomaly_filter(name, tg, protect=protect)
        assert tgate["anomalies"] == jgate["anomalies"]
        _eq(tgate["mask"], jgate["mask"])
        assert tgate["mask"].dtype == jgate["mask"].dtype
        _eq(tgate["scores"], jgate["scores"])


def test_pagerank_on_the_reference_graph():
    """The anomalies the BC-FL preset gates on (``chip_smoke.py`` holds
    the card's run to this constant): PageRank over the notebooks'
    10-node graph flags nodes 0, 4, 7 and 9."""
    jg, tg = _pair("reference", None)
    _eq(tfilt.pagerank_scores(tg), jfilt.pagerank_scores(jg))
    gate = tfilt.anomaly_filter("pagerank", tg, protect=(1,))
    assert gate["anomalies"] == [0, 4, 7, 9]
    assert gate["anomalies"] == jfilt.anomaly_filter(
        "pagerank", jg, protect=(1,))["anomalies"]


def test_filter_off_unknown_and_partitioned():
    tg = tgraph.reference_graph()
    for off in (None, "none"):
        gate = tfilt.anomaly_filter(off, tg)
        assert gate["anomalies"] == [] and gate["mask"].sum() == 10
    with pytest.raises(KeyError, match="unknown anomaly filter"):
        tfilt.anomaly_filter("louvain", tg)
    # a partition's filter runs per component (the JAX package's result is
    # held bit for bit in tests/test_torch_faults.py)
    gate = tfilt.partitioned_anomaly_filter("pagerank", tg, ((0, 1), (2, 3)))
    assert gate["mask"].shape == (10,)
    for off in (None, "none"):
        gate = tfilt.partitioned_anomaly_filter(off, tg, ((0, 1), (2, 3)))
        assert gate["anomalies"] == [] and gate["mask"].sum() == 10
    with pytest.raises(KeyError, match="unknown anomaly filter"):
        tfilt.partitioned_anomaly_filter("louvain", tg, ((0, 1), (2, 3)))


@pytest.mark.parametrize("mask", [[1, 1, 1, 1], [1, 0, 1, 1, 0],
                                  [0, 0, 0], [1, 1, 0, 1, 1, 1, 1]])
def test_metropolis_mixing_matrix_matches_jax(mask):
    m = np.asarray(mask, np.float32)
    _eq(tgraph.metropolis_mixing_matrix(m), jgraph.metropolis_mixing_matrix(m))
