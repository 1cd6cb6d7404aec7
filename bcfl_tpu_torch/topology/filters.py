"""Anomaly-node filters: port of ``bcfl_tpu/topology/filters.py`` (host-side
numpy; DBSCAN and community detection import scikit-learn and networkx
inside their filters, as in JAX).

Each filter maps a :class:`~bcfl_tpu_torch.topology.graph.LatencyGraph` to
an anomaly set; :func:`anomaly_filter` returns the round's participation
mask. PageRank: weighted PageRank on the directed 1/bandwidth graph,
anomaly iff the rank lies outside mean +- 1 sigma. DBSCAN: cluster the
undirected weighted degree (eps 300, min_samples 2), label -1. Modified
Z: ``0.6745 (x - median) / MAD`` of the weighted degree, ``|z| > 1``.
Community: greedy modularity communities, nodes outside every community
and singleton communities.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np

from bcfl_tpu_torch.topology.graph import LatencyGraph


def pagerank_scores(g: LatencyGraph, damping: float = 0.85,
                    tol: float = 1e-10, max_iter: int = 200) -> np.ndarray:
    """Weighted PageRank by power iteration on the directed 1/bandwidth graph
    (numpy re-derivation of ``nx.pagerank(G, weight='weight')``)."""
    w = g.edge_weights()
    w = np.where(np.isfinite(w), w, 0.0)
    out = w.sum(axis=1, keepdims=True)
    # dangling nodes distribute uniformly, as networkx does
    P = np.where(out > 0, w / np.where(out > 0, out, 1.0), 1.0 / g.n)
    r = np.full((g.n,), 1.0 / g.n)
    for _ in range(max_iter):
        r_new = (1 - damping) / g.n + damping * (r @ P)
        if np.abs(r_new - r).sum() < tol:
            return r_new
        r = r_new
    return r


def pagerank_filter(g: LatencyGraph) -> Tuple[List[int], np.ndarray]:
    r = pagerank_scores(g)
    mean, std = r.mean(), r.std()  # population std, as the notebook computes
    lo, hi = mean - std, mean + std
    return [int(i) for i in np.where((r < lo) | (r > hi))[0]], r


def dbscan_filter(g: LatencyGraph, eps: float = 300.0,
                  min_samples: int = 2) -> Tuple[List[int], np.ndarray]:
    deg = g.weighted_degree()
    from sklearn.cluster import DBSCAN

    labels = DBSCAN(eps=eps, min_samples=min_samples).fit_predict(deg.reshape(-1, 1))
    return [int(i) for i in np.where(labels == -1)[0]], deg


def modified_z_filter(g: LatencyGraph,
                      threshold: float = 1.0) -> Tuple[List[int], np.ndarray]:
    deg = g.weighted_degree()
    med = np.median(deg)
    mad = np.median(np.abs(deg - med))
    if mad == 0:
        return [], np.zeros_like(deg)
    z = 0.6745 * (deg - med) / mad
    return [int(i) for i in np.where(np.abs(z) > threshold)[0]], z


def community_filter(g: LatencyGraph) -> Tuple[List[int], np.ndarray]:
    import networkx as nx

    u = g.undirected_weights()
    G = nx.Graph()
    G.add_nodes_from(range(g.n))
    for i in range(g.n):
        for j in range(i + 1, g.n):
            if np.isfinite(u[i, j]):
                G.add_edge(i, j, weight=u[i, j])
    communities = list(nx.community.greedy_modularity_communities(G, weight="weight"))
    member = np.full((g.n,), -1)
    for ci, com in enumerate(communities):
        for node in com:
            member[node] = ci
    anomalies = set(int(i) for i in np.where(member < 0)[0])
    # singleton communities are isolates in all but name
    for ci, com in enumerate(communities):
        if len(com) == 1:
            anomalies.update(int(x) for x in com)
    return sorted(anomalies), member.astype(np.float64)


FILTERS: Dict[str, Callable[[LatencyGraph], Tuple[List[int], np.ndarray]]] = {
    "pagerank": pagerank_filter,
    "dbscan": dbscan_filter,
    "zscore": modified_z_filter,
    "community": community_filter,
}


def anomaly_filter(name: str | None, g: LatencyGraph,
                   protect: Tuple[int, ...] = ()) -> Dict:
    """Run filter ``name`` and return the round's gating decision:

    ``{"anomalies": [...], "mask": float[n] (1 = participate), "scores": [...]}``

    ``protect`` nodes are never masked (e.g. the info-passing source). ``None``
    disables filtering (all-ones mask).
    """
    if name is None or name == "none":
        return {"anomalies": [], "mask": np.ones((g.n,), np.float32),
                "scores": np.zeros((g.n,))}
    if name not in FILTERS:
        raise KeyError(f"unknown anomaly filter {name!r}; have {sorted(FILTERS)}")
    anomalies, scores = FILTERS[name](g)
    return _gate(anomalies, scores, g.n, protect)


def _gate(anomalies, scores, n: int, protect: Tuple[int, ...]) -> Dict:
    """The gating decision shape shared by the whole-mesh and partitioned
    filters: protected nodes un-flagged, 0/1 mask derived from the rest."""
    anomalies = sorted(set(int(a) for a in anomalies) - set(protect))
    mask = np.ones((n,), np.float32)
    mask[list(anomalies)] = 0.0
    return {"anomalies": anomalies, "mask": mask, "scores": scores}


def partitioned_anomaly_filter(
        name: str | None, g: LatencyGraph,
        components: Tuple[Tuple[int, ...], ...],
        protect: Tuple[int, ...] = ()) -> Dict:
    """:func:`anomaly_filter` under a network partition (the fault plan's
    partition lane): each connected component sees only its own subgraph,
    since degrees, PageRank mass and communities all change when the
    cross-component links vanish. The filter runs per component
    (singletons skipped: a 1-node graph has no statistics) and anomaly
    indices map back through the subgraph's sorted node order. Same return
    shape as :func:`anomaly_filter`; scores are stitched into one global
    [n] vector."""
    if name is None or name == "none":
        return anomaly_filter(name, g, protect)
    if name not in FILTERS:
        raise KeyError(f"unknown anomaly filter {name!r}; have {sorted(FILTERS)}")
    n = g.n
    anomalies: List[int] = []
    scores = np.zeros((n,), np.float64)
    for comp in components:
        nodes = sorted(int(c) for c in comp)
        if len(nodes) < 2:
            continue
        sub_anoms, sub_scores = FILTERS[name](g.subgraph(nodes))
        scores[nodes] = np.asarray(sub_scores, np.float64)
        anomalies.extend(nodes[i] for i in sub_anoms)
    return _gate(anomalies, scores, n, protect)
