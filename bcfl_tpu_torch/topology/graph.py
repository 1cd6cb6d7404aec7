"""P2P latency graph and information-passing-time model: port of
``bcfl_tpu/topology/graph.py`` (host-side numpy, the same arithmetic).

A complete weighted directed graph over the clients, edge weight
1/bandwidth, bandwidths in [88, 496] mbps (:data:`REFERENCE_BANDWIDTH_MBPS`
is the reference notebooks' fixed 10-node matrix). Per-edge transfer time
= payload_GB * 1000 / bandwidth; the information passing time from a
source to every other (non-anomalous) node is the SUM of shortest-path
times (synchronous) or their MAX (asynchronous). What reaches the device
is only a participation mask.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

# The notebooks' fixed 10-node bandwidth matrix (mbps), row=src, col=dst;
# extracted numerically from the 90 G.add_edge(u, v, weight=1/bw) calls in
# All_graphs_IMDB_dataset.ipynb cell 2 (identical in the MT notebook).
REFERENCE_BANDWIDTH_MBPS = np.array(
    [
        [0, 259, 113, 479, 88, 400, 219, 209, 295, 135],
        [252, 0, 145, 343, 247, 421, 303, 383, 387, 272],
        [368, 232, 0, 308, 119, 309, 415, 435, 168, 361],
        [463, 128, 380, 0, 223, 490, 304, 370, 192, 338],
        [401, 479, 402, 465, 0, 285, 291, 370, 447, 205],
        [424, 382, 286, 340, 422, 0, 360, 224, 348, 153],
        [333, 434, 299, 363, 231, 408, 0, 486, 111, 234],
        [243, 426, 188, 180, 489, 192, 415, 0, 378, 148],
        [496, 299, 251, 343, 241, 475, 461, 434, 0, 435],
        [345, 126, 239, 196, 93, 237, 310, 370, 465, 0],
    ],
    dtype=np.float64,
)


def _floyd_warshall(w: np.ndarray) -> np.ndarray:
    """All-pairs shortest path on a dense weight matrix (inf = no edge)."""
    d = w.copy()
    n = d.shape[0]
    np.fill_diagonal(d, 0.0)
    for k in range(n):
        d = np.minimum(d, d[:, k:k + 1] + d[k:k + 1, :])
    return d


@dataclasses.dataclass
class LatencyGraph:
    """Complete directed graph over ``n`` clients with per-link bandwidth."""

    bandwidth_mbps: np.ndarray  # [n, n], 0 on the diagonal

    @property
    def n(self) -> int:
        return self.bandwidth_mbps.shape[0]

    def edge_weights(self) -> np.ndarray:
        """Directed edge weight = 1/bandwidth (the notebooks' convention)."""
        bw = self.bandwidth_mbps
        with np.errstate(divide="ignore"):
            w = np.where(bw > 0, 1.0 / np.where(bw > 0, bw, 1.0), np.inf)
        np.fill_diagonal(w, np.inf)
        return w

    def undirected_weights(self) -> np.ndarray:
        """The weight each undirected edge {u, v} (u < v) ends up with when the
        notebook adds both directions to an ``nx.Graph``: the later add wins,
        and rows are emitted in node order, so the surviving weight is
        1/bandwidth(max(u,v) -> min(u,v)). Reproduced exactly because the
        DBSCAN / modified-Z / community filters golden-test against it
        (IMDB nb cells 4, 7, 10)."""
        w = self.edge_weights()
        n = self.n
        u = np.full((n, n), np.inf)
        for i in range(n):
            for j in range(i + 1, n):
                u[i, j] = u[j, i] = w[j, i]  # later direction (j -> i) wins
        return u

    def weighted_degree(self) -> np.ndarray:
        """Undirected weighted degree per node — the feature the DBSCAN and
        modified-Z filters cluster (IMDB nb cell 4: ``G.degree(weight='weight')``)."""
        u = self.undirected_weights()
        finite = np.where(np.isfinite(u), u, 0.0)
        return finite.sum(axis=1)

    def subgraph(self, nodes: Sequence[int]) -> "LatencyGraph":
        """The latency graph restricted to ``nodes`` (sorted): the topology
        one connected component sees during a chaos partition
        (faults.FaultPlan partition lane) — cross-component links simply do
        not exist for the span. Node ``i`` of the subgraph is
        ``sorted(nodes)[i]`` of this graph; callers map filter/anomaly
        indices back through that order."""
        idx = np.asarray(sorted(int(n) for n in nodes))
        return LatencyGraph(self.bandwidth_mbps[np.ix_(idx, idx)].copy())

    def shortest_path_times(
        self, payload_gb: float, keep: Optional[Sequence[int]] = None
    ) -> np.ndarray:
        """[n, n] matrix of shortest-path transfer times (seconds) for a
        payload, restricted to ``keep`` nodes (dropped nodes can't relay —
        the notebooks rebuild the graph without anomalies)."""
        w = self.edge_weights()
        if keep is not None:
            keep = np.asarray(sorted(keep))
            w = w[np.ix_(keep, keep)]
        # x1000: GB payload over per-link MB/s (see module docstring)
        return _floyd_warshall(payload_gb * 1000.0 * w)

    def info_passing_time(
        self,
        payload_gb: float,
        source: int = 1,
        anomalies: Iterable[int] = (),
        extra_delay: Optional[Sequence[float]] = None,
        payload_bytes: Optional[int] = None,
        restrict: Optional[Sequence[int]] = None,
    ) -> Tuple[float, float]:
        """(synchronous, asynchronous) information-passing time from ``source``
        to every remaining node, after dropping ``anomalies``.

        sync = sum of per-target shortest-path times, async = max (MT nb cell
        23). ``source`` defaults to node 1, the notebooks' worked example.

        ``extra_delay`` ([n] seconds, indexed by ORIGINAL node id) adds a
        per-target completion delay on top of the transfer time — the
        fault-injection straggler model (the JAX package's fault plan): a straggling
        target receives its information late, stretching sync by its delay
        and async to the slowest delayed arrival.

        ``payload_bytes`` overrides ``payload_gb`` with an exact byte count —
        the comms model scales linearly in payload size, and the
        communication-compression accounting (COMPRESSION.md) supplies the
        actual bytes-on-wire of the codec payload rather than a rounded GB
        figure.

        ``restrict`` limits the reachable world to those nodes (original
        ids; must include ``source``) — during a chaos partition
        (faults.FaultPlan) information from the source reaches only its own
        connected component, and the cross-component links don't exist even
        as relays. A source alone in its component yields (0.0, 0.0): there
        is nobody left to inform.
        """
        if payload_bytes is not None:
            payload_gb = payload_bytes / 1e9
        drop = set(int(a) for a in anomalies)
        if source in drop:
            raise ValueError(f"source node {source} is in the anomaly set")
        if restrict is not None:
            allowed = set(int(r) for r in restrict)
            if source not in allowed:
                raise ValueError(
                    f"source node {source} is outside the restricted set")
            drop |= set(range(self.n)) - allowed
        keep = [i for i in range(self.n) if i not in drop]
        times = self.shortest_path_times(payload_gb, keep)
        src = keep.index(source)
        t = np.delete(times[src], src)
        if t.size == 0:
            return 0.0, 0.0
        if extra_delay is not None:
            d = np.asarray(extra_delay, np.float64)[keep]
            t = t + np.delete(d, src)
        return float(t.sum()), float(t.max())


def reference_graph() -> LatencyGraph:
    return LatencyGraph(REFERENCE_BANDWIDTH_MBPS.copy())


def random_graph(n: int, low: float = 88.0, high: float = 496.0,
                 seed: int = 0) -> LatencyGraph:
    """A fresh complete graph with bandwidths in the notebooks' range, for
    client counts other than 10."""
    rng = np.random.default_rng(seed)
    bw = rng.uniform(low, high, size=(n, n))
    np.fill_diagonal(bw, 0.0)
    return LatencyGraph(bw)


def metropolis_mixing_matrix(mask: np.ndarray) -> np.ndarray:
    """Doubly-stochastic Metropolis-Hastings weights over the participating
    complete subgraph — the mixing matrix for
    :func:`bcfl_tpu_torch.parallel.mix_with_matrix`. Masked nodes get identity rows
    (they neither send nor receive)."""
    n = mask.shape[0]
    m = mask.astype(bool)
    W = np.zeros((n, n))
    deg = m.sum() - 1
    for i in range(n):
        if not m[i]:
            W[i, i] = 1.0
            continue
        for j in range(n):
            if i != j and m[j]:
                W[i, j] = 1.0 / max(deg + 1, 1)
        W[i, i] = 1.0 - W[i].sum()
    return W
