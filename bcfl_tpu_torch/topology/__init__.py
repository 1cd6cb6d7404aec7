"""P2P latency graph and anomaly filters (port of ``bcfl_tpu/topology``)."""

from bcfl_tpu_torch.topology.graph import (  # noqa: F401
    LatencyGraph,
    REFERENCE_BANDWIDTH_MBPS,
    metropolis_mixing_matrix,
    random_graph,
    reference_graph,
)
from bcfl_tpu_torch.topology.filters import (  # noqa: F401
    FILTERS,
    anomaly_filter,
    pagerank_scores,
    partitioned_anomaly_filter,
)
