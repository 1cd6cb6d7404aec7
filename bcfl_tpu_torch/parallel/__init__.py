"""Aggregation and gossip over the client axis (port of
``bcfl_tpu/parallel``)."""

from bcfl_tpu_torch.parallel.collectives import (  # noqa: F401
    AGGREGATORS,
    gossip_mix,
    gossip_mix_recv,
    gossip_step_mix,
    hierarchical_weighted_mean,
    make_aggregator,
    masked_krum,
    masked_median,
    masked_trimmed_mean,
    masked_weighted_mean,
    mix_with_matrix,
    rank_aware_weighted_mean,
    ring_shift,
)
