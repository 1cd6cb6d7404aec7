"""Aggregation and gossip over the client axis (port of
``bcfl_tpu/parallel``)."""

from bcfl_tpu_torch.parallel.collectives import (  # noqa: F401
    gossip_mix,
    gossip_mix_recv,
    gossip_step_mix,
    masked_weighted_mean,
    mix_with_matrix,
    ring_shift,
)
