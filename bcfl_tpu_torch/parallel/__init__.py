"""Aggregation and gossip over the client axis, ring attention (port of
``bcfl_tpu/parallel``); the tensor-parallel forward is
:mod:`bcfl_tpu_torch.parallel.tp_linear`, the clients x tp rounds
:mod:`bcfl_tpu_torch.parallel.fed_tp`, sequence parallelism
:mod:`bcfl_tpu_torch.parallel.sp` (imported from their modules: they
reach the models, which reach this package)."""

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
from bcfl_tpu_torch.parallel.ring_attention import (  # noqa: F401
    ring_attention,
    ring_attention_gspmd,
    ring_attention_sharded,
)
