"""Aggregation over the client axis (port of ``bcfl_tpu/parallel``)."""

from bcfl_tpu_torch.parallel.collectives import masked_weighted_mean  # noqa: F401
