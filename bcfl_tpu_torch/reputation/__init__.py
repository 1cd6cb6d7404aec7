"""Peer-lifecycle reputation (port of ``bcfl_tpu/reputation``, the local
engine's tracker)."""

from bcfl_tpu_torch.reputation.lifecycle import (  # noqa: F401
    HEALTHY,
    PROBATION,
    QUARANTINED,
    STATE_NAMES,
    SUSPECT,
    ReputationConfig,
    ReputationTracker,
)
