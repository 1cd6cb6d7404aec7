"""Peer-lifecycle reputation (port of ``bcfl_tpu/reputation``): the local
engine's tracker and the dist runtime's per-peer tracker with its ledger
rows."""

from bcfl_tpu_torch.reputation.lifecycle import (  # noqa: F401
    HEALTHY,
    PROBATION,
    QUARANTINED,
    STATE_NAMES,
    SUSPECT,
    ReputationConfig,
    ReputationTracker,
)
from bcfl_tpu_torch.reputation.dist import (  # noqa: F401
    REP_CLIENT_BASE,
    DistReputationTracker,
    decode_rep_row,
    encode_rep_row,
    rep_row_client,
)
