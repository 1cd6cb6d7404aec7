"""Crash-safe checkpoint and resume (port of ``bcfl_tpu/checkpoint``)."""

from bcfl_tpu_torch.checkpoint.checkpoint import (  # noqa: F401
    ROUND_STATUSES,
    apply_storage_fault,
    classify_round,
    restore_checkpoint,
    restore_latest,
    save_checkpoint,
    scrub,
)
