"""Run-wide event tracing (port of ``bcfl_tpu/telemetry``; host-only):
crash-safe per-process event streams, the causal cross-peer collator, and
the invariant checks as queries over the merged stream (OBSERVABILITY.md).

- :mod:`bcfl_tpu_torch.telemetry.events` — the append-only JSONL
  :class:`EventWriter` and the process-global :func:`emit` seam (a no-op
  until a writer is installed);
- :mod:`bcfl_tpu_torch.telemetry.collate` — the torn-tail-tolerant
  reader, the happens-before merge across processes and the timeline
  rollups;
- :mod:`bcfl_tpu_torch.telemetry.invariants` — the invariant catalogue;
- :mod:`bcfl_tpu_torch.telemetry.live` — the live counterpart: incremental
  stream tailing, streaming invariant checks with batch parity, the
  per-round ``health.jsonl`` series with threshold alerts, and the
  ``monitor`` subcommand (OBSERVABILITY.md §6).
"""

from bcfl_tpu_torch.telemetry.collate import (  # noqa: F401
    causal_order,
    collate,
    collate_run,
    find_streams,
    read_stream,
    resolve_stream_dir,
    summarize,
    trace_main,
)
from bcfl_tpu_torch.telemetry.events import (  # noqa: F401
    EVENT_TYPES,
    SCHEMA_VERSION,
    EventWriter,
    emit,
    emit_sampled,
    flush,
    get_writer,
    install,
    uninstall,
)
from bcfl_tpu_torch.telemetry.invariants import (  # noqa: F401
    INVARIANTS,
    run_invariants,
)
from bcfl_tpu_torch.telemetry.live import (  # noqa: F401
    STREAMING_CHECKS,
    AlertManager,
    AlertThresholds,
    HealthRollup,
    LiveCollator,
    StreamingInvariantSuite,
    StreamTailer,
    monitor_main,
)
