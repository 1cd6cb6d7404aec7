"""Run metrics (port of ``bcfl_tpu/metrics``)."""

from bcfl_tpu_torch.metrics.metrics import (  # noqa: F401
    ResourceMonitor,
    RoundRecord,
    RunMetrics,
    model_size_gb,
)
from bcfl_tpu_torch.metrics.tracing import StepClock, annotate, trace  # noqa: F401
