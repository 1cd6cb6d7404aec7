"""Run metrics (port of ``bcfl_tpu/metrics``)."""

from bcfl_tpu_torch.metrics.metrics import (  # noqa: F401
    ResourceMonitor,
    RoundRecord,
    RunMetrics,
    StepClock,
    model_size_gb,
)
