"""Seeded fault injection, the local engine's lanes (port of
``bcfl_tpu/faults``)."""

from bcfl_tpu_torch.faults.plan import (  # noqa: F401
    FaultInjector,
    FaultPlan,
    SimulatedCrash,
)
