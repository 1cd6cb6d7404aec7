"""Seeded fault injection (port of ``bcfl_tpu/faults``): the local
engine's lanes and the dist runtime's wire, byzantine, storage, limp and
resource draws."""

from bcfl_tpu_torch.faults.plan import (  # noqa: F401
    BYZ_BEHAVIORS,
    FaultInjector,
    FaultPlan,
    SimulatedCrash,
)
