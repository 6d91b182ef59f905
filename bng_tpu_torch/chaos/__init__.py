"""Fault injection for the port (copy of the `faults` half of
`bng_tpu/chaos/`): a seeded `FaultPlan` and the `fault_point()` hook the
control plane, the engine and the devloop call. The reference's invariant
auditor, scenarios and storms are not ported."""

from bng_tpu_torch.chaos.faults import (FaultInjector, FaultPlan,  # noqa: F401
                                        FaultSpec, armed, fault_point,
                                        mutate_point)
