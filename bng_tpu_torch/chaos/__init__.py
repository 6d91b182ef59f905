"""Fault injection and the invariant auditor for the port (copies of
`bng_tpu/chaos/faults.py` and `invariants.py`): a seeded `FaultPlan`, the
`fault_point()` hook the control plane, the engine, the devloop and the
swap call, and `invariants.audit_invariants`. The reference's scenarios
and storms are not ported."""

from bng_tpu_torch.chaos.faults import (FaultInjector, FaultPlan,  # noqa: F401
                                        FaultSpec, armed, fault_point,
                                        mutate_point)
