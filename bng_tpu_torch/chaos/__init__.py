"""Fault injection, the invariant auditor and the chaos suite of the port
(copies of `bng_tpu/chaos/`): a seeded `FaultPlan` and the `fault_point()`
hook the control plane, the fleet, the engine, the devloop and the swap
call (`faults`), `invariants.audit_invariants`, the scripted scenarios
and storms (`scenarios`, `storms`) and their driver with the seeded soak
(`runner`, behind `chaos run`). Only `faults` is imported here: the
instrumented modules import `fault_point` from it, and the scenarios
import those modules."""

from bng_tpu_torch.chaos.faults import (FaultInjector, FaultPlan,  # noqa: F401
                                        FaultSpec, armed, fault_point,
                                        mutate_point)
