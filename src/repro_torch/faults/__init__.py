"""repro_torch.faults — deterministic, seeded fault injection for the
lifecycle, the port's own copy of ``repro/faults`` (same schedule, same
decisions for the same seed).

See :mod:`repro_torch.faults.plan` for the schedule semantics.  The JAX
package's full-lifecycle chaos harness (``repro/faults/chaos.py``) is
not ported yet.
"""
from repro_torch.faults.plan import (
    ACTIONS,
    FaultInjector,
    FaultPlan,
    FaultSpec,
    InjectedCrash,
    InjectedFault,
    clear_plan,
    corrupt_file,
    get_faults,
    install_plan,
)

__all__ = [
    "ACTIONS",
    "FaultInjector",
    "FaultPlan",
    "FaultSpec",
    "InjectedCrash",
    "InjectedFault",
    "clear_plan",
    "corrupt_file",
    "get_faults",
    "install_plan",
]
