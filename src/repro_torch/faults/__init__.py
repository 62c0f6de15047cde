"""repro_torch.faults — deterministic, seeded fault injection for the
lifecycle, the port's own copy of ``repro/faults`` (same schedule, same
decisions for the same seed).

See :mod:`repro_torch.faults.plan` for the schedule semantics and
:mod:`repro_torch.faults.chaos` for the full-lifecycle chaos harness
used by the ``pytest -m chaos`` tier (``tests/test_torch_chaos.py``).
"""
from repro_torch.faults.chaos import (
    REQUIRED_SITES,
    UNIQUE_ITEM_BASE,
    default_specs,
    run_chaos,
)
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
    "REQUIRED_SITES",
    "UNIQUE_ITEM_BASE",
    "clear_plan",
    "corrupt_file",
    "default_specs",
    "get_faults",
    "install_plan",
    "run_chaos",
]
