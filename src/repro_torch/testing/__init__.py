"""repro_torch.testing — fault-injection tooling for the serve stack.

:mod:`repro_torch.testing.chaos` drives the sampling service through
seeded, fully deterministic fault schedules (device loss, chunk crashes, NaN
poisoning, checkpoint corruption, kills mid-save, stragglers) and verifies
the exactness contract under fire: every surviving job's committed
trajectory bitwise its fault-free run, every faulted job's results a
bitwise clean prefix, and no corrupt checkpoint ever restored silently.
Port of :mod:`repro.testing`.
"""

from repro_torch.testing.chaos import (
    ChaosError,
    ChaosHarness,
    ChaosReport,
    Fault,
    InjectedKill,
    corrupt_checkpoint,
    run_schedule,
    schedule,
)

__all__ = [
    "ChaosError",
    "ChaosHarness",
    "ChaosReport",
    "Fault",
    "InjectedKill",
    "corrupt_checkpoint",
    "run_schedule",
    "schedule",
]
