"""The port's user surface: ``firefly``/``regular_mcmc`` algorithms and the
``sample`` driver with streaming collectors (see :mod:`repro.api`)."""

from repro_torch.api.algorithm import (
    MCMCState,
    SamplingAlgorithm,
    algorithm_from_spec,
    firefly,
    regular_mcmc,
)
from repro_torch.api.collectors import FullTrace, OnlineMoments, QueryBudget, RHat
from repro_torch.api.driver import Trace, sample

__all__ = [
    "FullTrace",
    "MCMCState",
    "OnlineMoments",
    "QueryBudget",
    "RHat",
    "SamplingAlgorithm",
    "Trace",
    "algorithm_from_spec",
    "firefly",
    "regular_mcmc",
    "sample",
]
