"""The port's user surface: ``firefly``/``regular_mcmc`` algorithms and the
``sample`` driver with streaming collectors (see :mod:`repro.api`)."""

from repro_torch.api.algorithm import (
    MCMCState,
    SamplingAlgorithm,
    algorithm_from_spec,
    firefly,
    regular_mcmc,
)
from repro_torch.api.collectors import (
    BatchMeansESS,
    Collector,
    FullTrace,
    OnlineMoments,
    PosteriorPredictive,
    QueryBudget,
    RHat,
    ThinnedTrace,
    peek,
)
from repro_torch.api.driver import (
    ChunkEvent,
    NonFiniteError,
    Trace,
    finite_lanes,
    sample,
)

__all__ = [
    "BatchMeansESS",
    "ChunkEvent",
    "Collector",
    "FullTrace",
    "MCMCState",
    "NonFiniteError",
    "OnlineMoments",
    "PosteriorPredictive",
    "QueryBudget",
    "RHat",
    "SamplingAlgorithm",
    "ThinnedTrace",
    "Trace",
    "algorithm_from_spec",
    "finite_lanes",
    "firefly",
    "peek",
    "regular_mcmc",
    "sample",
]
