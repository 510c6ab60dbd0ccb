"""Job: one tenant's posterior-sampling request, and what makes jobs batchable.

Port of :mod:`repro.serve.job`. A :class:`Job` is everything the service
needs to run one FlyMC posterior: a dataset, a GLM family with its
hyperparameters, the FlyMC knobs, a seed, a :class:`TerminationPolicy` and
the collectors. :func:`build_algorithm` turns it into the same
:class:`~repro_torch.api.algorithm.SamplingAlgorithm` a direct
:func:`repro_torch.api.sample` caller gets, which is what makes the
service's contract checkable: a job's trajectory in a packed group is
bitwise the solo ``api.sample`` run with the same seed.

:func:`group_key` decides which jobs share a group engine. It pins every
property of the step that is not data: family and hyperparameters, (N, D),
chain count, θ-kernel, q_db, engines, adaptation, trace length and the
collector signature. Not in the key: the capacities (chains are bitwise
capacity-invariant, so a group runs its members at one group capacity),
the step size (it lives in the chain state) and the dataset values (each
lane steps on its own dataset).

:func:`chain_rows` copies the port driver's key discipline exactly, so the
per-iteration keys ``fold_in(chain_key, iteration)`` are the same in and
out of the service.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch import random as jr
from repro_torch.api import collectors as collectors_lib
from repro_torch.api.algorithm import SamplingAlgorithm, firefly
from repro_torch.api.driver import _chain_positions, init_and_chain_keys
from repro_torch.core.bounds import GLMData
from repro_torch.models.bayes_glm import GLMModel


@dataclasses.dataclass(frozen=True)
class TerminationPolicy:
    """When a job stops sampling (checked at chunk boundaries).

    A job retires once ``max_samples`` have committed, or, past
    ``min_samples``, when every enabled criterion holds: peeked split-R̂
    ``<= target_rhat`` (needs an "rhat" collector) and peeked batch-means
    ESS ``>= min_ess`` (needs an "ess" collector). ``check_every``
    throttles the convergence peeks to every k-th chunk.
    """

    max_samples: int = 2000
    min_samples: int = 0
    target_rhat: float | None = None
    min_ess: float | None = None
    check_every: int = 1

    def __post_init__(self):
        if self.max_samples < 1:
            raise ValueError("max_samples must be >= 1")
        if self.check_every < 1:
            raise ValueError("check_every must be >= 1")


def default_collectors() -> dict:
    """The service default: the full trace and streamed R̂."""
    return {"trace": collectors_lib.FullTrace(), "rhat": collectors_lib.RHat()}


@dataclasses.dataclass(eq=False)
class Job:
    """One posterior-sampling request. ``family`` ∈ {logistic, softmax,
    robust}; each family reads its own hyperparameters below. ``data`` is a
    :class:`GLMData` on the service's device. ``collectors`` defaults to
    :func:`default_collectors`; the engine sizes them for ``max_samples``.

    The engines default to the two kernels, ``backend="pallas"`` and
    ``z_backend="fused"``, as the port's :func:`~repro_torch.api.firefly`
    does: a service on the card runs the kernels. The reference's ``Job``
    defaults to the plain engines (``"jnp"``/``"jnp"``); pass both for its
    chain.
    """

    job_id: str
    family: str
    data: GLMData
    seed: int = 0
    num_chains: int = 1
    init_position: Any = None
    # family hyperparameters
    prior_scale: float = 1.0
    xi: float = 1.5          # logistic: bound tangency
    n_classes: int = 3       # softmax
    nu: float = 4.0          # robust: Student-t dof
    sigma: float = 1.0       # robust: noise scale
    # FlyMC knobs
    kernel: str = "rwmh"
    step_size: float = 0.1
    q_db: float = 0.01
    mode: str = "implicit"
    resample_fraction: float = 0.1
    capacity: int = 256
    cand_capacity: int = 256
    backend: str = "pallas"
    z_backend: str = "fused"
    adapt_target: Any = None
    num_warmup: int = 1000
    # service-level
    policy: TerminationPolicy = dataclasses.field(default_factory=TerminationPolicy)
    collectors: dict | None = None

    def __post_init__(self):
        if self.family not in ("logistic", "softmax", "robust"):
            raise ValueError(f"unknown family {self.family!r}")
        if self.num_chains < 1:
            raise ValueError("num_chains must be >= 1")
        if self.collectors is None:
            self.collectors = default_collectors()
        self.collectors = collectors_lib.validate_collectors(self.collectors)
        if self.policy.target_rhat is not None and "rhat" not in self.collectors:
            raise ValueError(
                f"job {self.job_id!r}: target_rhat termination needs an "
                f"'rhat' collector (e.g. api.RHat())"
            )
        if self.policy.min_ess is not None and "ess" not in self.collectors:
            raise ValueError(
                f"job {self.job_id!r}: min_ess termination needs an 'ess' "
                f"collector (e.g. api.BatchMeansESS())"
            )

    @property
    def device(self):
        return self.data.x.device


def build_model(job: Job) -> GLMModel:
    """The job's GLMModel on its data's device, as a direct user builds it."""
    dev = job.device
    if job.family == "logistic":
        return GLMModel.logistic(job.data, prior_scale=job.prior_scale,
                                 xi=job.xi, device=dev)
    if job.family == "softmax":
        return GLMModel.softmax(job.data, n_classes=job.n_classes,
                                prior_scale=job.prior_scale, device=dev)
    return GLMModel.robust(job.data, nu=job.nu, sigma=job.sigma,
                           prior_scale=job.prior_scale, device=dev)


def build_algorithm(
    job: Job, capacity: int | None = None, cand_capacity: int | None = None
) -> SamplingAlgorithm:
    """The job as a SamplingAlgorithm, bitwise the solo-run construction.
    ``capacity``/``cand_capacity`` override the job's (a group runs its
    members at the group capacity; trajectories do not depend on it)."""
    return firefly(
        build_model(job),
        kernel=job.kernel,
        capacity=job.capacity if capacity is None else capacity,
        cand_capacity=(job.cand_capacity if cand_capacity is None
                       else cand_capacity),
        q_db=job.q_db,
        mode=job.mode,
        resample_fraction=job.resample_fraction,
        step_size=job.step_size,
        adapt_target=job.adapt_target,
        num_warmup=job.num_warmup,
        backend=job.backend,
        z_backend=job.z_backend,
        device=job.device,
    )


def collector_sig(colls: dict) -> tuple:
    """Hashable signature of a collector set: type and configuration per
    name, sorted by name. A tensor field contributes its shape, dtype and
    identity; a callable its identity."""
    out = []
    for name in sorted(colls):
        col = colls[name]
        fields = []
        if dataclasses.is_dataclass(col):
            for f in dataclasses.fields(col):
                v = getattr(col, f.name)
                if hasattr(v, "shape") and hasattr(v, "dtype"):
                    fields.append((f.name, ("array", tuple(v.shape),
                                            str(v.dtype), id(v))))
                elif callable(v):
                    fields.append((f.name, ("fn", id(v))))
                else:
                    fields.append((f.name, v))
        out.append((name, type(col).__name__, tuple(fields)))
    return tuple(out)


def group_key(job: Job) -> tuple:
    """The batching-group key: jobs with equal keys share one engine."""
    n, d = job.data.x.shape
    fam = (job.family,)
    if job.family == "logistic":
        fam += (job.prior_scale, job.xi)
    elif job.family == "softmax":
        fam += (job.prior_scale, job.n_classes)
    else:
        fam += (job.prior_scale, job.nu, job.sigma)
    return (
        fam, n, d, job.num_chains,
        job.kernel, job.q_db, job.mode, job.resample_fraction,
        job.backend, job.z_backend, job.adapt_target, job.num_warmup,
        job.policy.max_samples,
        collector_sig(job.collectors),
    )


def chain_rows(job: Job, alg: SamplingAlgorithm):
    """Initial states and chain keys, by the port driver's key discipline
    (:func:`repro_torch.api.driver.init_and_chain_keys`). Returns
    ``(states, chain_keys (K, 2))``."""
    init_keys, chain_keys = init_and_chain_keys(
        jr.key(job.seed, device=job.device), job.num_chains)
    position = (job.init_position if job.init_position is not None
                else alg.default_position)
    if position is None:
        raise ValueError(f"job {job.job_id!r} has no initial position")
    positions = _chain_positions(position, job.num_chains,
                                 alg.default_position)
    return alg.init(init_keys, positions.to(job.device)), chain_keys
