"""repro_torch.serve — multi-tenant posterior sampling as a service.

Port of :mod:`repro.serve`. Jobs (dataset, GLM family, FlyMC knobs,
convergence policy) arrive in a queue; the scheduler packs compatible jobs
into shared group engines, each job a lane (continuous batching: jobs join
and leave at chunk boundaries); results stream per job through
non-destructive collector peeks; R̂/ESS policies auto-terminate.

The contract: every job's trajectory and every result is bitwise what a
solo ``api.sample`` run with the same seed produces, whatever the packing
(see :mod:`repro_torch.serve.engine`).

    svc = Service(chunk_size=64)                       # on the card
    h = svc.submit(Job(job_id="a", family="logistic", data=data, seed=0,
                       policy=TerminationPolicy(max_samples=2000,
                                                target_rhat=1.01)))
    results = svc.run()                                # {job_id: JobResult}
    theta = results["a"].samples()
"""

from repro_torch.serve.engine import GroupEngine
from repro_torch.serve.faults import FaultEvent, RetryPolicy
from repro_torch.serve.job import (
    Job,
    TerminationPolicy,
    build_algorithm,
    default_collectors,
    group_key,
)
from repro_torch.serve.results import JobHandle, JobResult, JobStatus, StreamUpdate
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.service import Service

__all__ = [
    "FaultEvent",
    "GroupEngine",
    "Job",
    "JobHandle",
    "JobResult",
    "JobStatus",
    "RetryPolicy",
    "Scheduler",
    "Service",
    "StreamUpdate",
    "TerminationPolicy",
    "build_algorithm",
    "default_collectors",
    "group_key",
]
