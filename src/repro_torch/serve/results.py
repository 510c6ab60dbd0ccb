"""Per-job result surfaces: status, streamed updates, finished results.

Port of :mod:`repro.serve.results`. While a job runs the client sees
:class:`StreamUpdate`\\ s at chunk boundaries (committed counts and
non-destructive collector peeks); when it retires, a :class:`JobResult`
holding bitwise what a solo ``api.sample`` run with the same seed returns
in ``Trace.results``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any


class JobStatus(enum.Enum):
    QUEUED = "queued"        # submitted, not yet packed into a group
    RUNNING = "running"      # a lane of a group engine
    SUSPENDED = "suspended"  # evicted for capacity (device loss); will repack
    DONE = "done"
    CANCELLED = "cancelled"
    FAILED = "failed"        # quarantined (non-finite lane) or retries exhausted


@dataclasses.dataclass(frozen=True)
class StreamUpdate:
    """One chunk boundary's view of one running job: committed samples and
    the peeks of the collectors the caller subscribed to (plus any peeks the
    termination policy took at this boundary)."""

    job_id: str
    committed: int
    peeks: dict
    done: bool = False
    reason: str | None = None


@dataclasses.dataclass(frozen=True)
class JobResult:
    """A retired job. ``results`` = finalized ``{name: collector result}``,
    bitwise the solo run's ``Trace.results``; ``reason`` ∈ {"max_samples",
    "converged", "cancelled", "quarantined", "failed"}; ``committed``
    counts folded samples. A quarantined or failed job holds its last clean
    committed prefix."""

    job_id: str
    results: dict
    committed: int
    reason: str

    def samples(self, name: str = "trace"):
        """The (num_chains, committed, ...) θ of a trace collector's result,
        cut to the committed prefix (the buffer is sized for
        ``max_samples``)."""
        return self.results[name]["theta"][:, : self.committed]


class JobHandle:
    """The client's grip on a submitted job; every read goes to the
    service's live registry, so a handle is never stale."""

    def __init__(self, service, job_id: str):
        self._service = service
        self.job_id = job_id

    @property
    def status(self) -> JobStatus:
        return self._service.status(self.job_id)

    @property
    def committed(self) -> int:
        return self._service.committed(self.job_id)

    def peek(self, name: str) -> Any:
        """Non-destructive mid-run read of one collector (running jobs)."""
        return self._service.peek(self.job_id, name)

    def result(self) -> JobResult | None:
        """The JobResult once retired; None while in flight."""
        return self._service.result(self.job_id)

    def cancel(self) -> bool:
        return self._service.cancel(self.job_id)

    def __repr__(self):
        return (f"JobHandle({self.job_id!r}, {self.status.value}, "
                f"committed={self.committed})")
