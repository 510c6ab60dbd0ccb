"""Fault taxonomy and structured fault records for the sampling service.

Port of :mod:`repro.serve.faults` (plain Python, the same semantics). Every
recovery path leaves the surviving chains bitwise on their fault-free
trajectories: a chunk re-runs from its committed boundary with the same
keys (they derive from the states' iteration counters), so exact replay is
the recovery primitive.

=====================  ====================================================
kind                   meaning / response
=====================  ====================================================
``nonfinite``          a lane's θ / log-joint / δ cache / dataset went
                       non-finite: the per-chunk health sentinel
                       quarantines that job's lane (pre-chunk state kept,
                       the poisoned chunk never folded)
``chunk_error``        a group chunk raised: retried from the last
                       committed boundary under :class:`RetryPolicy`
``group_failed``       retries exhausted: the group's jobs retire FAILED
                       with their committed (clean) prefixes
``straggler``          a group's chunk wall-time EWMA exceeds the fleet
                       median × threshold
``device_loss``        the elastic shrink ran (shrink the budget, suspend
                       newest-first, repack)
``checkpoint_fallback``  ``Service.restore`` skipped corrupt checkpoint
                       steps and loaded the newest intact one
=====================  ====================================================

:class:`FaultEvent` records stream through ``Service.step``'s return value,
interleaved with the ``StreamUpdate``\\ s, and accumulate on
``Service.faults``.
"""

from __future__ import annotations

import dataclasses

FAULT_KINDS = (
    "nonfinite",
    "chunk_error",
    "group_failed",
    "straggler",
    "device_loss",
    "checkpoint_fallback",
)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One detected fault and the service's response to it.

    ``step`` is the service step counter at detection; ``job_id`` names the
    job of a job-scoped fault (quarantine), ``group`` the batching group of
    a group-scoped one (chunk errors, stragglers); ``detail`` holds
    kind-specific fields.
    """

    kind: str
    step: int
    job_id: str | None = None
    group: str | None = None
    detail: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry-and-backoff for failed group chunks.

    A failed chunk re-runs from the last committed boundary, bitwise the
    chunk an un-faulted run makes. ``max_retries`` bounds the re-runs per
    chunk; retry ``k`` sleeps ``backoff_s * multiplier**(k-1)`` first (0
    disables sleeping).
    """

    max_retries: int = 2
    backoff_s: float = 0.05
    multiplier: float = 2.0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_s < 0:
            raise ValueError("backoff_s must be >= 0")

    def delay(self, attempt: int) -> float:
        """Seconds to back off before retry number ``attempt`` (1-based)."""
        return self.backoff_s * self.multiplier ** (attempt - 1)


def group_label(key: tuple) -> str:
    """A short stable label for a batching-group key."""
    fam, n, d, k = key[0][0], key[1], key[2], key[3]
    return f"{fam}-n{n}-d{d}-K{k}"
