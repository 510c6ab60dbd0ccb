"""Continuous-batching scheduler: jobs → group engines, under a slot budget.

Port of :mod:`repro.serve.scheduler`. It owns the packing decisions and
nothing else: engines do the math, the service the policy.

  * **One engine per live group key**; an engine exists while it has
    members.
  * **A slot budget in chains.** A job costs ``num_chains`` slots
    (:func:`repro_torch.launch.elastic.plan_chain_slots` turns devices into
    slots).
  * **FIFO with skip.** Admission scans the queue in arrival order and
    admits every job that fits the remaining budget: a wide job at the head
    does not block narrow ones behind it, and the head is first in line for
    freed slots.
  * **Suspended jobs outrank the queue.** A job suspended for capacity
    holds committed work; it is repacked first, through
    :meth:`GroupEngine.admit_restored`, and resumes its exact trajectory.

Packing never changes results (the engines' contract), so the scheduler is
free to be greedy.
"""

from __future__ import annotations

from repro_torch.serve import job as job_lib
from repro_torch.serve.engine import GroupEngine, check_lane_backend


class Scheduler:
    def __init__(self, slot_budget: int, lane_backend: str = "map"):
        if slot_budget < 1:
            raise ValueError("slot_budget must be >= 1")
        check_lane_backend(lane_backend)
        self.slot_budget = slot_budget
        self.lane_backend = lane_backend
        self.engines: dict[tuple, GroupEngine] = {}  # group_key -> engine
        self.queue: list[job_lib.Job] = []           # arrival order
        # job_id -> (job, lane, (capacity, cand_capacity)): awaiting repack
        self.suspended: dict[str, tuple] = {}

    # ------------------------------------------------------------- accounting

    @property
    def slots_used(self) -> int:
        return sum(e.num_slots for e in self.engines.values())

    @property
    def slots_free(self) -> int:
        return self.slot_budget - self.slots_used

    def engine_of(self, job_id: str) -> GroupEngine | None:
        for eng in self.engines.values():
            if job_id in eng.job_ids:
                return eng
        return None

    # -------------------------------------------------------------- admission

    def enqueue(self, job: job_lib.Job):
        self.queue.append(job)

    def _engine_for(self, job: job_lib.Job, capacity: int | None = None,
                    cand_capacity: int | None = None) -> GroupEngine:
        key = job_lib.group_key(job)
        eng = self.engines.get(key)
        if eng is None:
            eng = self.engines[key] = GroupEngine(
                job, capacity=capacity, cand_capacity=cand_capacity,
                lane_backend=self.lane_backend,
            )
        return eng

    def admit_pending(self) -> list[str]:
        """One admission round, between chunks: suspended jobs first, then
        the queue, FIFO with skip. Returns the admitted job ids."""
        admitted = []
        for job_id in list(self.suspended):
            job, lane, caps = self.suspended[job_id]
            if job.num_chains > self.slots_free:
                continue
            eng = self._engine_for(job, capacity=caps[0],
                                   cand_capacity=caps[1])
            eng.admit_restored(job, lane)
            del self.suspended[job_id]
            admitted.append(job_id)
        remaining = []
        for job in self.queue:
            if job.num_chains <= self.slots_free:
                self._engine_for(job).admit(job)
                admitted.append(job.job_id)
            else:
                remaining.append(job)
        self.queue = remaining
        return admitted

    # --------------------------------------------------------------- eviction

    def evict(self, job_id: str) -> tuple[GroupEngine, dict]:
        """Remove a running job; returns (engine, lane). Drops the engine
        when its last member leaves."""
        eng = self.engine_of(job_id)
        if eng is None:
            raise KeyError(f"job {job_id!r} is not running")
        lane = eng.evict(job_id)
        if not eng.job_ids:
            del self.engines[eng.group_key]
        return eng, lane

    def suspend(self, job_id: str):
        """Evict a running job but keep its lane for a later repack."""
        eng = self.engine_of(job_id)
        job = eng.job(job_id)
        caps = (eng.capacity, eng.cand_capacity)
        _, lane = self.evict(job_id)
        self.suspended[job_id] = (job, lane, caps)

    def shrink_to_budget(self, slot_budget: int) -> list[str]:
        """Apply a new budget; suspend newest-first (the newest member of
        the widest group) until occupancy fits. Returns the suspended ids."""
        self.slot_budget = int(slot_budget)
        out = []
        while self.slots_used > self.slot_budget:
            eng = max(self.engines.values(), key=lambda e: e.num_slots)
            victim = eng.job_ids[-1]
            self.suspend(victim)
            out.append(victim)
        return out
