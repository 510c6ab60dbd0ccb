"""The always-on posterior-sampling service.

Port of :mod:`repro.serve.service`. Clients :meth:`~Service.submit`
:class:`~repro_torch.serve.job.Job`\\ s and get
:class:`~repro_torch.serve.results.JobHandle`\\ s back; :meth:`~Service.step`
advances every batching group one chunk (jobs join and leave between
chunks); :meth:`~Service.run` loops until the work drains. A step:

    1. admission — the scheduler packs suspended and queued jobs into group
       engines, FIFO with head-of-line skip, under the chain-slot budget;
    2. one supervised :meth:`GroupEngine.run_chunk` per engine;
    3. the quarantine sweep, then termination: ``max_samples`` always, and
       peeked split-R̂ / batch-means ESS once ``min_samples`` committed,
       throttled by ``check_every``. Retiring jobs are finalized into
       :class:`~repro_torch.serve.results.JobResult`\\ s, bitwise the solo
       ``api.sample`` run's results;
    4. the straggler check.

**Faults** (see :mod:`repro_torch.serve.faults`). A raising group chunk is
re-run from the last committed boundary under a bounded
:class:`~repro_torch.serve.faults.RetryPolicy`: exact, since ``run_chunk``
is transactional and the keys come from the states. Exhausted retries
retire the group's jobs FAILED with their clean committed prefixes. Lanes
the health sentinel quarantines retire FAILED ("quarantined"); their
neighbours never notice. Chunk wall times feed a
:class:`~repro_torch.launch.elastic.StragglerMonitor`; ``straggler_threshold``
opts into escalation.

**Device loss.** :meth:`handle_device_loss` shrinks the slot budget to the
surviving devices, suspends newest-first until occupancy fits and repacks;
zero devices is legal.

**Not ported here:** checkpoint and restore. ``checkpointer=`` and
``checkpoint_every=``, :meth:`Service.checkpoint` and :meth:`Service.restore`
raise until the checkpointing slice (ROADMAP queue 1, item 6), and
:meth:`handle_device_loss` runs the reference's branch without a
checkpointer.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch import elastic
from repro_torch.serve import faults as faults_lib
from repro_torch.serve import job as job_lib
from repro_torch.serve.engine import GroupEngine, finalize_lane_with
from repro_torch.serve.faults import FaultEvent, RetryPolicy
from repro_torch.serve.results import JobHandle, JobResult, JobStatus, StreamUpdate
from repro_torch.serve.scheduler import Scheduler

_NO_CHECKPOINT = (
    "service checkpoint and restore come with the port of "
    "checkpoint/checkpointer.py (ROADMAP queue 1, item 6)"
)


class Service:
    def __init__(self, slot_budget: int | None = None, chunk_size: int = 64,
                 lane_backend: str = "map", checkpointer=None,
                 checkpoint_every: int | None = None,
                 retry: RetryPolicy | None = None,
                 straggler_threshold: float | None = None, device="cuda"):
        """``device`` is where the jobs' data and chains live (default the
        card; raises without one unless ``device="cpu"``). The default slot
        budget is ``plan_chain_slots`` of the visible cards, or of one
        device on the CPU. ``retry`` bounds the per-chunk retry-and-backoff;
        ``straggler_threshold`` opts into straggler escalation (chunk wall
        times are always recorded)."""
        self.device = resolve_device(device)
        if checkpointer is not None or checkpoint_every is not None:
            raise NotImplementedError(_NO_CHECKPOINT)
        if slot_budget is None:
            n = (torch.cuda.device_count() if self.device.type == "cuda"
                 else 1)
            slot_budget = elastic.plan_chain_slots(n)
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        self.chunk_size = int(chunk_size)
        self.scheduler = Scheduler(slot_budget, lane_backend=lane_backend)
        self.retry = retry if retry is not None else RetryPolicy()
        self.straggler_threshold = straggler_threshold
        self.faults: list[FaultEvent] = []
        self.monitor = elastic.StragglerMonitor(
            threshold=(straggler_threshold if straggler_threshold is not None
                       else 1.5)
        )
        self._flagged: set[str] = set()
        # Test seams: the wall clock and the backoff sleep.
        self._clock = time.monotonic
        self._sleep = time.sleep
        self._jobs: dict[str, job_lib.Job] = {}
        self._status: dict[str, JobStatus] = {}
        self._results: dict[str, JobResult] = {}
        self._chunks: dict[str, int] = {}   # chunks run, for check_every
        self._stream: dict[str, tuple] = {}  # subscribed peek names
        self._step_count = 0

    # ---------------------------------------------------------------- submit

    def submit(self, job: job_lib.Job, stream: tuple = ()) -> JobHandle:
        """Queue a job; it joins a group at the next chunk boundary.
        ``stream`` names collectors to peek into every StreamUpdate."""
        if job.job_id in self._jobs:
            raise ValueError(f"job id {job.job_id!r} already submitted")
        if job.device != self.device:
            raise ValueError(f"job {job.job_id!r} has its data on "
                             f"{job.device}; the service runs on {self.device}")
        if job.num_chains > self.scheduler.slot_budget:
            raise ValueError(
                f"job {job.job_id!r} needs {job.num_chains} chain slots; "
                f"the service budget is {self.scheduler.slot_budget}"
            )
        unknown = set(stream) - set(job.collectors)
        if unknown:
            raise ValueError(f"stream names {sorted(unknown)} are not "
                             f"collectors of job {job.job_id!r}")
        self._jobs[job.job_id] = job
        self._status[job.job_id] = JobStatus.QUEUED
        self._chunks[job.job_id] = 0
        self._stream[job.job_id] = tuple(stream)
        self.scheduler.enqueue(job)
        return JobHandle(self, job.job_id)

    # --------------------------------------------------------------- queries

    def status(self, job_id: str) -> JobStatus:
        return self._status[job_id]

    def committed(self, job_id: str) -> int:
        st = self._status[job_id]
        if st is JobStatus.RUNNING:
            return self.scheduler.engine_of(job_id).committed(job_id)
        if st is JobStatus.SUSPENDED:
            return self.scheduler.suspended[job_id][1]["count"]
        if st in (JobStatus.DONE, JobStatus.CANCELLED, JobStatus.FAILED):
            return self._results[job_id].committed
        return 0

    def peek(self, job_id: str, name: str):
        if self._status[job_id] is not JobStatus.RUNNING:
            raise ValueError(f"job {job_id!r} is not running "
                             f"({self._status[job_id].value})")
        return self.scheduler.engine_of(job_id).peek(job_id, name)

    def result(self, job_id: str) -> JobResult | None:
        return self._results.get(job_id)

    def active(self) -> bool:
        return any(
            s in (JobStatus.QUEUED, JobStatus.RUNNING, JobStatus.SUSPENDED)
            for s in self._status.values()
        )

    # ---------------------------------------------------------------- cancel

    def cancel(self, job_id: str) -> bool:
        """Stop a job at the current boundary; its committed prefix is
        finalized. Safe in any state; False once retired."""
        st = self._status[job_id]
        job = self._jobs[job_id]
        if st is JobStatus.QUEUED:
            self.scheduler.queue = [
                j for j in self.scheduler.queue if j.job_id != job_id
            ]
            self._retire(job_id, {}, 0, "cancelled")
            return True
        if st is JobStatus.RUNNING:
            eng, lane = self.scheduler.evict(job_id)
            self._retire(job_id, eng.finalize_lane(lane), lane["count"],
                         "cancelled")
            return True
        if st is JobStatus.SUSPENDED:
            _, lane, _ = self.scheduler.suspended.pop(job_id)
            self._retire(job_id, finalize_lane_with(job.collectors, lane),
                         lane["count"], "cancelled")
            return True
        return False

    def _retire(self, job_id: str, results: dict, committed: int,
                reason: str):
        self._results[job_id] = JobResult(
            job_id=job_id, results=results, committed=committed,
            reason=reason,
        )
        if reason == "cancelled":
            self._status[job_id] = JobStatus.CANCELLED
        elif reason in ("quarantined", "failed"):
            self._status[job_id] = JobStatus.FAILED
        else:
            self._status[job_id] = JobStatus.DONE

    # ------------------------------------------------------------ scheduling

    def _stop_reason(self, job: job_lib.Job, eng: GroupEngine,
                     committed: int):
        """(reason | None, peeks taken): the TerminationPolicy check."""
        p = job.policy
        if committed >= p.max_samples:
            return "max_samples", {}
        if p.target_rhat is None and p.min_ess is None:
            return None, {}
        if committed < max(p.min_samples, 1):
            return None, {}
        if self._chunks[job.job_id] % p.check_every:
            return None, {}
        peeks, ok = {}, True
        if p.target_rhat is not None:
            r = peeks["rhat"] = eng.peek(job.job_id, "rhat")
            ok = ok and (r["r_hat"] <= p.target_rhat)
        if p.min_ess is not None:
            e = peeks["ess"] = eng.peek(job.job_id, "ess")
            ess = np.asarray(e["ess"], dtype=np.float64)
            total = float(np.nansum(ess)) if np.isfinite(ess).any() else 0.0
            ok = ok and (total >= p.min_ess)
        return ("converged" if ok else None), peeks

    def _fault(self, kind: str, **kw) -> FaultEvent:
        ev = FaultEvent(kind=kind, step=self._step_count, **kw)
        self.faults.append(ev)
        return ev

    def _supervised_chunk(self, eng: GroupEngine, label: str,
                          updates: list) -> bool:
        """One group chunk under the retry policy; a retry re-enters from
        the last committed boundary and replays the same chunk bitwise.
        False when retries are exhausted."""
        attempt = 0
        while True:
            t0 = self._clock()
            try:
                eng.run_chunk(self.chunk_size)
            except Exception as e:
                attempt += 1
                retrying = attempt <= self.retry.max_retries
                updates.append(self._fault(
                    "chunk_error", group=label,
                    detail={"error": repr(e), "attempt": attempt,
                            "retrying": retrying},
                ))
                if not retrying:
                    return False
                if self.retry.backoff_s:
                    self._sleep(self.retry.delay(attempt))
                continue
            self.monitor.record(label, self._clock() - t0)
            return True

    def _fail_group(self, eng: GroupEngine, label: str, updates: list):
        """Retries exhausted: retire every member FAILED with its clean
        committed prefix. Retiring, not suspending, bounds the blast radius:
        a suspended job would be re-admitted and loop on a persistent
        fault."""
        members = list(eng.job_ids)
        updates.append(self._fault(
            "group_failed", group=label,
            detail={"jobs": members, "retries": self.retry.max_retries},
        ))
        for job_id in members:
            _, lane = self.scheduler.evict(job_id)
            self._retire(job_id, eng.finalize_lane(lane), lane["count"],
                         "failed")
            updates.append(StreamUpdate(
                job_id=job_id, committed=lane["count"], peeks={},
                done=True, reason="failed",
            ))

    def step(self) -> list:
        """One service round: admit → chunk every group (supervised) →
        quarantine sweep → termination → straggler check. Returns this
        boundary's StreamUpdates interleaved with any FaultEvents."""
        for job_id in self.scheduler.admit_pending():
            self._status[job_id] = JobStatus.RUNNING
        updates = []
        for eng in list(self.scheduler.engines.values()):
            label = faults_lib.group_label(eng.group_key)
            if not self._supervised_chunk(eng, label, updates):
                self._fail_group(eng, label, updates)
                continue
            for job_id in eng.job_ids:
                self._chunks[job_id] += 1
            # Quarantine sweep before termination, so a poisoned lane can
            # neither "finish" nor be peeked at.
            for job_id in eng.take_quarantined():
                _, lane = self.scheduler.evict(job_id)
                self._retire(job_id, eng.finalize_lane(lane), lane["count"],
                             "quarantined")
                updates.append(self._fault(
                    "nonfinite", job_id=job_id, group=label,
                    detail={"response": "lane quarantined",
                            "committed": lane["count"]},
                ))
                updates.append(StreamUpdate(
                    job_id=job_id, committed=lane["count"], peeks={},
                    done=True, reason="quarantined",
                ))
            for job_id in list(eng.job_ids):
                job = self._jobs[job_id]
                committed = eng.committed(job_id)
                reason, peeks = self._stop_reason(job, eng, committed)
                for name in self._stream[job_id]:
                    if name not in peeks:
                        peeks[name] = eng.peek(job_id, name)
                if reason is not None:
                    _, lane = self.scheduler.evict(job_id)
                    self._retire(job_id, eng.finalize_lane(lane),
                                 committed, reason)
                updates.append(StreamUpdate(
                    job_id=job_id, committed=committed, peeks=peeks,
                    done=reason is not None, reason=reason,
                ))
        if self.straggler_threshold is not None:
            lagging = set(self.monitor.stragglers())
            for label in sorted(lagging - self._flagged):
                updates.append(self._fault(
                    "straggler", group=label,
                    detail={"ewma_s": self.monitor.ewma[label],
                            "threshold": self.monitor.threshold},
                ))
            self._flagged = lagging  # a group that catches up may re-flag
        self._step_count += 1
        return updates

    def run(self, on_update=None, max_steps: int | None = None) -> dict:
        """Step until every submitted job retires; returns ``{job_id:
        JobResult}``. ``on_update`` sees every StreamUpdate and FaultEvent
        in boundary order."""
        steps = 0
        while self.active():
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(f"run() did not drain in {max_steps} steps")
            before = self._progress_mark()
            for u in self.step():
                if on_update is not None:
                    on_update(u)
            steps += 1
            if not self.scheduler.engines and self._progress_mark() == before:
                raise RuntimeError(
                    "service stalled: queued/suspended jobs cannot fit the "
                    f"slot budget ({self.scheduler.slot_budget})"
                )
        return dict(self._results)

    def _progress_mark(self):
        return (len(self._results), len(self.scheduler.queue),
                len(self.scheduler.suspended), len(self.scheduler.engines))

    # ------------------------------------------------------------ checkpoint

    def checkpoint(self, blocking: bool = True):
        raise NotImplementedError(_NO_CHECKPOINT)

    @classmethod
    def restore(cls, checkpointer, *args, **kwargs):
        raise NotImplementedError(_NO_CHECKPOINT)

    # --------------------------------------------------------- device loss

    def handle_device_loss(self, n_devices: int,
                           slots_per_device: int = 8) -> list[str]:
        """The elastic response: shrink the slot budget to the surviving
        devices, suspend newest-first until occupancy fits, repack what
        fits. Returns the ids the shrink suspended. ``n_devices=0`` is
        legal: every job suspends with its committed work, and a later call
        with surviving devices repacks them."""
        budget = elastic.plan_chain_slots(n_devices, slots_per_device)
        suspended = self.scheduler.shrink_to_budget(budget)
        for job_id in suspended:
            self._status[job_id] = JobStatus.SUSPENDED
        admitted = []
        for job_id in self.scheduler.admit_pending():
            self._status[job_id] = JobStatus.RUNNING
            admitted.append(job_id)
        self._fault(
            "device_loss", detail={
                "n_devices": n_devices, "new_budget": budget,
                "suspended": suspended, "readmitted": admitted,
            },
        )
        return suspended
