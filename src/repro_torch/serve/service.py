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
    4. the straggler check, then, every ``checkpoint_every`` steps, a
       checkpoint.

**Checkpoint and restore.** :meth:`checkpoint` saves every admitted job's
lane (chain states with their iteration counters, chain keys, dataset,
sufficient statistics, collector carries and the folded count) through
:class:`repro_torch.checkpoint.Checkpointer`, one atomic step directory,
with the job registry (hyperparameters, policies, collector configs,
progress) in the manifest's ``extra``. :meth:`Service.restore` reads the
manifest first, rebuilds the jobs, builds the restore target with
:meth:`GroupEngine.build_lane` on placeholder data (every value is then
overwritten) and suspends each job with its restored lane; the first step
re-admits it through ``admit_restored``. A restored job continues its solo
trajectory bitwise: its keys come from the restored iteration counters.

**Faults** (see :mod:`repro_torch.serve.faults`). A raising group chunk is
re-run from the last committed boundary under a bounded
:class:`~repro_torch.serve.faults.RetryPolicy`: exact, since ``run_chunk``
is transactional and the keys come from the states. Exhausted retries
retire the group's jobs FAILED with their clean committed prefixes. Lanes
the health sentinel quarantines retire FAILED ("quarantined"); their
neighbours never notice. Chunk wall times feed a
:class:`~repro_torch.launch.elastic.StragglerMonitor`; ``straggler_threshold``
opts into escalation.

**Device loss.** :meth:`handle_device_loss` checkpoints (with a
checkpointer), shrinks the slot budget to the surviving devices, suspends
newest-first until occupancy fits and repacks; zero devices is legal.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.api import collectors as collectors_lib
from repro_torch.core.bounds import GLMData
from repro_torch.device import resolve_device
from repro_torch.launch import elastic
from repro_torch.serve import faults as faults_lib
from repro_torch.serve import job as job_lib
from repro_torch.serve.engine import GroupEngine, finalize_lane_with
from repro_torch.serve.faults import FaultEvent, RetryPolicy
from repro_torch.serve.results import JobHandle, JobResult, JobStatus, StreamUpdate
from repro_torch.serve.scheduler import Scheduler

_JOB_META_FIELDS = (
    "job_id", "family", "seed", "num_chains", "prior_scale", "xi",
    "n_classes", "nu", "sigma", "kernel", "step_size", "q_db", "mode",
    "resample_fraction", "capacity", "cand_capacity", "backend",
    "z_backend", "adapt_target", "num_warmup",
)


def _collector_specs(colls: dict) -> list:
    """JSON-able (name, class, config) triples: the checkpointable subset.
    Dataclass fields must be plain values; a collector holding a tensor or
    a callable (``PosteriorPredictive``) cannot ride in a manifest."""
    out = []
    for name in sorted(colls):
        col = colls[name]
        fields = {}
        if dataclasses.is_dataclass(col):
            for f in dataclasses.fields(col):
                v = getattr(col, f.name)
                if callable(v) or hasattr(v, "shape"):
                    raise ValueError(
                        f"collector {name!r} ({type(col).__name__}) holds a "
                        f"{'callable' if callable(v) else 'tensor'} field "
                        f"{f.name!r} and cannot be checkpointed; drop it or "
                        f"run the job without service checkpointing"
                    )
                fields[f.name] = v
        out.append([name, type(col).__name__, fields])
    return out


def _collectors_from_specs(specs: list) -> dict:
    return {name: getattr(collectors_lib, cls)(**fields)
            for name, cls, fields in specs}


class Service:
    def __init__(self, slot_budget: int | None = None, chunk_size: int = 64,
                 lane_backend: str = "map", checkpointer=None,
                 checkpoint_every: int | None = None,
                 retry: RetryPolicy | None = None,
                 straggler_threshold: float | None = None, device="cuda"):
        """``device`` is where the jobs' data and chains live (default the
        card; raises without one unless ``device="cpu"``). The default slot
        budget is ``plan_chain_slots`` of the visible cards, or of one
        device on the CPU. ``checkpointer`` (a
        :class:`~repro_torch.checkpoint.Checkpointer`) enables
        :meth:`checkpoint`, and ``checkpoint_every`` saves every that many
        steps. ``retry`` bounds the per-chunk retry-and-backoff;
        ``straggler_threshold`` opts into straggler escalation (chunk wall
        times are always recorded)."""
        self.device = resolve_device(device)
        if checkpoint_every is not None and checkpointer is None:
            raise ValueError("checkpoint_every needs a checkpointer")
        if slot_budget is None:
            n = (torch.cuda.device_count() if self.device.type == "cuda"
                 else 1)
            slot_budget = elastic.plan_chain_slots(n)
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        self.chunk_size = int(chunk_size)
        self.scheduler = Scheduler(slot_budget, lane_backend=lane_backend)
        self.checkpointer = checkpointer
        self.checkpoint_every = checkpoint_every
        self.retry = retry if retry is not None else RetryPolicy()
        self.straggler_threshold = straggler_threshold
        self.faults: list[FaultEvent] = []
        self.monitor = elastic.StragglerMonitor(
            threshold=(straggler_threshold if straggler_threshold is not None
                       else 1.5)
        )
        self._flagged: set[str] = set()
        self.restored_from_step = None  # set by Service.restore
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
        quarantine sweep → termination → straggler check → (maybe)
        checkpoint. Returns this boundary's StreamUpdates interleaved with
        any FaultEvents."""
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
        if (self.checkpoint_every
                and self._step_count % self.checkpoint_every == 0
                and (self.scheduler.engines or self.scheduler.suspended)):
            self.checkpoint()
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
        """One atomic checkpoint of every admitted (running or suspended)
        job: its lane's tensors and host values as leaves, the job registry
        and progress in the manifest's ``extra``. Queued jobs are not state
        yet: clients resubmit them after a restart. The lanes are copied to
        the host before this returns (on the card, that waits for the
        stream), so the next chunk cannot change what is written."""
        if self.checkpointer is None:
            raise ValueError("service has no checkpointer")
        tree, jobs_meta = {}, {}
        for eng in self.scheduler.engines.values():
            for job_id in eng.job_ids:
                tree[job_id] = eng.lane_of(job_id)
                jobs_meta[job_id] = self._job_meta(
                    self._jobs[job_id], (eng.capacity, eng.cand_capacity))
        for job_id, (job, lane, caps) in self.scheduler.suspended.items():
            tree[job_id] = lane
            jobs_meta[job_id] = self._job_meta(job, caps)
        self.checkpointer.save(
            self._step_count, tree,
            extra_metadata={"serve": {
                "jobs": jobs_meta,
                "slot_budget": self.scheduler.slot_budget,
                "chunk_size": self.chunk_size,
                "step_count": self._step_count,
            }},
            blocking=blocking,
        )

    def _job_meta(self, job: job_lib.Job, caps: tuple) -> dict:
        meta = {f: getattr(job, f) for f in _JOB_META_FIELDS}
        meta["policy"] = dataclasses.asdict(job.policy)
        meta["collectors"] = _collector_specs(job.collectors)
        meta["group_caps"] = list(caps)
        meta["chunks"] = self._chunks[job.job_id]
        meta["stream"] = list(self._stream[job.job_id])
        return meta

    @classmethod
    def restore(cls, checkpointer, step: int | None = None,
                slot_budget: int | None = None, chunk_size: int | None = None,
                lane_backend: str = "map", checkpoint_every=None,
                verify: bool = True, retry: RetryPolicy | None = None,
                straggler_threshold: float | None = None, device="cuda"):
        """Rebuild a service from a checkpoint, on ``device``; every
        restored job resumes its exact chain. Restored jobs enter SUSPENDED
        and repack on the first :meth:`step`.

        With ``verify`` (the default) corrupt state is never loaded
        silently: an explicitly requested corrupt ``step`` raises
        :class:`repro_torch.checkpoint.CheckpointCorruptError`; with
        ``step=None`` the newest step that passes verification is loaded,
        and skipped corrupt steps are reported as a ``checkpoint_fallback``
        :class:`FaultEvent` on ``svc.faults``."""
        man = checkpointer.manifest(step, verify=verify)
        skipped = list(checkpointer.last_skipped)
        step = man["step"]  # pin the verified choice for the leaf restore
        serve = man["extra"]["serve"]
        svc = cls(
            slot_budget=(serve["slot_budget"] if slot_budget is None
                         else slot_budget),
            chunk_size=(serve["chunk_size"] if chunk_size is None
                        else chunk_size),
            lane_backend=lane_backend, checkpointer=checkpointer,
            checkpoint_every=checkpoint_every, retry=retry,
            straggler_threshold=straggler_threshold, device=device,
        )
        svc._step_count = serve["step_count"]
        svc.restored_from_step = step
        if skipped:
            svc._fault("checkpoint_fallback",
                       detail={"loaded_step": step, "skipped_steps": skipped})
        # The restore target comes from the engines' own lane code, on
        # placeholder jobs with zero datasets of the saved shapes, at the
        # saved states' capacity; Checkpointer.restore then overwrites
        # every value and checks every shape.
        leaf_shapes = {m["path"]: (tuple(m["shape"]), m["dtype"])
                       for m in man["leaves"]}
        target, jobs, caps_of = {}, {}, {}
        for job_id, meta in serve["jobs"].items():
            job = job_lib.Job(
                data=_placeholder_data(job_id, leaf_shapes, svc.device),
                policy=job_lib.TerminationPolicy(**meta["policy"]),
                collectors=_collectors_from_specs(meta["collectors"]),
                **{f: meta[f] for f in _JOB_META_FIELDS},
            )
            aux = leaf_shapes[f"[{job_id!r}]['state'].sampler.aux"][0]
            skeleton = GroupEngine(job, capacity=aux[-1],
                                   cand_capacity=meta["group_caps"][1])
            target[job_id], _ = skeleton.build_lane(job)
            jobs[job_id] = job
            caps_of[job_id] = tuple(meta["group_caps"])
        restored, _ = checkpointer.restore(target, step, verify=verify)
        for job_id, meta in serve["jobs"].items():
            lane = restored[job_id]
            job = dataclasses.replace(jobs[job_id], data=lane["data"])
            svc._jobs[job_id] = job
            svc._status[job_id] = JobStatus.SUSPENDED
            svc._chunks[job_id] = meta["chunks"]
            svc._stream[job_id] = tuple(meta["stream"])
            svc.scheduler.suspended[job_id] = (job, lane, caps_of[job_id])
        return svc

    # --------------------------------------------------------- device loss

    def handle_device_loss(self, n_devices: int,
                           slots_per_device: int = 8) -> list[str]:
        """The elastic response: checkpoint (with a checkpointer), shrink
        the slot budget to the surviving devices, suspend newest-first until
        occupancy fits, repack what fits. Returns the ids the shrink
        suspended. ``n_devices=0`` is legal: every job suspends with its
        committed work, and a later call with surviving devices repacks
        them."""
        budget = elastic.plan_chain_slots(n_devices, slots_per_device)
        if self.checkpointer is not None:
            self.checkpoint()
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


def _placeholder_data(job_id: str, leaf_shapes: dict, device) -> GLMData:
    """Zeros GLMData with the checkpointed lane's shapes and dtypes: enough
    structure to rebuild the Job and the restore target."""
    leaves = {}
    for field in GLMData._fields:
        path = f"[{job_id!r}]['data'].{field}"
        if path not in leaf_shapes:
            raise KeyError(f"checkpoint missing {path}")
        shape, dtype = leaf_shapes[path]
        leaves[field] = torch.zeros(shape, dtype=getattr(torch, dtype),
                                    device=device)
    return GLMData(**leaves)
