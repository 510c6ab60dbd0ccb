"""Deterministic fault-injection harness for the sampling service.

Port of :mod:`repro.testing.chaos`. The serve stack's recovery rests on one
fact: chunks are bitwise replayable (per-iteration keys derive from the
states' own iteration counters), so exact recovery is always available —
re-run from the last committed boundary and the run IS on the fault-free
trajectory. This module makes that an executable check. A seeded
:func:`schedule` places faults at service-step boundaries;
:class:`ChaosHarness` injects them through the runtime's own seams (the
engines' chunk path, the lane dicts, the checkpointer's write hook, the
service clock); :func:`run_schedule` drives a whole service run under the
schedule and verifies, job by job:

  * every **surviving** job's results are bitwise a fault-free service
    run's (which ``tests/test_torch_serve.py`` pins bitwise to the solo
    ``api.sample`` run);
  * every **quarantined/failed** job holds a bitwise *clean prefix* of its
    fault-free trajectory;
  * a job that retires twice (a crash rewound it to a checkpoint and it
    replayed) produced **identical results both times**;
  * **no corrupt checkpoint is ever restored silently**: every restart
    after checkpoint corruption lands on an older intact step with a
    ``checkpoint_fallback`` fault event, or refuses loudly.

Faults injected (kind → mechanism):

=================  =======================================================
chunk_error        arm a group's ``run_chunk`` to raise once → the
                   service's bounded retry replays the chunk
nan_theta          overwrite one running job's θ with NaN in its lane
nan_data           write NaN into one float of one job's dataset (a copy in
                   its lane)
device_loss        ``handle_device_loss(0 or 1)``; recovery is scheduled
                   two steps later
straggle           slow one group's fake wall clock 10× → StragglerMonitor
                   escalation
kill_<point>       arm the checkpointer's kill hook and force a save; the
                   simulated process death is followed by a cold restart
                   from disk (sweep recovery + verified restore)
ckpt_bitflip       flip one bit of one leaf file of the newest checkpoint,
                   then cold-restart
ckpt_truncate      truncate a leaf file of the newest checkpoint, then
                   cold-restart
ckpt_torn          truncate ``manifest.json`` mid-byte (a torn write),
                   then cold-restart
=================  =======================================================

Everything is seeded and host-deterministic: ``random.Random(seed)`` picks
kinds, steps and targets; the fake clock replaces wall time; backoff sleeps
are disabled. The jobs' chains run on ``device`` (the card by default).
From the command line::

    python -m repro_torch.testing.chaos --seeds 0 1 2 3
    python -m repro_torch.testing.chaos --device cpu --seeds 2 3
"""

from __future__ import annotations

import dataclasses
import random
import tempfile

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import logistic_data, softmax_data
from repro_torch.serve import Job, RetryPolicy, Service, TerminationPolicy
from repro_torch.serve import faults as faults_lib
from repro_torch.serve.results import JobResult


class InjectedKill(BaseException):
    """Simulated process death at a checkpoint kill point. A BaseException
    on purpose: nothing in the runtime may ``except Exception`` it away — a
    dead process cannot be retried in line, only restarted from disk."""

    def __init__(self, point: str):
        super().__init__(f"injected kill at checkpoint point {point!r}")
        self.point = point


class ChaosError(RuntimeError):
    """The injected chunk failure (stands in for a failed launch, a lost
    device, an out-of-memory error: anything transient)."""


# Checkpoint-corruption kinds and the checkpointer's kill points.
_CKPT_KINDS = ("ckpt_bitflip", "ckpt_truncate", "ckpt_torn")
_KILL_POINTS = ("begin", "leaves_written", "manifest_written",
                "pre_rename", "renamed")

ALL_KINDS = (
    "chunk_error", "nan_theta", "nan_data", "device_loss", "straggle",
) + _CKPT_KINDS + tuple(f"kill_{p}" for p in _KILL_POINTS)


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled injection: fire ``kind`` just before harness step
    ``step``. ``arg`` is kind-specific (the device count for
    device_loss)."""

    kind: str
    step: int
    arg: int | None = None


def schedule(seed: int, *, n_steps: int = 12, n_faults: int = 5,
             kinds: tuple = ALL_KINDS) -> list[Fault]:
    """A deterministic fault schedule: ``n_faults`` draws over ``kinds``,
    placed at steps [2, n_steps) — steps 0 and 1 stay clean so that the
    first checkpoints exist before anything attacks them. Same seed, same
    schedule, field for field the reference's."""
    rng = random.Random(seed)
    out = []
    for _ in range(n_faults):
        kind = rng.choice(list(kinds))
        step = rng.randrange(2, max(3, n_steps))
        arg = rng.choice([0, 1]) if kind == "device_loss" else None
        out.append(Fault(kind=kind, step=step, arg=arg))
    return sorted(out, key=lambda f: f.step)


class ChaosHarness:
    """Instruments one live Service for fault injection.

    The seams are the runtime's own: ``Scheduler._engine_for`` is the one
    place engines are built (so every engine's ``run_chunk`` is wrapped,
    also engines born after a repack), ``Service._clock`` and
    ``Service._sleep`` virtualize time, and ``Checkpointer._kill_hook`` is
    the checkpointer's crash hook. Faults land between chunks, where real
    host-visible faults land.
    """

    def __init__(self, svc: Service, rng: random.Random):
        self.svc = svc
        self.rng = rng
        self._armed_errors: dict[str, int] = {}   # label -> raises pending
        self._slow: dict[str, float] = {}          # label -> time factor
        self._faketime = 0.0
        self.raised = 0          # armed chunk errors that actually raised
        self.poisoned: list[str] = []  # job ids NaN'd since the last drain
        svc._clock = lambda: self._faketime
        svc._sleep = lambda s: None  # no real sleeping under chaos
        orig = svc.scheduler._engine_for

        def patched(job, capacity=None, cand_capacity=None):
            eng = orig(job, capacity=capacity, cand_capacity=cand_capacity)
            self._instrument(eng)
            return eng

        svc.scheduler._engine_for = patched
        for eng in svc.scheduler.engines.values():
            self._instrument(eng)

    def _instrument(self, eng):
        if getattr(eng, "_chaos_wrapped", False):
            return
        label = faults_lib.group_label(eng.group_key)
        real = eng.run_chunk

        def wrapped(chunk_size):
            if self._armed_errors.get(label, 0) > 0:
                self._armed_errors[label] -= 1
                self._faketime += 0.01
                self.raised += 1
                raise ChaosError(f"injected chunk fault in {label}")
            out = real(chunk_size)
            self._faketime += 0.01 * self._slow.get(label, 1.0)
            return out

        eng.run_chunk = wrapped
        eng._chaos_wrapped = True

    # ------------------------------------------------------------- targeting

    def _live_labels(self) -> list[str]:
        return sorted(faults_lib.group_label(k)
                      for k in self.svc.scheduler.engines)

    def _running_jobs(self) -> list[str]:
        return sorted(
            j for eng in self.svc.scheduler.engines.values()
            for j in eng.job_ids
        )

    # ------------------------------------------------------------- injectors

    def fire(self, fault: Fault) -> bool:
        """Inject one fault; False when no valid target exists right now
        (e.g. a NaN fault with nothing running): the schedule then skips
        it, deterministically."""
        kind = fault.kind
        if kind == "chunk_error":
            labels = self._live_labels()
            if not labels:
                return False
            label = self.rng.choice(labels)
            self._armed_errors[label] = (
                self._armed_errors.get(label, 0) + 1
            )
            return True
        if kind in ("nan_theta", "nan_data"):
            jobs = self._running_jobs()
            if not jobs:
                return False
            return self.poison(self.rng.choice(jobs),
                               what="theta" if kind == "nan_theta" else "data")
        if kind == "straggle":
            labels = self._live_labels()
            if not labels:
                return False
            self._slow[self.rng.choice(labels)] = 10.0
            return True
        if kind == "device_loss":
            self.svc.handle_device_loss(int(fault.arg or 0))
            return True
        raise ValueError(f"harness cannot fire {kind!r} inline")

    def poison(self, job_id: str, what: str = "theta") -> bool:
        """NaN one job's lane on its device: its θ (every chain), or one
        feature of its dataset (written into a copy, so the Job's own
        tensor is untouched). Surgery on the engine's live lane dict —
        what a flaky memory bank or a bad host transfer would do to that
        lane and nothing else."""
        eng = self.svc.scheduler.engine_of(job_id)
        if eng is None:
            return False
        self.poisoned.append(job_id)
        lane = eng.lane_of(job_id)
        if what == "theta":
            st = lane["state"]
            lane["state"] = st._replace(sampler=st.sampler._replace(
                theta=torch.full_like(st.sampler.theta, float("nan"))))
        else:
            x = lane["data"].x.clone()
            x[0, 0] = float("nan")
            lane["data"] = lane["data"]._replace(x=x)
        return True

    def recover_devices(self, n_devices: int):
        self.svc.handle_device_loss(n_devices)


def corrupt_checkpoint(directory, kind: str, rng: random.Random) -> int | None:
    """Damage the NEWEST on-disk checkpoint the way the schedule asked:
    flip one random bit of one random leaf file, truncate a leaf, or tear
    the manifest. Returns the damaged step (None when there is nothing to
    damage yet)."""
    ckpt = Checkpointer(directory, keep=0)
    step = ckpt.latest_step()
    if step is None:
        return None
    cdir = ckpt.dir / f"step_{step:08d}"
    if kind == "ckpt_torn":
        raw = (cdir / "manifest.json").read_bytes()
        (cdir / "manifest.json").write_bytes(raw[: max(1, len(raw) // 2)])
        return step
    leaves = sorted(cdir.glob("leaf_*.npy"))
    target = leaves[rng.randrange(len(leaves))]
    raw = bytearray(target.read_bytes())
    if kind == "ckpt_truncate":
        target.write_bytes(bytes(raw[: max(1, len(raw) // 2)]))
    else:  # ckpt_bitflip — any single bit, anywhere in the file
        pos = rng.randrange(len(raw))
        raw[pos] ^= 1 << rng.randrange(8)
        target.write_bytes(bytes(raw))
    return step


# --------------------------------------------------------------------------
# the verified chaos run
# --------------------------------------------------------------------------


def _chaos_jobs(*, n: int, d: int, max_samples: int, num_warmup: int,
                device):
    """A small mixed tenant set: three batching groups (logistic K=1 ×2,
    logistic K=2, softmax K=1), so that group-scoped faults have
    neighbours to spare and the straggler median means something."""
    policy = TerminationPolicy(max_samples=max_samples)
    cap = max(16, n // 4)
    common = dict(capacity=cap, cand_capacity=cap, num_warmup=num_warmup,
                  policy=policy)
    key = lambda s: jr.key(s, device=device)
    jobs = []
    for i in range(2):
        jobs.append(Job(
            job_id=f"log1-{i}", family="logistic", seed=10 + i,
            data=logistic_data(key(100 + i), n=n, d=d, separation=1.5,
                               device=device),
            **common,
        ))
    jobs.append(Job(
        job_id="log2-0", family="logistic", seed=20, num_chains=2,
        data=logistic_data(key(200), n=n, d=d, separation=1.5,
                           device=device),
        **common,
    ))
    jobs.append(Job(
        job_id="soft-0", family="softmax", seed=30, n_classes=3,
        data=softmax_data(key(300), n=n, d=d, k=3, device=device),
        **common,
    ))
    return jobs


def _tree_equal(a, b) -> bool:
    """Bitwise equality of two results trees (tensors, arrays, host values;
    NaN equals NaN where both hold it, as a not-yet-defined R̂ does)."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_tree_equal(a[k], b[k]) for k in a))
    if isinstance(a, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_tree_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape
                and bool(torch.equal(a.cpu(), b.cpu())))
    if a is None or b is None:
        return a is None and b is None
    x, y = np.asarray(a), np.asarray(b)
    return (x.shape == y.shape and x.dtype == y.dtype
            and bool(np.array_equal(x, y, equal_nan=x.dtype.kind in "fc")))


def deliver(svc: Service, seen: dict) -> int:
    """Hand ``svc``'s retired results to the client, whose ``seen`` maps a
    job id to the result it received. A job that retires a second time (a
    crash rewound it past its first retirement) must reproduce its first
    result bitwise. Returns the number of such replays checked."""
    replays = 0
    for job_id, res in svc._results.items():
        first = seen.get(job_id)
        if first is not None and res is not first:
            assert (res.reason == first.reason
                    and res.committed == first.committed
                    and _tree_equal(res.results, first.results)), (
                f"replayed job {job_id} diverged from its first delivery")
            replays += 1
        seen[job_id] = res
    return replays


def resubmit(svc: Service, jobs, seen: dict) -> None:
    """After a restart the client resubmits each job that the checkpoint
    does not hold and that it has no result for (a job still queued at the
    save)."""
    for job in jobs:
        if job.job_id not in svc._jobs and job.job_id not in seen:
            svc.submit(job)


@dataclasses.dataclass
class ChaosReport:
    """One seed's verified outcome. ``fired``/``skipped`` partition the
    schedule; ``survivors`` matched the fault-free run bitwise,
    ``prefix_ok`` (quarantined/failed ids) matched as clean prefixes,
    ``lost`` retired inside a crashed step and were never delivered (an
    at-most-once delivery gap, counted, not hidden). ``events`` gathers
    every FaultEvent across restarts."""

    seed: int
    fired: list[Fault]
    skipped: list[Fault]
    survivors: list[str]
    prefix_ok: list[str]
    lost: list[str]
    restarts: int
    fallbacks: int
    events: list

    def summary(self) -> str:
        kinds = ",".join(f.kind for f in self.fired) or "-"
        return (f"seed={self.seed} fired=[{kinds}] "
                f"survivors={len(self.survivors)} "
                f"prefix_ok={len(self.prefix_ok)} lost={len(self.lost)} "
                f"restarts={self.restarts} fallbacks={self.fallbacks} "
                f"events={len(self.events)}")


def run_schedule(seed: int, *, n: int = 64, d: int = 3,
                 max_samples: int = 48, num_warmup: int = 8,
                 chunk_size: int = 16, checkpoint_every: int = 2,
                 directory=None, n_steps: int = 12, n_faults: int = 5,
                 kinds: tuple = ALL_KINDS, max_steps: int = 80,
                 slot_budget: int = 8, device="cuda") -> ChaosReport:
    """Run the tenant mix under ``schedule(seed)`` on ``device`` and verify
    the exactness contract under fire (module docstring). Raises
    AssertionError on any violation: a green return IS the chaos
    certificate for this seed."""
    jobs = _chaos_jobs(n=n, d=d, max_samples=max_samples,
                       num_warmup=num_warmup, device=device)

    # The fault-free reference: the same jobs, the same chunk size, no
    # faults, stepped by hand to learn its step count — the schedule is
    # clamped to it, else short runs would drain before any fault fires.
    ref_svc = Service(slot_budget=slot_budget, chunk_size=chunk_size,
                      device=device)
    for j in jobs:
        ref_svc.submit(j)
    ref_steps = 0
    while ref_svc.active():
        ref_svc.step()
        ref_steps += 1
        assert ref_steps <= max_steps, "fault-free reference did not drain"
    ref = dict(ref_svc._results)

    if directory is None:
        directory = tempfile.mkdtemp(prefix="chaos_ckpt_")
    rng = random.Random(seed)
    plan = schedule(seed, n_steps=min(n_steps, ref_steps + 1),
                    n_faults=n_faults, kinds=kinds)
    by_step: dict[int, list[Fault]] = {}
    for f in plan:
        by_step.setdefault(f.step, []).append(f)

    def fresh_service(restore: bool) -> Service:
        ckpt = Checkpointer(directory, keep=0)  # keep all: fallback depth
        kw = dict(chunk_size=chunk_size, checkpoint_every=checkpoint_every,
                  retry=RetryPolicy(max_retries=2, backoff_s=0.0),
                  straggler_threshold=4.0, device=device)
        if restore:
            return Service.restore(ckpt, **kw)
        return Service(slot_budget=slot_budget, checkpointer=ckpt, **kw)

    svc = fresh_service(restore=False)
    harness = ChaosHarness(svc, rng)
    for j in jobs:
        svc.submit(j)

    seen: dict[str, JobResult] = {}
    events: list = []
    fired: list[Fault] = []
    skipped: list[Fault] = []
    pending_recovery: dict[int, int] = {}  # step -> device count to restore
    pending_poison: set = set()  # NaN'd jobs awaiting the sentinel's verdict
    restarts = 0
    replays_checked = 0
    chunk_raised = 0  # injected chunk errors that raised, over all lives
    devices = (torch.cuda.device_count() if svc.device.type == "cuda"
               else 1)

    def collect():
        nonlocal replays_checked
        replays_checked += deliver(svc, seen)

    def cold_restart() -> bool:
        """Simulated process death: drop ALL in-memory state, come back
        from disk. False when no checkpoint survives (the service cannot
        restart; callers assert that the refusal was loud)."""
        nonlocal svc, harness, restarts, chunk_raised
        restarts += 1
        chunk_raised += harness.raised
        pending_poison.clear()  # in-memory poison dies with the process
        events.extend(svc.faults)
        ckpt_probe = Checkpointer(directory, keep=0)  # runs sweep recovery
        if ckpt_probe.latest_intact_step() is None:
            return False
        svc = fresh_service(restore=True)
        harness = ChaosHarness(svc, rng)
        return True

    step_i = 0
    while svc.active():
        assert step_i < max_steps, (
            f"chaos run (seed {seed}) did not drain in {max_steps} steps"
        )
        if step_i in pending_recovery:
            harness.recover_devices(pending_recovery.pop(step_i))
        for fault in by_step.get(step_i, ()):
            if fault.kind == "device_loss":
                harness.fire(fault)
                fired.append(fault)
                pending_recovery[step_i + 2] = max(1, devices)
            elif fault.kind.startswith("kill_"):
                point = fault.kind[len("kill_"):]
                ck = svc.checkpointer

                def hook(p, point=point):
                    if p == point:
                        raise InjectedKill(p)

                ck._kill_hook = hook
                try:
                    svc.checkpoint(blocking=True)
                except InjectedKill:
                    fired.append(fault)
                    if not cold_restart():
                        skipped.append(fault)  # nothing on disk yet
                        break
                else:
                    # The kill point was never reached (e.g. "parked"
                    # without a same-step re-save): the save completed.
                    ck._kill_hook = None
                    fired.append(fault)
            elif fault.kind in _CKPT_KINDS:
                svc.checkpointer.wait()
                if len(svc.checkpointer.all_steps()) < 2:
                    skipped.append(fault)  # nothing intact to fall back to
                    continue
                damaged = corrupt_checkpoint(directory, fault.kind, rng)
                fired.append(fault)
                collect()  # the client had these; a crash cannot unsend them
                ok = cold_restart()
                assert ok, "fallback restart failed with an intact step on disk"
                assert svc.restored_from_step != damaged, (
                    f"restore silently loaded corrupt step {damaged}"
                )
                assert any(e.kind == "checkpoint_fallback"
                           for e in svc.faults), (
                    "corrupt-step fallback emitted no checkpoint_fallback event"
                )
            else:
                (fired if harness.fire(fault) else skipped).append(fault)
                pending_poison.update(harness.poisoned)
                harness.poisoned.clear()
        try:
            svc.step()
        except InjectedKill:
            # A periodic checkpoint tripped a still-armed kill hook.
            if not cold_restart():
                raise AssertionError("no intact checkpoint after kill") from None
        collect()
        # Judge every pending poison now: its group ran a chunk this step,
        # so the sentinel quarantined it, or the job left the fleet first
        # (group failure, suspension), or the sentinel MISSED it — the bug
        # this harness exists to catch.
        for job_id in list(pending_poison):
            if any(e.kind == "nonfinite" and e.job_id == job_id
                   for e in svc.faults):
                pending_poison.discard(job_id)
            elif svc.scheduler.engine_of(job_id) is None:
                pending_poison.discard(job_id)  # retired/suspended first
            else:
                raise AssertionError(
                    f"sentinel missed NaN poison on running job {job_id}"
                )
        step_i += 1
    events.extend(svc.faults)

    # ---------------------------------------------------------- verification
    survivors, prefix_ok, lost = [], [], []
    for job in jobs:
        job_id = job.job_id
        res = seen.get(job_id)
        ref_res = ref[job_id]
        if res is None:
            lost.append(job_id)  # retired inside a crashed step, undelivered
            continue
        if res.reason in ("max_samples", "converged"):
            assert res.committed == ref_res.committed, (
                f"survivor {job_id}: committed {res.committed} != "
                f"fault-free {ref_res.committed}"
            )
            assert _tree_equal(res.results, ref_res.results), (
                f"survivor {job_id}: results differ from the fault-free run"
            )
            survivors.append(job_id)
        elif res.reason in ("quarantined", "failed"):
            assert res.committed <= ref_res.committed
            got = res.samples()
            want = ref_res.results["trace"]["theta"][:, : res.committed]
            assert torch.equal(got, want), (
                f"faulted job {job_id}: committed prefix is not bitwise the "
                f"fault-free prefix"
            )
            assert bool(torch.isfinite(got).all()), (
                f"faulted job {job_id}: NaN leaked into committed samples"
            )
            prefix_ok.append(job_id)
        else:
            raise AssertionError(
                f"job {job_id} retired with unexpected reason {res.reason!r}"
            )

    fallbacks = sum(1 for e in events if e.kind == "checkpoint_fallback")
    fired_ckpt = [f for f in fired if f.kind in _CKPT_KINDS]
    if fired_ckpt:
        assert fallbacks >= 1, (
            "checkpoint corruption fired but no fallback event was recorded"
        )
    chunk_raised += harness.raised
    if chunk_raised:
        assert any(e.kind == "chunk_error" for e in events), (
            "an injected chunk error raised but no chunk_error event "
            "was recorded"
        )
    return ChaosReport(
        seed=seed, fired=fired, skipped=skipped, survivors=survivors,
        prefix_ok=prefix_ok, lost=lost, restarts=restarts,
        fallbacks=fallbacks, events=events,
    )


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--max-samples", type=int, default=48)
    ap.add_argument("--chunk-size", type=int, default=16)
    ap.add_argument("--n-faults", type=int, default=5)
    ap.add_argument("--checkpoint-every", type=int, default=2,
                    help="service checkpoint cadence; 1 gives short runs "
                         "enough on-disk steps for the ckpt_* faults to fire")
    ap.add_argument("--kinds", nargs="+", default=None, metavar="KIND",
                    help="restrict the schedule to these fault kinds "
                         f"(default: all of {', '.join(ALL_KINDS)})")
    ap.add_argument("--device", default="cuda",
                    help="where the jobs' chains run (cpu: the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)
    kinds = tuple(args.kinds) if args.kinds else ALL_KINDS
    unknown = set(kinds) - set(ALL_KINDS)
    if unknown:
        ap.error(f"unknown fault kinds: {sorted(unknown)}")
    for seed in args.seeds:
        report = run_schedule(
            seed, n=args.n, max_samples=args.max_samples,
            chunk_size=args.chunk_size, n_faults=args.n_faults,
            checkpoint_every=args.checkpoint_every, kinds=kinds,
            device=args.device,
        )
        print("OK", report.summary())
    print(f"chaos suite green: {len(args.seeds)} seeds")


if __name__ == "__main__":
    main()
