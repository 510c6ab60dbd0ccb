"""Crash consistency of the port's sampling service, on the CPU.

Re-pins, inside the port, the checkpoint cases of ``tests/test_faults.py``
and ``tests/test_serve.py``: a crash at every checkpointer kill point
leaves an intact step, a kill while parked rolls back, an async write's
failure surfaces in ``wait``, total device loss with a checkpointer
resumes bitwise, ``Service.checkpoint`` → ``Service.restore`` → ``run`` is
bitwise the uninterrupted run, a corrupt newest step falls back with a
``checkpoint_fallback`` event (a pinned corrupt step raises), a
``PosteriorPredictive`` refuses checkpointing, and the seeded chaos
schedules of :mod:`repro_torch.testing.chaos` hold the exactness contract
(their schedules field for field the reference's). Each case that runs a
service runs on both engine pairs: the plain engines and the kernel
engines (whose wrappers run their plain versions on the CPU).
"""

import dataclasses
import random

import pytest
import torch

from repro.testing import chaos as ref_chaos
from repro_torch import random as jr
from repro_torch.api import FullTrace, PosteriorPredictive, RHat
from repro_torch.checkpoint import CheckpointCorruptError, Checkpointer
from repro_torch.checkpoint.checkpointer import flatten_with_paths
from repro_torch.data import logistic_data
from repro_torch.serve import Job, JobStatus, Service, TerminationPolicy
from repro_torch.testing import chaos

torch.set_num_threads(1)

CPU = "cpu"
CHUNK = 8
MAX = 32
N, D = 64, 3
WARM = 8
CAP = 16
ENGINES = {"plain": dict(backend="jnp", z_backend="jnp"),
           "kernels": dict(backend="pallas", z_backend="fused")}


@pytest.fixture(params=list(ENGINES))
def engine(request):
    return request.param


def _job(i, engine="kernels", **kw):
    return Job(
        job_id=f"j{i}", family="logistic", seed=5 + i,
        data=logistic_data(jr.key(40 + i, device=CPU), n=N, d=D,
                           separation=1.5, device=CPU),
        capacity=CAP, cand_capacity=CAP, num_warmup=WARM,
        policy=TerminationPolicy(max_samples=MAX), **ENGINES[engine], **kw,
    )


def _jobs(engine):
    """Two groups: a one-chain pair and a two-chain job."""
    return [_job(0, engine), _job(1, engine), _job(2, engine, num_chains=2)]


def _service(**kw):
    kw.setdefault("slot_budget", 8)
    kw.setdefault("chunk_size", CHUNK)
    return Service(device=CPU, **kw)


def _run_clean(jobs):
    svc = _service()
    for j in jobs:
        svc.submit(j)
    return svc.run()


def _assert_results_equal(got, ref):
    for job_id, r in ref.items():
        assert got[job_id].reason == r.reason == "max_samples", job_id
        assert got[job_id].committed == r.committed, job_id
        assert chaos._tree_equal(got[job_id].results, r.results), job_id


# ----------------------------------------------------- checkpoint crashes


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(6, 4, generator=g),
            "b": torch.arange(5, dtype=torch.int32) + seed}


def _zeros():
    return {"a": torch.zeros(6, 4), "b": torch.zeros(5, dtype=torch.int32)}


def _arm(ck, point):
    def hook(p):
        if p == point:
            raise chaos.InjectedKill(p)
    ck._kill_hook = hook


@pytest.mark.parametrize("point", chaos._KILL_POINTS)
def test_kill_point_leaves_an_intact_checkpoint(tmp_path, point):
    """A writer killed at any point between tmp-write and rename: after the
    sweep, restore lands on an intact step — the new one if the rename
    committed, the previous one otherwise."""
    ck = Checkpointer(tmp_path)
    ck.save(1, _tree(1), blocking=True)
    _arm(ck, point)
    with pytest.raises(chaos.InjectedKill):
        ck.save(2, _tree(2), blocking=True)

    ck2 = Checkpointer(tmp_path)  # a restarted process: sweep recovery
    step = ck2.latest_intact_step()
    assert step == (2 if point == "renamed" else 1)
    restored, man = ck2.restore(_zeros())
    assert man["step"] == step
    assert chaos._tree_equal(restored, _tree(step))


def test_kill_while_parked_rolls_back_the_previous_step(tmp_path):
    """A same-step re-save parks the existing directory at ``.old``; dying
    there rolls the previous intact copy back into place."""
    ck = Checkpointer(tmp_path)
    ck.save(3, _tree(1), blocking=True)
    _arm(ck, "parked")
    with pytest.raises(chaos.InjectedKill):
        ck.save(3, _tree(2), blocking=True)
    assert (ck.dir / "step_00000003.old").exists()

    ck2 = Checkpointer(tmp_path)
    assert not (ck2.dir / "step_00000003.old").exists()
    assert ck2.latest_intact_step() == 3
    restored, _ = ck2.restore(_zeros())
    assert chaos._tree_equal(restored, _tree(1))  # the FIRST save's contents


def test_async_save_failure_surfaces_in_wait(tmp_path):
    ck = Checkpointer(tmp_path)
    _arm(ck, "manifest_written")
    ck.save(1, _tree(), blocking=False)
    with pytest.raises(chaos.InjectedKill):
        ck.wait()
    ck._kill_hook = None
    ck.save(1, _tree(), blocking=True)  # the checkpointer is still usable
    assert ck.verify(1) == []


def test_injected_kill_gets_through_the_service_retry(tmp_path, engine):
    """A kill inside a chunk is a process death, not a transient fault:
    the retry (which catches ``Exception``) must not swallow it."""
    svc = _service(checkpointer=Checkpointer(tmp_path))
    svc.submit(_job(0, engine))
    svc.step()
    eng = svc.scheduler.engine_of("j0")

    def dying(cs):
        raise chaos.InjectedKill("chunk")

    eng.run_chunk = dying
    with pytest.raises(chaos.InjectedKill):
        svc.step()
    assert svc.faults == []


# -------------------------------------------------- service checkpointing


def test_checkpoint_restore_run_is_bitwise_the_uninterrupted_run(
        tmp_path, engine):
    """Checkpoint after one chunk, drop the service, restore from the
    checkpoint alone (datasets travel in it) and drain: every job's
    results are bitwise the uninterrupted run's. The restored lanes hold
    the saved host values as Python values."""
    ref = _run_clean(_jobs(engine))
    svc = _service(checkpointer=Checkpointer(tmp_path, keep_last=2))
    for j in _jobs(engine):
        svc.submit(j)
    svc.step()
    svc.checkpoint()
    del svc

    svc2 = Service.restore(Checkpointer(tmp_path), device=CPU)
    assert svc2.restored_from_step == 1 and svc2.faults == []
    for job_id in ref:
        assert svc2.status(job_id) is JobStatus.SUSPENDED
        assert svc2.committed(job_id) == CHUNK
        _, lane, _ = svc2.scheduler.suspended[job_id]
        assert type(lane["count"]) is int and lane["job_id"] == job_id
        host = [v for _, v in flatten_with_paths(lane["carries"])
                if not isinstance(v, torch.Tensor)]
        assert host and all(type(v) is int for v in host)
    res = svc2.run()
    _assert_results_equal(res, ref)


def test_periodic_checkpoints_and_a_restart_from_each(tmp_path, engine):
    """``checkpoint_every=1`` saves after every step (the step count is the
    step's number); a service restored from any of them runs to the
    uninterrupted results."""
    ref = _run_clean(_jobs(engine))
    ck = Checkpointer(tmp_path, keep=0)
    svc = _service(checkpointer=ck, checkpoint_every=1)
    for j in _jobs(engine):
        svc.submit(j)
    res = svc.run()
    _assert_results_equal(res, ref)
    steps = ck.all_steps()
    assert steps == list(range(1, len(steps) + 1)) and len(steps) >= 3
    for step in steps:
        got = Service.restore(ck, step=step, device=CPU).run()
        assert set(got) <= set(ref)
        for job_id in got:
            assert chaos._tree_equal(got[job_id].results,
                                     ref[job_id].results), (step, job_id)


def test_device_loss_to_zero_with_a_checkpointer_resumes_bitwise(
        tmp_path, engine):
    ref = _run_clean(_jobs(engine))
    ck = Checkpointer(tmp_path)
    svc = _service(checkpointer=ck)
    for j in _jobs(engine):
        svc.submit(j)
    svc.step()

    suspended = svc.handle_device_loss(0)
    assert sorted(suspended) == ["j0", "j1", "j2"]
    assert ck.all_steps() == [1]  # checkpointed before the shrink
    assert not svc.scheduler.engines and svc.active()
    svc.step()  # a zero-budget step is a clean no-op
    svc.handle_device_loss(1)
    _assert_results_equal(svc.run(), ref)
    # ... and the checkpoint taken at the loss restarts to the same results
    _assert_results_equal(Service.restore(ck, step=1, device=CPU).run(), ref)


def test_corrupt_newest_step_falls_back_and_a_pinned_one_raises(
        tmp_path, engine):
    ref = _run_clean(_jobs(engine))
    ck = Checkpointer(tmp_path, keep=0)
    svc = _service(checkpointer=ck, checkpoint_every=1)
    for j in _jobs(engine):
        svc.submit(j)
    svc.step()
    svc.step()
    assert ck.all_steps() == [1, 2]
    damaged = chaos.corrupt_checkpoint(tmp_path, "ckpt_bitflip",
                                       random.Random(0))
    assert damaged == 2
    with pytest.raises(CheckpointCorruptError):
        Service.restore(Checkpointer(tmp_path), step=2, device=CPU)
    svc2 = Service.restore(Checkpointer(tmp_path), device=CPU)
    assert svc2.restored_from_step == 1
    ev = [e for e in svc2.faults if e.kind == "checkpoint_fallback"]
    assert len(ev) == 1 and ev[0].detail == {"loaded_step": 1,
                                             "skipped_steps": [2]}
    _assert_results_equal(svc2.run(), ref)


def test_posterior_predictive_refuses_checkpointing(tmp_path):
    job = dataclasses.replace(_job(0), collectors={
        "trace": FullTrace(), "rhat": RHat(),
        "pp": PosteriorPredictive(x_eval=torch.zeros(4, D))})
    svc = _service(checkpointer=Checkpointer(tmp_path))
    svc.submit(job)
    svc.step()
    with pytest.raises(ValueError, match="cannot be checkpointed"):
        svc.checkpoint()
    assert Checkpointer(tmp_path).all_steps() == []


# ----------------------------------------------------------- chaos seeds


@pytest.mark.parametrize("seed", [2, 3])
def test_chaos_schedule_holds_the_exactness_contract(tmp_path, seed, engine,
                                                     monkeypatch):
    """Seeded chaos at the reference test's sizes (chunk errors for seed 2;
    a device loss and a checkpoint kill with a cold restart for seed 3):
    ``run_schedule`` raises on any contract violation, so a report IS the
    certificate."""
    real = chaos._chaos_jobs
    monkeypatch.setattr(chaos, "_chaos_jobs", lambda **kw: [
        dataclasses.replace(j, **ENGINES[engine]) for j in real(**kw)])
    report = chaos.run_schedule(
        seed, n=48, d=3, max_samples=24, num_warmup=6, chunk_size=8,
        directory=tmp_path / "ckpt", n_faults=3, device=CPU,
    )
    assert report.fired  # the schedule actually attacked the run
    assert len(report.survivors) + len(report.prefix_ok) + len(
        report.lost
    ) == 4
    if seed == 3:
        assert report.restarts >= 1


@pytest.mark.parametrize("seed", range(8))
def test_schedule_is_the_reference_schedule(seed):
    for kw in ({}, {"n_steps": 5, "n_faults": 3},
               {"kinds": ("device_loss", "ckpt_torn", "kill_begin")}):
        got, want = chaos.schedule(seed, **kw), ref_chaos.schedule(seed, **kw)
        assert [dataclasses.astuple(f) for f in got] == [
            dataclasses.astuple(f) for f in want]
    assert chaos.ALL_KINDS == ref_chaos.ALL_KINDS
    assert chaos._KILL_POINTS == ref_chaos._KILL_POINTS
