"""Fault tolerance of the port's sampling service, on the CPU.

Re-pins, inside the port, the cases of ``tests/test_faults.py`` that need
no checkpointer and no chaos harness (both wait for the checkpointing
slice): the fault taxonomy, retry exactness, retry exhaustion, the health
sentinel's quarantine (the NaN written straight into the lane), straggler
escalation, total device loss and the slot plan. Every survivor is held
bitwise to its fault-free run. Each case runs on both engine pairs where it
steps chains: the plain engines and the kernel engines (whose wrappers run
their plain versions on the CPU).
"""

import dataclasses

import pytest
import torch

from repro_torch import random as jr
from repro_torch.api import BatchMeansESS, FullTrace, RHat
from repro_torch.data import logistic_data, softmax_data
from repro_torch.launch import elastic
from repro_torch.serve import (
    FaultEvent,
    GroupEngine,
    Job,
    JobStatus,
    RetryPolicy,
    Service,
    TerminationPolicy,
    group_key,
)
from repro_torch.serve import faults as faults_lib

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


def _job(i, engine="kernels", seed=None, num_chains=1, job_id=None):
    return Job(
        job_id=job_id or f"j{i}", family="logistic",
        seed=5 + i if seed is None else seed, num_chains=num_chains,
        data=logistic_data(jr.key(40 + i, device=CPU), n=N, d=D,
                           separation=1.5, device=CPU),
        capacity=CAP, cand_capacity=CAP, num_warmup=WARM,
        policy=TerminationPolicy(max_samples=MAX), **ENGINES[engine],
    )


def _service(**kw):
    kw.setdefault("slot_budget", 8)
    kw.setdefault("chunk_size", CHUNK)
    return Service(device=CPU, **kw)


def _run_clean(jobs):
    svc = _service()
    for j in jobs:
        svc.submit(j)
    return svc.run()


def _tree_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _tree_equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _tree_equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    else:
        import numpy as np

        np.testing.assert_array_equal(a, b)


def _engine_of(svc, job_id):
    eng = svc.scheduler.engine_of(job_id)
    assert eng is not None
    return eng


# ---------------------------------------------------------------- taxonomy


def test_fault_event_rejects_unknown_kind():
    with pytest.raises(ValueError):
        FaultEvent(kind="gremlins", step=0)
    assert FaultEvent(kind="nonfinite", step=3, job_id="a").detail == {}


def test_retry_policy_validation_and_backoff_schedule():
    p = RetryPolicy(max_retries=3, backoff_s=0.1, multiplier=2.0)
    assert p.delay(1) == pytest.approx(0.1)
    assert p.delay(2) == pytest.approx(0.2)
    assert p.delay(3) == pytest.approx(0.4)
    with pytest.raises(ValueError):
        RetryPolicy(max_retries=-1)
    with pytest.raises(ValueError):
        RetryPolicy(backoff_s=-0.5)


def test_group_label_is_stable():
    svc = _service()
    svc.submit(_job(0))
    svc.step()
    (key,) = svc.scheduler.engines
    label = faults_lib.group_label(key)
    assert label == f"logistic-n{N}-d{D}-K1"
    # stable: another member of the group, and a later step, give the same
    assert label == faults_lib.group_label(group_key(_job(5)))
    svc.step()
    assert faults_lib.group_label(next(iter(svc.scheduler.engines))) == label


# ------------------------------------------------------- retry exactness


def test_transient_chunk_error_retries_bitwise(engine):
    """One injected chunk failure and a retry give results bitwise the
    fault-free run's, with one chunk_error event on the stream; the backoff
    sleeps the policy's delay."""
    ref = _run_clean([_job(0, engine), _job(1, engine)])
    svc = _service(retry=RetryPolicy(max_retries=2, backoff_s=0.25))
    slept = []
    svc._sleep = slept.append
    for j in (_job(0, engine), _job(1, engine)):
        svc.submit(j)
    svc.step()
    eng = _engine_of(svc, "j0")
    real, left = eng.run_chunk, {"n": 1}

    def flaky(cs):
        if left["n"]:
            left["n"] -= 1
            raise RuntimeError("transient launch failure")
        return real(cs)

    eng.run_chunk = flaky
    seen = []
    res = svc.run(on_update=seen.append)
    for j in ("j0", "j1"):
        assert res[j].reason == "max_samples"
        _tree_equal(res[j].results, ref[j].results)
    errs = [e for e in svc.faults if e.kind == "chunk_error"]
    assert len(errs) == 1 and errs[0].detail["retrying"] is True
    assert errs[0] in seen and slept == [0.25]


def test_chunk_raising_mid_lane_loop_retries_bitwise(engine):
    """The fault inside the chunk itself (the second lane's step raises
    after the first lane has stepped): the retry is still the same chunk."""
    ref = _run_clean([_job(0, engine), _job(1, engine)])
    svc = _service(retry=RetryPolicy(max_retries=1, backoff_s=0.0))
    for j in (_job(0, engine), _job(1, engine)):
        svc.submit(j)
    svc.step()
    eng = _engine_of(svc, "j0")
    real = eng._alg.step_data
    calls = {"n": 0}

    def flaky(*a):
        calls["n"] += 1
        if calls["n"] == CHUNK + 3:
            raise RuntimeError("launch failure in lane 2")
        return real(*a)

    eng._alg = dataclasses.replace(eng._alg, step_data=flaky)
    res = svc.run()
    for j in ("j0", "j1"):
        _tree_equal(res[j].results, ref[j].results)
    assert [e.kind for e in svc.faults] == ["chunk_error"]


def test_chunk_raising_in_a_collector_update_retries_bitwise(engine):
    """The fault inside the fold (the second lane's R̂ update raises after
    the first lane has folded the chunk): every lane folds into a clone of
    its carry, so the retry folds each lane once, and the trace, R̂ and
    ESS results are bitwise the fault-free run's."""

    def jobs():
        return [dataclasses.replace(
            _job(i, engine),
            collectors={"trace": FullTrace(), "rhat": RHat(),
                        "ess": BatchMeansESS()}) for i in (0, 1)]

    ref = _run_clean(jobs())
    svc = _service(retry=RetryPolicy(max_retries=1, backoff_s=0.0))
    for j in jobs():
        svc.submit(j)
    svc.step()
    eng = _engine_of(svc, "j0")
    rhat = eng.colls["rhat"]
    real = rhat.update
    calls = {"n": 0}

    def flaky(*a):
        calls["n"] += 1
        if calls["n"] == CHUNK + 3:
            raise RuntimeError("allocation failure in lane 2's fold")
        return real(*a)

    rhat.update = flaky
    res = svc.run()
    for j in ("j0", "j1"):
        assert res[j].reason == "max_samples" and res[j].committed == MAX
        _tree_equal(res[j].results, ref[j].results)
    assert [e.kind for e in svc.faults] == ["chunk_error"]


def test_retry_exhaustion_fails_group_with_clean_prefix(engine):
    ref = _run_clean([_job(0, engine), _job(1, engine)])
    svc = _service(retry=RetryPolicy(max_retries=1, backoff_s=0.0))
    for j in (_job(0, engine), _job(1, engine)):
        svc.submit(j)
    svc.step()
    eng = _engine_of(svc, "j0")

    def broken(cs):
        raise RuntimeError("persistent fault")

    eng.run_chunk = broken
    updates = svc.step()
    assert not svc.active()
    kinds = [e.kind for e in svc.faults]
    assert kinds.count("chunk_error") == 2  # attempt + final
    assert kinds.count("group_failed") == 1
    assert sorted(u.job_id for u in updates if getattr(u, "reason", None)
                  == "failed") == ["j0", "j1"]
    for j in ("j0", "j1"):
        res = svc.result(j)
        assert svc.status(j) is JobStatus.FAILED
        assert res.reason == "failed" and res.committed == CHUNK
        assert torch.equal(res.samples(),
                           ref[j].results["trace"]["theta"][:, :CHUNK])


# ------------------------------------------------------------- quarantine


def _poison(svc, job_id, what):
    """NaN one job's lane on the device: its θ (every chain), or one
    feature of its dataset (a copy: the Job's own tensor is untouched)."""
    eng = _engine_of(svc, job_id)
    lane = eng.lane_of(job_id)
    if what == "theta":
        st = lane["state"]
        lane["state"] = st._replace(sampler=st.sampler._replace(
            theta=torch.full_like(st.sampler.theta, float("nan"))))
    else:
        x = lane["data"].x.clone()
        x[0, 0] = float("nan")
        lane["data"] = lane["data"]._replace(x=x)


@pytest.mark.parametrize("what", ["theta", "data"])
def test_nan_poison_quarantines_only_the_sick_lane(engine, what):
    """NaN in one job's θ or dataset: that lane alone retires
    "quarantined" with a finite, bitwise-clean prefix; its neighbour
    finishes bitwise the fault-free run and the run where the poisoned job
    was never admitted."""
    ref = _run_clean([_job(0, engine), _job(1, engine)])
    solo_ref = _run_clean([_job(1, engine)])
    svc = _service()
    for j in (_job(0, engine), _job(1, engine)):
        svc.submit(j)
    svc.step()
    _poison(svc, "j0", what)
    res = svc.run()

    assert svc.status("j0") is JobStatus.FAILED
    assert res["j0"].reason == "quarantined"
    ev = [e for e in svc.faults if e.kind == "nonfinite"]
    assert len(ev) == 1 and ev[0].job_id == "j0"
    got = res["j0"].samples()
    assert res["j0"].committed == CHUNK and bool(torch.isfinite(got).all())
    assert torch.equal(got, ref["j0"].results["trace"]["theta"][:, :CHUNK])
    assert res["j1"].reason == "max_samples"
    _tree_equal(res["j1"].results, ref["j1"].results)
    _tree_equal(res["j1"].results, solo_ref["j1"].results)


def test_quarantine_and_a_retried_fold_in_one_chunk(engine):
    """A chunk that quarantines one lane and then raises in its neighbour's
    fold: the retry quarantines the sick job once, and the neighbour
    finishes bitwise the fault-free run."""
    ref = _run_clean([_job(0, engine), _job(1, engine)])
    svc = _service(retry=RetryPolicy(max_retries=1, backoff_s=0.0))
    for j in (_job(0, engine), _job(1, engine)):
        svc.submit(j)
    svc.step()
    _poison(svc, "j0", "theta")
    trace = _engine_of(svc, "j1").colls["trace"]
    real, left = trace.update, {"n": 1}

    def flaky(*a):
        if left["n"]:
            left["n"] -= 1
            raise RuntimeError("allocation failure in the fold")
        return real(*a)

    trace.update = flaky
    res = svc.run()
    assert res["j0"].reason == "quarantined" and res["j0"].committed == CHUNK
    assert [e.kind for e in svc.faults] == ["chunk_error", "nonfinite"]
    assert res["j1"].reason == "max_samples"
    _tree_equal(res["j1"].results, ref["j1"].results)


def test_sick_lane_overflow_never_grows_the_group():
    """A poisoned lane that also reports overflow on every step: the
    group neither grows nor re-runs, and the lane is quarantined."""
    svc = _service()
    for j in (_job(0), _job(1)):
        svc.submit(j)
    svc.step()
    eng = _engine_of(svc, "j0")
    _poison(svc, "j0", "data")
    sick = eng.lane_of("j0")["data"]
    real = eng._alg.step_data

    def overflowing(keys, state, data, stats):
        st, info = real(keys, state, data, stats)
        if data is sick:
            info = info._replace(overflow=torch.ones_like(info.overflow))
        return st, info

    eng._alg = dataclasses.replace(eng._alg, step_data=overflowing)
    cap = eng.capacity
    svc.step()
    assert eng.capacity == cap and eng.reruns == 0
    assert svc.status("j0") is JobStatus.FAILED
    assert svc.result("j0").reason == "quarantined"


def test_quarantine_is_not_triggered_by_healthy_runs(engine):
    svc = _service()
    svc.submit(_job(0, engine))
    res = svc.run()
    assert res["j0"].reason == "max_samples"
    assert svc.faults == []


# -------------------------------------------------------------- stragglers


def test_straggler_monitor_flags_slow_host():
    mon = elastic.StragglerMonitor(threshold=2.0)
    mon.record("a", 1.0)
    assert mon.stragglers() == []  # fewer than 2 hosts: no median
    mon.record("b", 1.0)
    mon.record("c", 1.0)
    for _ in range(30):
        mon.record("c", 10.0)
    assert mon.stragglers() == ["c"]


def test_straggler_escalation_is_opt_in_and_deduplicated():
    """Three groups on a fake clock, one 10× slower: with a threshold the
    service emits one straggler event (deduplicated across steps); without,
    times are recorded but nothing escalates."""

    def build(threshold):
        svc = _service(slot_budget=16, straggler_threshold=threshold)
        fake = {"t": 0.0}
        svc._clock = lambda: fake["t"]
        svc.submit(_job(0))
        svc.submit(_job(2, num_chains=2, job_id="k2"))
        svc.submit(Job(
            job_id="s0", family="softmax", seed=8, n_classes=3,
            data=softmax_data(jr.key(88, device=CPU), n=N, d=D, k=3,
                              device=CPU),
            capacity=CAP, cand_capacity=CAP, num_warmup=WARM,
            policy=TerminationPolicy(max_samples=MAX),
        ))
        svc.step()  # admit all three groups
        slow = faults_lib.group_label(svc.scheduler.engine_of("s0").group_key)
        for key, eng in svc.scheduler.engines.items():
            cost = 10.0 if faults_lib.group_label(key) == slow else 1.0
            real = eng.run_chunk

            def timed(cs, real=real, cost=cost):
                out = real(cs)
                fake["t"] += cost
                return out

            eng.run_chunk = timed
        return svc, slow

    svc, slow = build(threshold=4.0)
    svc.run()
    ev = [e for e in svc.faults if e.kind == "straggler"]
    assert len(ev) == 1 and ev[0].group == slow

    svc2, _ = build(threshold=None)
    svc2.run()
    assert [e for e in svc2.faults if e.kind == "straggler"] == []
    assert len(svc2.monitor.ewma) == 3  # recording is always on


# ------------------------------------------------------------- device loss


def test_device_loss_to_zero_suspends_all_then_resumes_bitwise(engine):
    ref = _run_clean([_job(0, engine), _job(1, engine)])
    svc = _service()
    for j in (_job(0, engine), _job(1, engine)):
        svc.submit(j)
    svc.step()

    suspended = svc.handle_device_loss(0)
    assert sorted(suspended) == ["j0", "j1"]
    assert not svc.scheduler.engines
    assert all(svc.status(j) is JobStatus.SUSPENDED for j in ("j0", "j1"))
    assert svc.active()  # suspended is not lost
    assert svc.committed("j0") == CHUNK
    ev = [e for e in svc.faults if e.kind == "device_loss"]
    assert len(ev) == 1 and ev[0].detail["new_budget"] == 0
    svc.step()  # a zero-budget step is a clean no-op

    svc.handle_device_loss(1)  # capacity returns
    res = svc.run()
    for j in ("j0", "j1"):
        assert res[j].reason == "max_samples"
        _tree_equal(res[j].results, ref[j].results)


def test_suspended_job_cancels_with_its_committed_prefix():
    ref = _run_clean([_job(0)])
    svc = _service()
    svc.submit(_job(0))
    svc.step()
    svc.handle_device_loss(0)
    assert svc.cancel("j0")
    r = svc.result("j0")
    assert r.reason == "cancelled" and r.committed == CHUNK
    assert torch.equal(r.samples(), ref["j0"].results["trace"]["theta"][:, :CHUNK])


def test_plan_chain_slots_zero_is_legal_negative_is_not():
    assert elastic.plan_chain_slots(0) == 0
    assert elastic.plan_chain_slots(2, slots_per_device=4) == 8
    with pytest.raises(ValueError):
        elastic.plan_chain_slots(-1)
    mesh = elastic.plan_mesh(16)  # one full model-parallel group of 16
    assert (mesh.axis_names, mesh.shape) == (("data", "model"), (1, 16))


def test_engine_rejects_foreign_and_duplicate_jobs():
    eng = GroupEngine(_job(0))
    eng.admit(_job(0))
    with pytest.raises(ValueError, match="already admitted"):
        eng.admit(_job(0))
    with pytest.raises(ValueError, match="does not match"):
        eng.admit(_job(1, num_chains=2))
    with pytest.raises(KeyError):
        eng.committed("nope")
