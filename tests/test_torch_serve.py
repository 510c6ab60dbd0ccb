"""The port's posterior-sampling service (:mod:`repro_torch.serve`).

Within the port, bitwise: a job's trajectory and every collector result
equal the solo ``repro_torch.api.sample`` run with the same seed, however
the service packs it. Each case re-pins a case of ``tests/test_serve.py``
and runs on both engine pairs: the reference's default plain engines
(``"jnp"``/``"jnp"``) and the kernel engines, whose wrappers run their
plain versions on the CPU.

The same mix against the JAX package is in ``test_torch_serve_jax.py``.

The workload is :func:`benchmarks._util.job_mix` at the sizes of
``tests/test_serve.py``; its datasets cross over as numpy arrays.
"""

import dataclasses
import inspect

import jax
import numpy as np
import pytest
import torch

from benchmarks._util import job_mix
from repro.serve import job as jjob_lib
from repro_torch import api, convert
from repro_torch import random as jr
from repro_torch.serve import (
    GroupEngine,
    Job,
    JobStatus,
    Service,
    TerminationPolicy,
    build_algorithm,
    group_key,
)
from repro_torch.serve import engine as engine_lib

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

CPU = "cpu"
CHUNK = 16
MAX = 48
N, D = 96, 5
WARM = 10
ENGINES = {"plain": dict(backend="jnp", z_backend="jnp"),
           "kernels": dict(backend="pallas", z_backend="fused")}


# ---------------------------------------------------------------------------
# The mix, carried across from the JAX package
# ---------------------------------------------------------------------------


def _jax_mix():
    return job_mix(0, 5, n=N, d=D, max_samples=MAX, num_warmup=WARM,
                   auto_terminate=False)


def port_job(jjob, engines, **over):
    """The port's Job with the JAX job's fields; its data as numpy."""
    skip = {"data", "policy", "collectors", "backend", "z_backend"}
    fields = {f.name: getattr(jjob, f.name)
              for f in dataclasses.fields(jjob) if f.name not in skip}
    d = jax.device_get(jjob.data)
    data = convert.glm_data(d.x, d.t, d.xi, device=CPU)
    policy = TerminationPolicy(**dataclasses.asdict(jjob.policy))
    return Job(data=data, policy=policy, **{**fields, **engines, **over})


_MIX = {}


def mix(engine):
    """The five-kind mix as port jobs (fresh Job objects each call)."""
    if "jax" not in _MIX:
        _MIX["jax"] = _jax_mix()
    return [port_job(j, ENGINES[engine]) for j in _MIX["jax"]]


def solo(job, on_chunk=None, **kw):
    alg = build_algorithm(job)
    tr = api.sample(alg, jr.key(job.seed, device=CPU), job.policy.max_samples,
                    num_chains=job.num_chains, chunk_size=CHUNK,
                    collectors={"trace": api.FullTrace(), "rhat": api.RHat()},
                    on_chunk=on_chunk, device=CPU, **kw)
    return tr.results


def eq(a, b):
    """Bitwise equality of nested results (tensors, arrays, scalars)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(eq(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(eq(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b, equal_nan=True)
    return a == b or (a != a and b != b)


@pytest.fixture(scope="module", params=list(ENGINES))
def engine(request):
    return request.param


_SOLO = {}


@pytest.fixture(scope="module")
def solo_refs(engine):
    if engine not in _SOLO:
        _SOLO[engine] = {j.job_id: solo(j) for j in mix(engine)}
    return _SOLO[engine]


def _logistic_job(i, engine, *, num_chains=1, policy=None, seed=None, **kw):
    from repro_torch.data import logistic_data

    return Job(
        job_id=f"log{i}", family="logistic",
        data=logistic_data(jr.key(100 + i, device=CPU), n=N, d=D, device=CPU),
        seed=(7 * i + 1 if seed is None else seed), num_chains=num_chains,
        capacity=32, cand_capacity=32, num_warmup=WARM,
        policy=policy or TerminationPolicy(max_samples=MAX),
        **ENGINES[engine], **kw,
    )


def _service(**kw):
    kw.setdefault("slot_budget", 16)
    kw.setdefault("chunk_size", CHUNK)
    return Service(device=CPU, **kw)


# ---------------------------------------------------------------------------
# Packing, within the port: bitwise
# ---------------------------------------------------------------------------


def test_mixed_mix_bitwise_vs_solo(engine, solo_refs):
    """Every job of the mix (K = 1 and 2, three families) retires with its
    solo run's results, bitwise."""
    svc = _service()
    for j in mix(engine):
        svc.submit(j)
    res = svc.run(max_steps=MAX // CHUNK + 4)
    assert len(svc.scheduler.engines) == 0
    for job_id, ref in solo_refs.items():
        r = res[job_id]
        assert r.reason == "max_samples" and r.committed == MAX
        assert eq(r.results["trace"], ref["trace"]), job_id
        assert eq(r.results["rhat"], ref["rhat"]), job_id


def test_join_between_chunks_is_bitwise_invisible(engine, solo_refs):
    jobs = {j.job_id: j for j in mix(engine)}
    late = [i for i in jobs if i.startswith(("softmax", "robust"))]
    svc = _service()
    for job_id, j in jobs.items():
        if job_id not in late:
            svc.submit(j)
    svc.step()  # incumbents commit one chunk
    for job_id in late:
        svc.submit(jobs[job_id])
    res = svc.run(max_steps=MAX // CHUNK + 4)
    for job_id, ref in solo_refs.items():
        assert eq(res[job_id].results["trace"], ref["trace"]), job_id


def test_group_below_capacity_grows_and_equals_solo(engine, solo_refs):
    """Members at a capacity far below their bright sets: the group grows
    at admission and on overflow (re-running chunks), and every job still
    equals its solo run at the mix's capacity."""
    svc = _service()
    for j in mix(engine):
        svc.submit(dataclasses.replace(j, capacity=2, cand_capacity=2))
    grown = []
    real = GroupEngine.run_chunk

    def spy(self, cs):
        out = real(self, cs)
        grown.append((self.reruns, self.inits, len(self.job_ids)))
        return out

    GroupEngine.run_chunk = spy
    try:
        res = svc.run(max_steps=MAX // CHUNK + 4)
    finally:
        GroupEngine.run_chunk = real
    assert any(r > 0 for r, _, _ in grown)  # a chunk re-ran
    assert any(i > n for _, i, n in grown)  # an admission grew the group
    for job_id, ref in solo_refs.items():
        assert eq(res[job_id].results, ref), job_id


def test_same_group_jobs_share_one_engine(engine):
    jobs = [_logistic_job(i, engine) for i in range(3)]
    assert len({group_key(j) for j in jobs}) == 1
    svc = _service(slot_budget=8)
    for j in jobs:
        svc.submit(j)
    svc.step()
    assert len(svc.scheduler.engines) == 1
    (eng,) = svc.scheduler.engines.values()
    assert sorted(eng.job_ids) == sorted(j.job_id for j in jobs)
    assert eng.num_slots == 3


def test_auto_terminated_neighbour_leaves_others_bitwise(engine):
    fixed = [_logistic_job(i, engine) for i in range(2)]
    conv = _logistic_job(9, engine, policy=TerminationPolicy(
        max_samples=MAX, min_samples=CHUNK, target_rhat=50.0))
    assert group_key(conv) == group_key(fixed[0])
    svc = _service(slot_budget=8)
    for j in (*fixed, conv):
        svc.submit(j)
    res = svc.run(max_steps=MAX // CHUNK + 4)
    r = res[conv.job_id]
    assert r.reason == "converged" and CHUNK <= r.committed < MAX
    assert torch.equal(r.samples(),
                       solo(conv)["trace"]["theta"][:, :r.committed])
    for j in fixed:
        assert res[j.job_id].committed == MAX
        assert eq(res[j.job_id].results, solo(j))


def test_peek_matches_solo_on_chunk_peek(engine):
    """The service's peek at committed = 2·CHUNK is the solo run's
    ``ChunkEvent.peek`` at that boundary, bitwise, and peeking does not
    perturb the final results."""
    job = _logistic_job(4, engine, num_chains=2)
    svc = _service(slot_budget=8)
    svc.submit(job)
    svc.step()
    svc.step()
    assert svc.committed(job.job_id) == 2 * CHUNK
    served = {n: svc.peek(job.job_id, n) for n in ("rhat", "trace")}
    captured = {}

    def hook(ev):
        if ev.committed == 2 * CHUNK:
            captured.update({n: ev.peek(n) for n in ("rhat", "trace")})
        return False

    ref = solo(job, on_chunk=hook)
    assert eq(served, captured)
    res = svc.run(max_steps=MAX // CHUNK + 2)
    assert eq(res[job.job_id].results, ref)


def test_stream_updates_arrive_each_boundary(engine):
    job = _logistic_job(5, engine)
    svc = _service(slot_budget=4)
    h = svc.submit(job, stream=("rhat",))
    seen = []
    svc.run(on_update=seen.append, max_steps=MAX // CHUNK + 2)
    assert [u.committed for u in seen] == [CHUNK, 2 * CHUNK, 3 * CHUNK]
    assert all("rhat" in u.peeks for u in seen)
    assert [u.done for u in seen] == [False, False, True]
    assert seen[-1].reason == "max_samples"
    assert h.status is JobStatus.DONE and h.committed == MAX
    assert h.result().reason == "max_samples"


def test_device_loss_suspend_resume_bitwise(engine, solo_refs):
    svc = _service()
    for j in mix(engine):
        svc.submit(j)
    svc.step()
    suspended = svc.handle_device_loss(n_devices=1, slots_per_device=2)
    assert svc.scheduler.slot_budget == 2
    assert suspended  # the mix needs 7 slots
    for job_id in suspended:
        assert svc.status(job_id) is JobStatus.SUSPENDED
        assert svc.committed(job_id) == CHUNK
    res = svc.run(max_steps=12 * (MAX // CHUNK + 4))
    for job_id, ref in solo_refs.items():
        assert eq(res[job_id].results["trace"], ref["trace"]), job_id


def test_cancel_returns_committed_prefix(engine):
    jobs = [_logistic_job(i, engine) for i in range(2)]
    svc = _service(slot_budget=8)
    for j in jobs:
        svc.submit(j)
    svc.step()
    assert svc.cancel(jobs[0].job_id)
    r = svc.result(jobs[0].job_id)
    assert svc.status(jobs[0].job_id) is JobStatus.CANCELLED
    assert r.reason == "cancelled" and r.committed == CHUNK
    assert torch.equal(r.samples(),
                       solo(jobs[0])["trace"]["theta"][:, :CHUNK])
    assert not svc.cancel(jobs[0].job_id)
    res = svc.run(max_steps=MAX // CHUNK + 2)
    assert res[jobs[1].job_id].reason == "max_samples"


# ---------------------------------------------------------------------------
# Validation and wiring
# ---------------------------------------------------------------------------


def test_submit_validation():
    svc = _service(slot_budget=2)
    svc.submit(_logistic_job(0, "plain"))
    with pytest.raises(ValueError, match="already submitted"):
        svc.submit(_logistic_job(0, "plain"))
    with pytest.raises(ValueError, match="chain slots"):
        svc.submit(_logistic_job(1, "plain", num_chains=4))
    with pytest.raises(ValueError, match="not\\s+collectors"):
        svc.submit(_logistic_job(2, "plain"), stream=("nope",))
    meta = _logistic_job(3, "plain")
    meta = dataclasses.replace(meta, data=meta.data._replace(
        x=meta.data.x.to("meta")))
    with pytest.raises(ValueError, match="service runs on"):
        svc.submit(meta)


def test_job_validation():
    with pytest.raises(ValueError):
        _logistic_job(0, "plain", policy=TerminationPolicy(max_samples=0))
    with pytest.raises(ValueError):
        dataclasses.replace(_logistic_job(0, "plain"), num_chains=0)
    with pytest.raises(ValueError):
        dataclasses.replace(_logistic_job(0, "plain"), family="nope")
    with pytest.raises(ValueError, match="rhat"):
        _logistic_job(0, "plain", policy=TerminationPolicy(target_rhat=1.1),
                      collectors={"trace": api.FullTrace()})
    with pytest.raises(ValueError, match="ess"):
        _logistic_job(0, "plain", policy=TerminationPolicy(min_ess=10.0))


def test_job_defaults_follow_the_ports_firefly():
    """The port's Job defaults to the kernel engines, as its firefly does;
    every other default is the reference's."""
    ref = {f.name: f.default for f in dataclasses.fields(jjob_lib.Job)}
    port = {f.name: f.default for f in dataclasses.fields(Job)}
    assert ref.keys() == port.keys()
    assert (port["backend"], port["z_backend"]) == ("pallas", "fused")
    assert (ref["backend"], ref["z_backend"]) == ("jnp", "jnp")
    sig = inspect.signature(api.firefly).parameters
    assert (sig["backend"].default, sig["z_backend"].default) == (
        port["backend"], port["z_backend"])
    same = set(ref) - {"backend", "z_backend", "policy"}
    assert all(ref[k] == port[k] for k in same)


def test_group_key_separates_incompatible_jobs():
    base = _logistic_job(0, "plain")
    assert group_key(base) == group_key(_logistic_job(1, "plain"))
    assert group_key(base) != group_key(_logistic_job(2, "plain",
                                                      num_chains=2))
    assert group_key(base) != group_key(
        _logistic_job(3, "plain", policy=TerminationPolicy(max_samples=2 * MAX)))
    assert group_key(base) != group_key(_logistic_job(4, "kernels"))
    small = dataclasses.replace(base, job_id="small", data=base.data._replace(
        x=base.data.x[: N // 2], t=base.data.t[: N // 2],
        xi=base.data.xi[: N // 2]))
    assert group_key(base) != group_key(small)
    # capacities and step sizes do not split groups
    assert group_key(base) == group_key(dataclasses.replace(
        base, capacity=8, step_size=0.3))


def test_lane_backend_default_is_map():
    sig = inspect.signature(GroupEngine.__init__)
    assert sig.parameters["lane_backend"].default == "map"
    svc = Service(slot_budget=4, device=CPU)
    assert svc.scheduler.lane_backend == "map"
    svc = Service(slot_budget=4, lane_backend="vmap", device=CPU)
    assert svc.scheduler.lane_backend == "vmap"
    with pytest.raises(ValueError):
        Service(slot_budget=4, lane_backend="pmap", device=CPU)
    assert engine_lib.bucket_size(5) == 8 and engine_lib.bucket_size(0) == 1


def test_service_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Service(slot_budget=4)
    assert Service(device=CPU).scheduler.slot_budget == 8  # one device


def test_checkpointing_raises_naming_its_roadmap_item(tmp_path):
    """Checkpointing is ported (``tests/test_torch_chaos.py`` holds it to
    the uninterrupted runs); what still raises is checkpointing without a
    checkpointer, and a restore from an empty directory."""
    from repro_torch.checkpoint import Checkpointer

    with pytest.raises(ValueError, match="needs a checkpointer"):
        Service(slot_budget=4, checkpoint_every=2, device=CPU)
    svc = Service(slot_budget=4, device=CPU)
    with pytest.raises(ValueError, match="no checkpointer"):
        svc.checkpoint()
    svc = Service(slot_budget=4, checkpointer=Checkpointer(tmp_path),
                  checkpoint_every=2, device=CPU)
    assert svc.checkpoint_every == 2 and svc.restored_from_step is None
    with pytest.raises(FileNotFoundError):
        Service.restore(Checkpointer(tmp_path), device=CPU)


def test_transactional_chunk_under_an_injected_raise(engine, solo_refs):
    """A raise inside a chunk (here: the lane step of the third lane, in
    the middle of the chunk) leaves every lane and carry at the previous
    boundary: re-running the chunk gives bitwise the solo results."""
    svc = _service(retry=None)
    for j in mix(engine):
        svc.submit(j)
    svc.step()
    engines = list(svc.scheduler.engines.values())
    eng = max(engines, key=lambda e: len(e.job_ids))
    assert len(eng.job_ids) >= 2
    before = [(lane["count"], lane["state"].iteration.clone())
              for lane in eng._lanes]
    real = eng._alg.step_data
    calls = {"n": 0}

    def flaky(*a):
        calls["n"] += 1
        if calls["n"] == CHUNK + CHUNK // 2:
            raise RuntimeError("injected")
        return real(*a)

    eng._alg = dataclasses.replace(eng._alg, step_data=flaky)
    with pytest.raises(RuntimeError, match="injected"):
        eng.run_chunk(CHUNK)
    after = [(lane["count"], lane["state"].iteration) for lane in eng._lanes]
    assert all(c0 == c1 and torch.equal(i0, i1)
               for (c0, i0), (c1, i1) in zip(before, after))
    eng._alg = dataclasses.replace(eng._alg, step_data=real)
    res = svc.run(max_steps=MAX // CHUNK + 4)
    for job_id, ref in solo_refs.items():
        assert eq(res[job_id].results, ref), job_id
