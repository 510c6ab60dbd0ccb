"""The service's packed ``"vmap"`` lanes and the kernels' lane axis.

``Service(lane_backend="vmap")`` steps a group's L lanes as L·K chains in
one chain-batched ``flymc_step`` on a lane stack of their datasets, so each
kernel launches once a group step. Within the port it must be bitwise the
``"map"`` loop and every job's solo ``api.sample`` run, through joins,
growth re-runs, quarantine and retried chunks, on both engine pairs (the
kernel engines' wrappers run their plain versions on the CPU). The plain
versions of both kernels with L lanes must be bitwise L single-lane calls.

Against the JAX package: the reference's own ``"vmap"`` backend on the
same mix, both sides on the plain engines (the reference ``Job``'s
default): equal accept decisions (each held at least 1e-4 from its edge in
the reference's solo run), θ within 1e-5 of its largest value, equal
bright and query counts. The reference's ``"vmap"`` is not bitwise its own
``"map"`` (XLA rounds with the batch width); the port's is.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.serve import Service as JService
from repro_torch import convert
from repro_torch import random as jr
from repro_torch.data import softmax_data
from repro_torch.kernels.bright_glm import ops as bops
from repro_torch.kernels.bright_glm.ref import bright_glm_ref
from repro_torch.kernels.z_update import ops as zops
from repro_torch.kernels.z_update.ref import z_candidates_ref
from repro_torch.serve import GroupEngine, Service, group_key
from repro_torch.serve.faults import RetryPolicy
from test_torch_serve import D as D_MIX
from test_torch_serve import N as N_MIX
from test_torch_serve import (CHUNK, ENGINES, MAX, _logistic_job, eq, mix,
                              port_job, solo)
from test_torch_serve_jax import _held_to_jax, jax_solo

torch.set_num_threads(1)

CPU = "cpu"
STEPS = MAX // CHUNK + 4


@pytest.fixture(scope="module", params=list(ENGINES))
def engine(request):
    return request.param


_SOLO = {}


def solo_refs(engine):
    if engine not in _SOLO:
        _SOLO[engine] = {j.job_id: solo(j) for j in mix(engine)}
    return _SOLO[engine]


def _run(jobs, backend, **kw):
    svc = Service(slot_budget=16, chunk_size=CHUNK, device=CPU,
                  lane_backend=backend, **kw)
    for j in jobs:
        svc.submit(j)
    return svc, svc.run(max_steps=8 * STEPS)


# ---------------------------------------------------------------------------
# The plain versions' lane axis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["logistic", "student_t", "softmax"])
def test_bright_glm_ref_lanes_are_single_lane_calls_bitwise(family):
    """L = 3 lanes of K = 2 chains, uneven bright counts and padding past
    N: δ, totals and the θ-gradient equal three single-lane calls, bit for
    bit."""
    g = torch.Generator().manual_seed(3)
    lanes, k, n, d, c, kc = 3, 2, 40, 5, 19, 3
    x = torch.randn(lanes, n, d, generator=g)
    if family == "softmax":
        t = torch.randint(0, kc, (lanes, n), generator=g)
        xi = torch.randn(lanes, n, kc, generator=g)
        theta = torch.randn(lanes, k, kc, d, generator=g)
    else:
        t = torch.randn(lanes, n, generator=g)
        xi = torch.rand(lanes, n, generator=g) + 2.0
        theta = torch.randn(lanes, k, d, generator=g) / 3
    idx = torch.randint(0, n + 4, (lanes, k, c), generator=g).to(torch.int32)
    nb = torch.tensor([[c, 0], [7, 13], [1, c - 1]])
    delta, total = bright_glm_ref(x, t, xi, idx, nb, theta, family)
    stack = convert.glm_lanes([(x[i].numpy(), t[i].numpy(), xi[i].numpy())
                               for i in range(lanes)], device=CPU)
    assert all(torch.equal(a, b) for a, b in zip(stack, (x, t, xi)))
    th = theta.clone().requires_grad_(True)
    _, tot = bops.bright_glm(x, t, xi, idx, nb, th, family)
    tot.sum().backward()
    for lane in range(lanes):
        d1, t1 = bright_glm_ref(x[lane], t[lane], xi[lane], idx[lane],
                                nb[lane], theta[lane], family)
        assert torch.equal(d1, delta[lane]) and torch.equal(t1, total[lane])
        th1 = theta[lane].clone().requires_grad_(True)
        _, t1 = bops.bright_glm(x[lane], t[lane], xi[lane], idx[lane],
                                nb[lane], th1, family)
        t1.sum().backward()
        assert torch.equal(th1.grad, th.grad[lane])


def test_z_candidates_ref_lanes_are_single_lane_calls_bitwise():
    """L = 3 lanes, uneven ``num``, a lane stack that is a strided view
    (each lane's block inside a wider buffer): ids and counts equal three
    single-lane calls, and the wrapper's CPU path gives the same."""
    g = torch.Generator().manual_seed(4)
    lanes, k, n, cap = 3, 2, 300, 40
    wide = torch.stack([torch.stack([torch.randperm(n, generator=g)
                                     for _ in range(k + 1)])
                        for _ in range(lanes)]).to(torch.int32)
    arr = wide[:, 1:]  # lane stride (K + 1)·N: not a contiguous stack
    num = torch.tensor([[0, 17], [299, 5], [150, 150]])
    kw = torch.randint(0, 2**32, (lanes, k, 2), generator=g)
    cand, count = z_candidates_ref(arr, num, kw, 0.2, cap)
    c2, n2 = zops.z_candidates(arr, num, kw, 0.2, cap)
    assert torch.equal(cand, c2) and torch.equal(count, n2)
    assert cand.shape == (lanes, k, cap) and count.shape == (lanes, k)
    for lane in range(lanes):
        c1, n1 = z_candidates_ref(arr[lane], num[lane], kw[lane], 0.2, cap)
        assert torch.equal(c1, cand[lane]) and torch.equal(n1, count[lane])


# ---------------------------------------------------------------------------
# "vmap" == "map" == solo, bitwise
# ---------------------------------------------------------------------------


def test_vmap_mix_bitwise_map_and_solo(engine):
    """The five-kind mix under "vmap": every job bitwise its "map" run and
    its solo run."""
    refs = solo_refs(engine)
    _, res_v = _run(mix(engine), "vmap")
    _, res_m = _run(mix(engine), "map")
    for job_id, ref in refs.items():
        assert res_v[job_id].reason == "max_samples"
        assert eq(res_v[job_id].results, ref), job_id
        assert eq(res_v[job_id].results, res_m[job_id].results), job_id


def _group(engine, n_jobs=4, **kw):
    """``n_jobs`` logistic jobs of one group key, K = 2, each its own
    dataset and seed."""
    return [dataclasses.replace(_logistic_job(i, engine, num_chains=2), **kw)
            for i in range(n_jobs)]


def test_vmap_join_and_growth_bitwise_solo(engine):
    """A group of 2-chain jobs at capacity 2: the group grows at admission
    and on overflow (re-running chunks from the saved states), and two jobs
    join after the first chunk; every job bitwise its solo run."""
    jobs = _group(engine, capacity=2, cand_capacity=2)
    svc = Service(slot_budget=16, chunk_size=CHUNK, device=CPU,
                  lane_backend="vmap")
    for j in jobs[:2]:
        svc.submit(j)
    svc.step()
    for j in jobs[2:]:
        svc.submit(j)
    seen = []
    real = GroupEngine.run_chunk

    def spy(self, cs):
        out = real(self, cs)
        seen.append((self.reruns, len(self.job_ids), self.group_steps,
                     self.lane_steps))
        return out

    GroupEngine.run_chunk = spy
    try:
        res = svc.run(max_steps=STEPS)
    finally:
        GroupEngine.run_chunk = real
    assert any(r > 0 for r, _, _, _ in seen)
    assert any(n == 4 for _, n, _, _ in seen)
    for j in jobs:
        assert eq(res[j.job_id].results, solo(j)), j.job_id


def test_vmap_quarantine_and_injected_raise_retry_bitwise(engine):
    """One lane's dataset poisoned with a NaN, and an injected raise in the
    next group step, retried: the sick job alone retires quarantined with
    its clean prefix, and its neighbours finish bitwise their solo runs."""
    jobs = _group(engine, n_jobs=3)
    svc = Service(slot_budget=16, chunk_size=CHUNK, device=CPU,
                  lane_backend="vmap",
                  retry=RetryPolicy(max_retries=1, backoff_s=0.0))
    svc._sleep = lambda s: None
    for j in jobs:
        svc.submit(j)
    svc.step()
    eng = svc.scheduler.engine_of(jobs[1].job_id)
    lane = eng.lane_of(jobs[1].job_id)
    x = lane["data"].x.clone()
    x[0, 0] = float("nan")
    lane["data"] = lane["data"]._replace(x=x)
    real, calls = eng._alg.step_data, {"n": 0}

    def flaky(*a):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected launch failure")
        return real(*a)

    eng._alg = dataclasses.replace(eng._alg, step_data=flaky)
    res = svc.run(max_steps=STEPS)
    assert [e.kind for e in svc.faults].count("chunk_error") == 1
    sick = res[jobs[1].job_id]
    assert sick.reason == "quarantined" and sick.committed == CHUNK
    assert torch.equal(sick.samples(),
                       solo(jobs[1])["trace"]["theta"][:, :CHUNK])
    for j in (jobs[0], jobs[2]):
        assert res[j.job_id].reason == "max_samples"
        assert eq(res[j.job_id].results, solo(j)), j.job_id


def test_vmap_group_step_launches_each_kernel_once(monkeypatch):
    """Kernel engines, 4 lanes of 2 chains: a group step is one
    ``flymc_step`` of 8 chains and one call of each kernel's wrapper
    (RWMH: 2 of ``bright_glm``, the proposal and the candidates); "map"
    makes one a lane-step."""
    calls = {"bright_glm": 0, "z_update": 0}
    real_b, real_z = bops._forward, zops.z_candidates_ref

    def count_b(*a, **k):
        calls["bright_glm"] += 1
        return real_b(*a, **k)

    def count_z(*a, **k):
        calls["z_update"] += 1
        return real_z(*a, **k)

    monkeypatch.setattr(bops, "_forward", count_b)
    monkeypatch.setattr(zops, "z_candidates_ref", count_z)
    for backend in ("vmap", "map"):
        jobs = _group("kernels")
        eng = GroupEngine(jobs[0], lane_backend=backend)
        for j in jobs:
            eng.admit(j)
        calls.update(bright_glm=0, z_update=0)
        eng.run_chunk(CHUNK)
        assert eng.reruns == 0 and eng.lane_steps == 4 * CHUNK
        steps = CHUNK if backend == "vmap" else 4 * CHUNK
        assert eng.group_steps == steps
        assert calls == {"bright_glm": 2 * steps, "z_update": steps}


def test_vmap_softmax_group_bitwise_solo():
    """A softmax group (the per-chain collapsed form with S and R per lane)
    on the kernel engines: bitwise solo."""
    jobs = [dataclasses.replace(
        _logistic_job(i, "kernels", num_chains=2), job_id=f"sm{i}",
        family="softmax", n_classes=3,
        data=softmax_data(jr.key(200 + i, device=CPU), n=96, d=5, k=3,
                          device=CPU)) for i in range(3)]
    _, res = _run(jobs, "vmap")
    for j in jobs:
        assert eq(res[j.job_id].results, solo(j)), j.job_id


# ---------------------------------------------------------------------------
# Against the reference's "vmap" Service
# ---------------------------------------------------------------------------

REF_STEPS = CHUNK  # one group chunk


def _ref_jobs():
    """job_mix's 2-chain logistic kind twice (one group key, two lanes of
    K = 2), stopped after one chunk."""
    from benchmarks._util import job_mix
    from repro.serve.job import TerminationPolicy as JPolicy

    jobs = job_mix(0, 7, n=N_MIX, d=D_MIX, max_samples=MAX, num_warmup=10,
                   auto_terminate=False)
    return [dataclasses.replace(jobs[i], policy=JPolicy(max_samples=REF_STEPS))
            for i in (1, 6)]


def test_vmap_group_step_held_to_the_reference_vmap_service():
    """One chunk of a two-lane group through the reference's
    ``Service(lane_backend="vmap")`` and the port's, both on the plain
    engines: every accept decision at least 1e-4 from its edge (in the
    reference's solo run), equal decisions and counts, θ within 1e-5 of its
    largest value."""
    jjobs = _ref_jobs()
    jsvc = JService(slot_budget=16, chunk_size=CHUNK, lane_backend="vmap")
    for j in jjobs:
        jsvc.submit(j)
    jres = jsvc.run(max_steps=4)
    jobs = [port_job(j, ENGINES["plain"]) for j in jjobs]
    assert group_key(jobs[0]) == group_key(jobs[1])
    svc, res = _run(jobs, "vmap")
    assert len(svc.scheduler.engines) == 0 and jobs[0].num_chains == 2
    for jjob in jjobs:
        ref = jax_solo(jjob, REF_STEPS)
        jr_ = jres[jjob.job_id].results["trace"]
        r = res[jjob.job_id].results["trace"]
        _held_to_jax(r["theta"], r["stats"],
                     dict(ref, theta=np.asarray(jr_["theta"]),
                          stats=jr_["stats"]), jjob.job_id)
