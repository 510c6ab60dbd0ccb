"""The port's CUDA kernels on the card: each against its plain version, the
exactness contracts of a short chain run on the device, one slice and one
HMC step on the card against the CPU, the full-width
recurrentgemma serving path, the rwkv6 serving path, the training path
(the ``FusedCE`` and ``RGLRUScan`` gradients, the reduced trainer), and
checkpoints of card tensors and of a service on the card.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without one;
this file imports no JAX, so it runs on a machine with only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch import random as jr
from repro_torch.configs import get_reduced
from repro_torch.data import logistic_data, robust_data
from repro_torch.kernels.bright_glm import ops as bops
from repro_torch.kernels.bright_glm.ref import bright_glm_ref
from repro_torch.kernels.decode_attention import ops as aops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.fused_ce import ops as cops
from repro_torch.kernels.fused_ce.ref import fused_ce_ref
from repro_torch.kernels.rglru_scan import ops as rops
from repro_torch.kernels.rglru_scan.ref import rglru_bwd_ref, rglru_ref
from repro_torch.kernels.rwkv6_scan import ops as wops
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_chunked_ref
from repro_torch.kernels.z_update import ops as zops
from repro_torch.kernels.z_update.ref import z_candidates_ref
from repro_torch.launch.serve import serve
from repro_torch.launch.train import train_reduced
from repro_torch.models import serving as SV
from repro_torch.models import transformer as T
from repro_torch.models.bayes_glm import GLMModel
from _torch_grad_invariance import assert_bound_gradients_batch_invariant

pytestmark = pytest.mark.cuda
KW = {"logistic": {}, "student_t": {"nu": 4.0, "sigma": 1.5}, "softmax": {}}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _bright_inputs(family, n, d, k, c, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g)
    if family == "softmax":
        t = torch.randint(0, 3, (n,), generator=g)
        xi = torch.randn(n, 3, generator=g)
        theta = 0.5 * torch.randn(k, 3, d, generator=g)
    else:
        t = (torch.randn(n, generator=g).sign() if family == "logistic"
             else 2 * torch.randn(n, generator=g))
        xi = t.abs() + 5.0 + torch.rand(n, generator=g)  # away from tightness
        theta = 0.5 * torch.randn(k, d, generator=g) / d**0.5
    arr = torch.stack([torch.randperm(n, generator=g) for _ in range(k)])
    arr = arr.to(torch.int32)
    nb = torch.randint(0, c, (k,), generator=g)
    return [a.to(dev) for a in (x, t, xi)] + [arr.to(dev), nb.to(dev),
                                              theta.to(dev)]


@pytest.mark.parametrize("family", ["logistic", "student_t", "softmax"])
@pytest.mark.parametrize("n,d,c", [(500, 7, 24), (3000, 51, 512)])
def test_bright_glm_kernel_matches_plain(dev, family, n, d, c):
    x, t, xi, arr, nb, theta = _bright_inputs(family, n, d, 2, c, dev)
    idx = arr[:, :c]  # a strided view, as the step passes it
    before = bops.launch_count
    delta, total = bops.bright_glm(x, t, xi, idx, nb, theta, family=family,
                                   **KW[family])
    torch.cuda.synchronize()
    assert bops.launch_count == before + 1
    d_ref, t_ref = bright_glm_ref(x, t, xi, idx, nb, theta, family=family,
                                  **KW[family])
    torch.testing.assert_close(delta, d_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(total, t_ref, rtol=1e-5, atol=1e-5)


def test_bright_glm_gradient_on_card(dev):
    x, t, xi, arr, nb, theta = _bright_inputs("logistic", 800, 9, 2, 64, dev)
    th = theta.clone().requires_grad_(True)
    _, total = bops.bright_glm(x, t, xi, arr[:, :64], nb, th)
    (g,) = torch.autograd.grad(total.sum(), th)
    cpu = [a.cpu() for a in (x, t, xi, arr[:, :64], nb, theta)]
    th_c = cpu[-1].clone().requires_grad_(True)
    _, total_c = bops.bright_glm(*cpu[:-1], th_c)
    (g_c,) = torch.autograd.grad(total_c.sum(), th_c)
    torch.testing.assert_close(g.cpu(), g_c, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,frac,q_db,cap", [
    (5000, 0.1, 0.05, 64), (70001, 0.0, 0.01, 4096), (2049, 0.5, 1e-9, 8),
])
def test_z_candidates_kernel_matches_plain_bitwise(dev, n, frac, q_db, cap):
    g = torch.Generator().manual_seed(n)
    arr = torch.stack([torch.randperm(n, generator=g) for _ in range(2)])
    arr = arr.to(torch.int32).to(dev)
    num = torch.tensor([int(frac * n), 0], device=dev)
    kw = torch.randint(0, 2**32, (2, 2), generator=g).to(dev)
    before = zops.launch_count
    cand, count = zops.z_candidates(arr, num, kw, q_db, cap)
    torch.cuda.synchronize()
    assert zops.launch_count == before + 1
    c_ref, n_ref = z_candidates_ref(arr, num, kw, q_db, cap)
    assert torch.equal(cand, c_ref) and torch.equal(count, n_ref)


def _device_kernels(fn, reps=10, tries=5):
    """Names of the device activities (kernels, copies, memsets) that each
    of ``reps`` warm calls of ``fn`` puts on the card, from one profiler
    trace a call. The profiler now and then records nothing for a call; such
    a call is traced again, up to ``tries`` times. Returns the names a call
    and the number of calls made, the warm one and the retraced included."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm: the build and the persistent workspaces
    torch.cuda.synchronize()
    calls, made = [], 1
    for _ in range(reps):
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            made += 1
            names = [e.name for e in prof.events()
                     if e.device_type == DeviceType.CUDA]
            if names:
                break
        calls.append(names)
    return calls, made


@pytest.mark.parametrize("kernel", ["bright_glm", "z_candidates"])
def test_one_device_kernel_per_call(dev, kernel):
    """Each wrapper call runs exactly one device kernel, under its own name
    — no second pass, no memset of the workspace — and ``launch_count``
    counts that one."""
    if kernel == "bright_glm":
        x, t, xi, arr, nb, theta = _bright_inputs("logistic", 12214, 51, 2,
                                                  512, dev)
        fn = lambda: bops.bright_glm(x, t, xi, arr[:, :512], nb, theta)
        ops, name = bops, "bright_glm_kernel"
    else:
        g = torch.Generator().manual_seed(3)
        arr = torch.stack([torch.randperm(12214, generator=g)
                           for _ in range(2)]).to(torch.int32).to(dev)
        num = torch.tensor([244, 0], device=dev)
        kw = torch.randint(0, 2**32, (2, 2), generator=g).to(dev)
        fn = lambda: zops.z_candidates(arr, num, kw, 0.01, 512)
        ops, name = zops, "z_candidates_kernel"
    before = ops.launch_count
    calls, made = _device_kernels(fn, reps=10)
    assert ops.launch_count - before == made
    assert all(len(c) == 1 and name in c[0] for c in calls), calls


@pytest.mark.parametrize("family", ["logistic", "softmax"])
def test_bright_glm_many_blocks_repeated_is_bitwise_stable(dev, family):
    """8,192 blocks per chain, K = 3, 2,000 calls: the total that the last
    block of each chain sums (after the others' fences) never differs from
    the first call's, and the first call agrees with the plain version."""
    c = 65536
    x, t, xi, arr, nb, theta = _bright_inputs(family, 70000, 51, 3, c, dev)
    nb = torch.tensor([c, c // 3, 0], device=dev)
    idx = arr[:, :c]
    d0, t0 = bops.bright_glm(x, t, xi, idx, nb, theta, family=family)
    d_ref, t_ref = bright_glm_ref(x, t, xi, idx, nb, theta, family=family)
    torch.testing.assert_close(d0, d_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(t0, t_ref, rtol=1e-5, atol=1e-5)
    diff = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(2000):
        d, tot = bops.bright_glm(x, t, xi, idx, nb, theta, family=family)
        diff += (d != d0).sum() + (tot != t0).sum()
    assert int(diff) == 0


@pytest.mark.parametrize("cap", [28125, 1000])  # N / 64; count > cap
def test_z_candidates_large_n_repeated_is_bitwise(dev, cap):
    """N = 1.8M (879 tiles per chain), K = 2, 1,000 calls with fresh key
    words: the look-back offsets and the count are bitwise the plain
    version's in every call, also when the count overflows the buffer."""
    n = 1_800_000
    g = torch.Generator().manual_seed(11)
    arr = torch.stack([torch.randperm(n, generator=g) for _ in range(2)])
    arr = arr.to(torch.int32).to(dev)
    num = torch.tensor([n // 50, 0], device=dev)
    kw0 = torch.randint(0, 2**32, (2, 2), generator=g).to(dev)
    diff = torch.zeros((), dtype=torch.int64, device=dev)
    over = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(1000):
        kw = (kw0 + i) & 0xFFFFFFFF
        cand, count = zops.z_candidates(arr, num, kw, 0.01, cap)
        c_ref, n_ref = z_candidates_ref(arr, num, kw, 0.01, cap)
        diff += (cand != c_ref).sum() + (count != n_ref).sum()
        over += (count > cap).sum()
    assert int(diff) == 0
    assert int(over) == (2000 if cap == 1000 else 0)


def test_workspaces_come_back_clean_across_shapes(dev):
    """Calls alternating N = 12,214 / 1.8M and K = 1 / 2 / 3 share each
    kernel's persistent workspace; every call is still exact."""
    g = torch.Generator().manual_seed(12)
    arrs = {n: torch.stack([torch.randperm(n, generator=g) for _ in range(3)])
            .to(torch.int32).to(dev) for n in (12214, 1_800_000)}
    kw = torch.randint(0, 2**32, (3, 2), generator=g).to(dev)
    x, t, xi, barr, _, theta = _bright_inputs("logistic", 12214, 51, 3, 512,
                                              dev)
    nb = torch.tensor([500, 77, 0], device=dev)
    first = {}
    for rep in range(4):
        for n in (12214, 1_800_000):
            for k in (1, 2, 3):
                num = torch.tensor([n // 50, 0, 7][:k], device=dev)
                cap = 512 if n == 12214 else n // 64
                cand, count = zops.z_candidates(arrs[n][:k], num, kw[:k],
                                                0.01, cap)
                c_ref, n_ref = z_candidates_ref(arrs[n][:k], num, kw[:k],
                                                0.01, cap)
                assert torch.equal(cand, c_ref) and torch.equal(count, n_ref)
                c = 512 if n == 12214 else 8192
                bidx = barr[:k, :c]
                out = bops.bright_glm(x, t, xi, bidx, nb[:k], theta[:k])
                if (k, c) in first:
                    assert all(torch.equal(a, b)
                               for a, b in zip(out, first[(k, c)]))
                else:
                    ref = bright_glm_ref(x, t, xi, bidx, nb[:k], theta[:k])
                    torch.testing.assert_close(out[1], ref[1], rtol=1e-5,
                                               atol=1e-5)
                    first[(k, c)] = out


def test_flymc_step_never_waits_on_the_card(dev):
    """FlyMC steps (K = 2, RWMH) issue their work without making the host
    wait for the device: under ``set_sync_debug_mode("error")`` a host-to-
    device copy of a Python scalar or a read-back raises."""
    data = logistic_data(jr.key(0), n=3000, d=9)
    model = GLMModel.logistic(data)
    tuned = model.map_tuned(model.map_estimate(jr.key(1), steps=100))
    alg = api.firefly(tuned, kernel="rwmh", capacity=512, cand_capacity=512,
                      q_db=0.02, step_size=0.05, adapt_target="auto",
                      num_warmup=20, device="cuda")
    k_init, k_steps = jr.split(jr.key(7))
    state = alg.init(jr.split(k_init, 2),
                     torch.stack([alg.default_position] * 2))
    keys = jr.split(k_steps, 2)
    b0, z0 = bops.launch_count, zops.launch_count
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            state, stats = alg.step(keys, state)
            keys = state.rng
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bops.launch_count - b0 == 8 and zops.launch_count - z0 == 4
    assert bool(torch.isfinite(state.sampler.theta).all())
    assert bool(torch.isfinite(stats.joint_lp).all())


def test_flymc_hmc_step_never_waits_on_the_card(dev):
    """FlyMC HMC steps (K = 2, 3 leapfrog steps, gradients through the
    bright-GLM ``autograd.Function``) never make the host wait either."""
    data = logistic_data(jr.key(0), n=3000, d=9)
    model = GLMModel.logistic(data)
    tuned = model.map_tuned(model.map_estimate(jr.key(1), steps=100))
    alg = api.firefly(tuned, kernel="hmc", capacity=512, cand_capacity=512,
                      q_db=0.02, step_size=0.02, adapt_target="auto",
                      num_warmup=20, kernel_params=(("n_leapfrog", 3),),
                      device="cuda")
    k_init, k_steps = jr.split(jr.key(7))
    state = alg.init(jr.split(k_init, 2),
                     torch.stack([alg.default_position] * 2))
    keys = jr.split(k_steps, 2)
    b0, z0 = bops.launch_count, zops.launch_count
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            state, stats = alg.step(keys, state)
            keys = state.rng
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # a step: 3 leapfrog gradients, the end point, the candidates, the refresh
    assert bops.launch_count - b0 == 4 * 6 and zops.launch_count - z0 == 4
    assert bool(torch.isfinite(state.sampler.theta).all())
    assert bool(torch.isfinite(stats.joint_lp).all())


@pytest.mark.parametrize("family", ["logistic", "softmax", "student_t"])
@pytest.mark.parametrize("d", [9, 57, 256])
def test_bound_gradients_are_batch_invariant_on_card(dev, family, d):
    """On the card too, autograd's gradient of the collapsed bound does not
    change with the chain count (MALA's and HMC's batched == solo)."""
    assert_bound_gradients_batch_invariant(family, d, dev)


def _moved(tree, dev):
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    return type(tree)(*(_moved(a, dev) for a in tree))


@pytest.mark.parametrize("kernel", ["slice", "hmc"])
def test_slice_and_hmc_steps_on_card_match_the_cpu(dev, kernel):
    """One FlyMC step of each new θ-kernel on the card (the two kernels)
    and on the CPU (their plain versions) from the same state: the same
    decisions, density evaluations and partition, θ to rounding."""
    cpu = torch.device("cpu")
    if kernel == "slice":
        data, _ = robust_data(jr.key(0, device=cpu), n=3000, d=9, device=cpu)
        model = GLMModel.robust(data, device=cpu)
        kw = {"step_size": 0.05}
    else:
        model = GLMModel.logistic(logistic_data(jr.key(0, device=cpu), n=3000,
                                                d=9, device=cpu), device=cpu)
        kw = {"step_size": 0.02, "kernel_params": (("n_leapfrog", 4),)}
    th_map = model.map_estimate(jr.key(1, device=cpu), steps=100)
    tuned = model.map_tuned(th_map)
    on_card = dataclasses.replace(tuned, data=_moved(tuned.data, dev),
                                  stats=_moved(tuned.stats, dev))
    algs = [api.firefly(m, kernel=kernel, capacity=512, cand_capacity=512,
                        q_db=0.02, device=m.device, **kw)
            for m in (tuned, on_card)]
    k_init, k_steps = jr.split(jr.key(7, device=cpu))
    state = algs[0].init(jr.split(k_init, 2), torch.stack([th_map] * 2))
    keys = jr.split(k_steps, 2)
    for _ in range(3):
        outs = [alg.step(_moved(keys, d), _moved(state, d))
                for alg, d in zip(algs, (cpu, dev))]
        (ref, ref_stats), (new, stats) = outs
        assert torch.equal(stats.lik_queries.cpu(), ref_stats.lik_queries)
        assert torch.equal(stats.n_bright.cpu(), ref_stats.n_bright)
        assert torch.equal(new.bright.arr.cpu(), ref.bright.arr)
        moved_ref = (ref.sampler.theta != state.sampler.theta).any(-1)
        moved_new = (new.sampler.theta.cpu() != state.sampler.theta).any(-1)
        assert torch.equal(moved_new, moved_ref)
        torch.testing.assert_close(new.sampler.theta.cpu(), ref.sampler.theta,
                                   rtol=1e-5, atol=1e-6)
        state, keys = ref, ref.rng


def _run(model, cap, key, n_iter, **kw):
    alg = api.firefly(model, kernel="rwmh", capacity=cap, cand_capacity=cap,
                      q_db=0.02, step_size=0.05, adapt_target="auto",
                      num_warmup=20, device="cuda")
    return api.sample(alg, key, n_iter, device="cuda", **kw)


def test_chain_on_card_is_capacity_and_batching_invariant(dev):
    data = logistic_data(jr.key(0), n=3000, d=9)
    model = GLMModel.logistic(data)
    tuned = model.map_tuned(model.map_estimate(jr.key(1), steps=100))
    key = jr.key(7)
    b0, z0 = bops.launch_count, zops.launch_count
    big = _run(tuned, 512, key, 40, num_chains=2)
    assert bops.launch_count - b0 == 2 * big.steps_run + big.inits_run
    assert zops.launch_count - z0 == big.steps_run
    small = _run(tuned, 8, key, 40, num_chains=2, chunk_size=10)
    assert small.steps_run > 40
    assert torch.equal(big.theta, small.theta)
    k_init, k_steps = jr.split(key)
    init_keys, chain_keys = jr.split(k_init, 2), jr.split(k_steps, 2)
    alg = big.algorithm
    for c in range(2):
        st = alg.init(init_keys[c:c + 1], alg.default_position[None])
        one = api.sample(alg, chain_keys[c], 40, init_state=st, device="cuda")
        assert torch.equal(one.theta[0], big.theta[c])
    assert np.isfinite(big.theta.cpu().numpy()).all()


def _card_mix(dev, max_samples):
    """``benchmarks/_util.py::job_mix``'s five kinds at its default sizes
    (N = 2048, D = 16), JAX-free, on the kernel engines (the port's Job
    defaults), plus a logistic lane at capacity = N (N = 96)."""
    from repro_torch.data import softmax_data
    from repro_torch.serve import Job, TerminationPolicy

    n, d = 2048, 16
    fixed = TerminationPolicy(max_samples=max_samples)
    conv = TerminationPolicy(max_samples=max_samples, min_samples=8,
                             min_ess=max_samples / 3, check_every=2)

    def common(i, cap=max(32, n // 4)):
        return dict(seed=i, capacity=cap, cand_capacity=cap, num_warmup=100)

    key = lambda i: jr.key(i)
    return [
        Job(job_id="logistic-0", family="logistic",
            data=logistic_data(key(0), n=n, d=d), policy=fixed, **common(0)),
        Job(job_id="logistic2c-1", family="logistic", num_chains=2,
            data=logistic_data(key(1), n=n, d=d), policy=fixed, **common(1)),
        Job(job_id="softmax-2", family="softmax",
            data=softmax_data(key(2), n=n, d=d, k=3), policy=fixed,
            **common(2)),
        Job(job_id="robust-3", family="robust",
            data=robust_data(key(3), n=n, d=d)[0], policy=fixed, **common(3)),
        Job(job_id="logistic-conv-4", family="logistic", num_chains=2,
            data=logistic_data(key(4), n=n, d=d), policy=conv,
            collectors={"trace": api.FullTrace(), "rhat": api.RHat(),
                        "ess": api.BatchMeansESS()}, **common(4)),
        Job(job_id="logistic-full-5", family="logistic",
            data=logistic_data(key(5), n=96, d=d), policy=fixed,
            **common(5, cap=96)),
    ]


def _card_solo(job, chunk):
    """The job alone through ``api.sample``, stopped where the service's
    policy stops it."""
    from repro_torch.serve import build_algorithm

    p, seen = job.policy, {"chunks": 0}

    def stop(ev):
        seen["chunks"] += 1
        if p.min_ess is None or ev.committed < p.min_samples:
            return False
        if seen["chunks"] % p.check_every:
            return False
        ess = np.asarray(ev.peek("ess")["ess"], np.float64)
        return float(np.nansum(ess)) >= p.min_ess

    return api.sample(build_algorithm(job), jr.key(job.seed), p.max_samples,
                      num_chains=job.num_chains, chunk_size=chunk,
                      collectors=dict(job.collectors), on_chunk=stop).results


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if a is None or b is None:
        return a is None and b is None
    return bool(np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True))


def test_service_mix_packed_equals_solo_on_card(dev, monkeypatch):
    """The mix through ``Service`` on the card with a budget below its
    chains (jobs queue and join between chunks): every JobResult is
    bitwise the solo run's, and the kernels launched exactly what the
    engines' lane-steps and inits imply (two ``bright_glm`` a RWMH
    lane-step and one an init, one ``z_update`` a lane-step)."""
    from repro_torch.serve import Service
    from repro_torch.serve.scheduler import Scheduler

    chunk, jobs = 16, _card_mix(dev, 64)
    engines = []
    real = Scheduler._engine_for

    def record(self, *a, **kw):
        eng = real(self, *a, **kw)
        if all(e is not eng for e in engines):
            engines.append(eng)
        return eng

    monkeypatch.setattr(Scheduler, "_engine_for", record)
    svc = Service(slot_budget=6, chunk_size=chunk)
    b0, z0 = bops.launch_count, zops.launch_count
    for j in jobs:
        svc.submit(j)
    res = svc.run()
    steps = sum(e.lane_steps for e in engines)
    inits = sum(e.inits for e in engines)
    assert bops.launch_count - b0 == 2 * steps + inits
    assert zops.launch_count - z0 == steps > 0
    assert any(e.capacity == e._n for e in engines)  # the full lane ran
    for j in jobs:
        assert _same(res[j.job_id].results, _card_solo(j, chunk)), j.job_id


def test_group_chunk_waits_on_the_card_once(dev):
    """``GroupEngine.run_chunk`` without overflow makes the host wait on
    the card exactly once (the flags read), counted under
    ``set_sync_debug_mode("warn")``."""
    import warnings

    from repro_torch.serve import GroupEngine

    base = _card_mix(dev, 64)[0]
    jobs = [dataclasses.replace(base, job_id=f"l{i}", seed=i, capacity=2048,
                                cand_capacity=2048) for i in range(3)]
    eng = GroupEngine(jobs[0])
    for j in jobs:
        eng.admit(j)
    eng.run_chunk(4)  # warm
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            reruns = eng.run_chunk(8)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    waits = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert reruns == 0 and eng.waits == 2
    assert len(waits) == 1, [f"{w.filename}:{w.lineno}" for w in waits]


@pytest.mark.parametrize("b,h,hk,d,w,t,window,dtype", [
    (2, 8, 2, 128, 256, 200, None, torch.float32),
    (1, 4, 4, 64, 100, 80, 32, torch.bfloat16),  # W not a block multiple
    (2, 6, 2, 96, 130, 129, None, torch.float32),  # D not dividing 256
    (2, 32, 1, 128, 70, 9, None, torch.float32),  # G = 32, mostly empty ring
    (4, 16, 1, 256, 2048, 2400, 2048, torch.bfloat16),  # path, wrapped ring
    (4, 16, 1, 256, 2048, 1000, 2048, torch.bfloat16),  # path, partly filled
])
def test_decode_attention_kernel_matches_plain(dev, b, h, hk, d, w, t, window,
                                               dtype):
    g = torch.Generator().manual_seed(w + t)
    q = torch.randn(b, h, d, generator=g).to(dev)
    k = torch.randn(b, w, hk, d, generator=g).to(dtype).to(dev)
    v = torch.randn(b, w, hk, d, generator=g).to(dtype).to(dev)
    slots = torch.arange(w)
    pos = slots + torch.div(t - slots, w, rounding_mode="floor") * w
    pos = torch.where(pos >= 0, pos, -1).to(torch.int32).to(dev)
    before = aops.launch_count
    got = aops.decode_attention(q, k, v, pos, t, window)
    torch.cuda.synchronize()
    assert aops.launch_count == before + 1
    want = decode_attention_ref(q, k, v, pos, t, window)
    for a, b_ in zip(got, want):  # f32 sums in another order: 1e-5
        torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-5)


def test_decode_attention_kernel_fully_masked_row(dev):
    q = torch.randn(2, 4, 32, device=dev)
    k = torch.randn(2, 90, 2, 32, device=dev)
    v = torch.randn(2, 90, 2, 32, device=dev)
    pos = torch.full((90,), -1, dtype=torch.int32, device=dev)
    out, m, l = aops.decode_attention(q, k, v, pos, 5, None)
    want = decode_attention_ref(q, k, v, pos, 5, None)
    assert torch.all(m == -1e30) and torch.all(l == 90)
    torch.testing.assert_close(out, want[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,h,hk,d,w,t,window,dtype", [
    (4, 16, 1, 256, 2048, 1000, 2048, torch.float32),  # whole splits masked
    (4, 16, 1, 256, 2048, 2400, 2048, torch.float32),  # path, wrapped, f32
    (2, 8, 2, 128, 1000, 700, 64, torch.float32),  # W not a split multiple
    (1, 4, 1, 64, 4100, 4000, None, torch.bfloat16),  # 129 splits, ragged
    (1, 8, 1, 128, 20000, 19990, None, torch.bfloat16),  # 3 tiles a split
    (4, 16, 1, 256, 2048, 2048 // 2 - 24, 2048, torch.bfloat16),  # partial
])
def test_decode_attention_split_kernel_matches_plain(dev, b, h, hk, d, w, t,
                                                     window, dtype):
    """The ring split over many CTAs and merged in split order: whole splits
    masked, a ragged last split, splits longer than one tile, f32 and bf16
    K/V; against the plain version at 1e-5 (float32 sums in another
    order), and the same result on a second run."""
    split, n_split = aops.plan_splits(b * hk, w, aops.sm_count(dev.index))
    assert n_split > 1
    g = torch.Generator().manual_seed(w + t + 1)
    q = torch.randn(b, h, d, generator=g).to(dev)
    k = torch.randn(b, w, hk, d, generator=g).to(dtype).to(dev)
    v = torch.randn(b, w, hk, d, generator=g).to(dtype).to(dev)
    slots = torch.arange(w)
    pos = slots + torch.div(t - slots, w, rounding_mode="floor") * w
    pos = torch.where(pos >= 0, pos, -1).to(torch.int32).to(dev)
    before = aops.launch_count
    got = aops.decode_attention(q, k, v, pos, t, window)
    again = aops.decode_attention(q, k, v, pos, t, window)
    torch.cuda.synchronize()
    assert aops.launch_count == before + 2
    want = decode_attention_ref(q, k, v, pos, t, window)
    for a, a2, r in zip(got, again, want):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)
        assert torch.equal(a, a2)


def test_decode_attention_split_kernel_fully_masked_row(dev):
    """An empty ring cut into several splits: m = -1e30, l = W and out the
    mean of V, as the plain version gives."""
    w = 300
    assert aops.plan_splits(2, w, aops.sm_count(dev.index))[1] > 1
    q = torch.randn(2, 4, 64, device=dev)
    k = torch.randn(2, w, 1, 64, device=dev).to(torch.bfloat16)
    v = torch.randn(2, w, 1, 64, device=dev).to(torch.bfloat16)
    pos = torch.full((w,), -1, dtype=torch.int32, device=dev)
    out, m, l = aops.decode_attention(q, k, v, pos, 5, None)
    want = decode_attention_ref(q, k, v, pos, 5, None)
    assert torch.all(m == -1e30) and torch.all(l == w)
    torch.testing.assert_close(out, want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        out, v.float().mean(1).expand(2, 4, 64), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,s,c,log_a,with_h0", [
    (2, 64, 96, -1.0, False),
    (3, 37, 130, -0.3, True),  # C % 4 != 0: the cp.async route
    (2, 5, 36, -0.5, True),  # C % 32 != 0 on the TMA route, S < one stage
    (1, 2047, 4096, -5.25, False),  # S not a multiple of the stage
    (4, 2304, 4096, -5.25, False),  # the serving path, the model's decays
    (4, 2304, 4096, -1e-6, True),  # slowest decay the clip allows
])
def test_rglru_scan_kernel_matches_plain(dev, b, s, c, log_a, with_h0):
    g = torch.Generator().manual_seed(s)
    la = (log_a * (0.9 + 0.2 * torch.rand(b, s, c, generator=g))).to(dev)
    bx = torch.randn(b, s, c, generator=g).to(dev)
    h0 = torch.randn(b, c, generator=g).to(dev) if with_h0 else None
    before = rops.launch_count
    y, hf = rops.rglru_scan(la, bx, h0)
    torch.cuda.synchronize()
    assert rops.launch_count == before + 1
    y_ref, hf_ref = rglru_ref(la, bx, h0)
    assert torch.isfinite(y).all()
    # the same float32 operations in the same order as the plain loop
    torch.testing.assert_close(y, y_ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(hf, hf_ref, rtol=1e-6, atol=1e-6)


def _rglru_inputs(b, s, c, log_a, dev, seed):
    g = torch.Generator().manual_seed(seed)
    la = (log_a * (0.9 + 0.2 * torch.rand(b, s, c, generator=g))).to(dev)
    bx = torch.randn(b, s, c, generator=g).to(dev)
    h0 = torch.randn(b, c, generator=g).to(dev)
    gh = torch.randn(b, s, c, generator=g).to(dev)
    gl = torch.randn(b, c, generator=g).to(dev)
    return la, bx, h0, gh, gl


@pytest.mark.parametrize("b,s,c", [(2, 300, 64), (3, 37, 130), (2, 5, 36)])
def test_rglru_scan_kernel_h_final_and_split_bitwise(dev, b, s, c):
    """h_final is bitwise y[:, -1]; scanning [0, s0) and then [s0, S) from
    the first part's h_final is bitwise one scan of [0, S), on both routes
    (C = 130 stages by cp.async), with the split inside a stage."""
    la, bx, h0, _, _ = _rglru_inputs(b, s, c, -0.7, dev, seed=s + c)
    for first in (None, h0):
        y, hf = rops.rglru_scan(la, bx, first)
        assert torch.equal(hf, y[:, -1])
        s0 = s // 3 + 1
        y1, h1 = rops.rglru_scan(la[:, :s0].contiguous(),
                                 bx[:, :s0].contiguous(), first)
        y2, h2 = rops.rglru_scan(la[:, s0:].contiguous(),
                                 bx[:, s0:].contiguous(), h1)
        assert torch.equal(torch.cat([y1, y2], 1), y)
        assert torch.equal(h2, hf)


@pytest.mark.parametrize("b,s,c", [(2, 2047, 4096), (3, 37, 130)])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("with_g_last", [False, True])
def test_rglru_scan_bwd_kernel_matches_plain_bitwise(dev, b, s, c, with_h0,
                                                     with_g_last):
    """The backward kernel against ``rglru_bwd_ref`` on the card, at the
    training path's shape (the TMA route) and a ragged one (C = 130, the
    cp.async route): bitwise. Both take the same float32 operations in the
    same order — expf against torch's exp, each multiply and add rounded —
    so nothing is left to a tolerance. g_last None is a zero cotangent."""
    la, bx, h0, gh, gl = _rglru_inputs(b, s, c, -5.25 if s > 100 else -0.4,
                                       dev, seed=7 * s + c)
    h0 = h0 if with_h0 else None
    gl = gl if with_g_last else None
    h, _ = rglru_ref(la, bx, h0)
    before = (rops.launch_count, rops.bwd_launch_count)
    got = rops.rglru_scan_backward(la, h, h0, gh, gl)
    torch.cuda.synchronize()
    assert (rops.launch_count, rops.bwd_launch_count) == (before[0] + 1,
                                                          before[1] + 1)
    want = rglru_bwd_ref(la, h, h0, gh, gl)
    assert got[2] is None if h0 is None else torch.equal(got[2], want[2])
    for a, w in zip(got[:2], want[:2]):
        assert torch.isfinite(a).all()
        assert torch.equal(a, w), float((a - w).abs().max())
    d_la, d_bx, d_h0 = rops.rglru_scan_backward(la, h, h0, gh, gl,
                                                needs=(False, True, False))
    assert d_la is None and d_h0 is None and torch.equal(d_bx, want[1])


def _rglru_kernels_a_call(direction):
    """The device kernels of each of 10 traced rglru wrapper calls (see
    :func:`_device_kernels`), the calls made and the launches counted."""
    la, bx, h0, gh, gl = _rglru_inputs(2, 2047, 4096, -5.25,
                                        torch.device("cuda"), seed=5)
    if direction == "forward":
        fn = lambda: rops.rglru_scan(la, bx, h0)
    else:
        h, _ = rops.rglru_scan(la, bx, h0)
        fn = lambda: rops.rglru_scan_backward(la, h, h0, gh, None)
    before = rops.launch_count
    calls, made = _device_kernels(fn, reps=10)
    return calls, made, rops.launch_count - before


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_rglru_scan_one_kernel_per_call(dev, direction):
    """Each wrapper call runs exactly one device kernel under its own name:
    the backward's reversal, decays and products live in the kernel, with no
    other tensor op.

    The calls are traced in a process of their own. In a process that has
    already run the FlyMC kernels' profiler checks above, the profiler
    records the first traced rglru call and then nothing, however often a
    call is retraced; a fresh process records every call, and so does the
    same process one test later. The trace, not the kernel, is what the
    earlier tests disturb, so this test does not share their process.
    """
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    here = Path(__file__).resolve().parent
    path = os.pathsep.join([str(here.parent / "src"), str(here)]
                           + [os.environ.get("PYTHONPATH", "")])
    code = ("import json, test_torch_cuda as t\n"
            f"print(json.dumps(t._rglru_kernels_a_call({direction!r})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=path))
    assert out.returncode == 0, out.stderr[-4000:]
    calls, made, launched = json.loads(out.stdout.strip().splitlines()[-1])
    name = ("rglru_scan_kernel" if direction == "forward"
            else "rglru_scan_bwd_kernel")
    assert launched == made
    assert all(len(c) == 1 and name in c[0] for c in calls), calls


def test_serve_full_width_on_card(dev):
    """recurrentgemma-9b at its published width, bf16, a prompt longer than
    the 2048 window: 26 scan launches in the prefill, 12 flash-decode
    launches per decode step."""
    a0, r0 = aops.launch_count, rops.launch_count
    ids, stats = serve("recurrentgemma-9b", batch=4, prompt_len=2304, gen=2,
                       seed=0, full=True, dtype=torch.bfloat16, device=dev)
    assert rops.launch_count - r0 == 26
    assert aops.launch_count - a0 == 12
    assert ids.shape == (4, 2) and bool(((ids >= 0) & (ids < 256000)).all())
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0
    torch.cuda.empty_cache()


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-7b"])
def test_decode_step_never_waits_on_the_card(dev, arch):
    """Decode steps of the reduced twin issue their work without making the
    host wait for the device (no host-to-device copy of a Python scalar, no
    read-back): under ``set_sync_debug_mode("error")`` a synchronising call
    raises. The prompt is longer than the reduced window: the ring wraps."""
    cfg = get_reduced(arch)
    model = T.init_model(cfg, 0, dev, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(5)
    prompt, steps = 40, 4
    prompts = torch.randint(0, cfg.vocab_size, (2, prompt), generator=gen,
                            device=dev)
    with torch.inference_mode():
        cache, h = SV.prefill(model, prompts, prompt + steps,
                              dtype=torch.bfloat16, kv_dtype=torch.bfloat16)
        tok = SV.vocab_parallel_argmax((h[:, -1:] @ model.embed.head).float())
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(steps):
                tok, _, cache = SV.decode_step(model, cache, tok,
                                               prompt + steps, torch.bfloat16)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert cache["t"] == prompt + steps
    assert bool(((tok >= 0) & (tok < cfg.vocab_size)).all())


@pytest.mark.parametrize("b,h,s,d,chunk,logw,with_s0", [
    (2, 3, 64, 16, 16, None, False),
    (2, 4, 96, 32, 32, None, True),  # the reduced model's heads
    (1, 2, 33, 48, 64, None, True),  # c = 33, D not a power of two
    (2, 2, 5, 8, 1, None, True),  # c = 1
    (4, 64, 32, 64, 64, None, True),  # S = 32: c = 32
    (1, 4, 128, 64, 64, -1.0, True),  # edge decay: e^{±64}
    (4, 64, 512, 64, 64, None, True),  # the serving path's time chunk
    (2, 4, 448, 64, 64, None, True),  # 7 chunks: S carried across sweeps
    (2, 3, 40, 5, 8, None, True),  # D % 4 != 0: 4-byte staging, c = 8
])
def test_rwkv6_scan_kernel_matches_plain(dev, b, h, s, d, chunk, logw,
                                         with_s0):
    g = torch.Generator().manual_seed(s * d)
    r, k, v = (torch.randn(b, h, s, d, generator=g).to(dev) for _ in range(3))
    lw = (torch.full((b, h, s, d), logw) if logw is not None
          else -(1e-6 + (1 - 1e-6) * torch.rand(b, h, s, d, generator=g)))
    lw = lw.to(dev)
    u = torch.randn(h, d, generator=g).to(dev)
    s0 = torch.randn(b, h, d, d, generator=g).to(dev) if with_s0 else None
    before = wops.launch_count
    y, st = wops.rwkv6_scan(r, k, v, lw, u, s0, chunk=chunk)
    torch.cuda.synchronize()
    assert wops.launch_count == before + 1
    y_ref, st_ref = rwkv6_chunked_ref(r, k, v, lw, u, s0, chunk)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    # 3xTF32 products and float32 sums in another order, scaled by
    # e^{±cumsum logw}: 1e-5 relative, plus 1e-5 of the largest value for
    # entries near zero
    for a, ref in ((y, y_ref), (st, st_ref)):
        torch.testing.assert_close(a, ref, rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()))


def test_serve_rwkv_reduced_on_card(dev):
    """The reduced rwkv6 twin through ``serve`` on the card, float32: one
    WKV launch per layer and 512-step time chunk of the prefill, none in
    decode; the first token is the argmax of the model's forward over the
    prompt."""
    w0 = wops.launch_count
    ids, _ = serve("rwkv6-7b", batch=2, prompt_len=1024, gen=3, seed=3,
                   dtype=torch.float32, device=dev)
    assert wops.launch_count - w0 == 2 * 2  # 2 layers × 2 time chunks
    assert ids.shape == (2, 3) and bool(((ids >= 0) & (ids < 512)).all())
    model = T.init_model(get_reduced("rwkv6-7b"), 3, dev, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(4)
    prompts = torch.randint(0, 512, (2, 1024), generator=gen, device=dev)
    with torch.inference_mode():
        h = T.forward_hidden(model, prompts, torch.float32)
    assert torch.equal((h[:, -1] @ model.embed.head).argmax(-1).cpu(),
                       ids[:, 0])


@pytest.mark.parametrize("t,d,v,dtype", [
    (64, 128, 512, torch.float32),  # the reduced model's (B·S, d) × vocab
    (37, 64, 1000, torch.bfloat16),  # ragged token tile and vocab tile
    (300, 256, 4096, torch.bfloat16),  # 4 vocab splits, 3 token tiles
    (130, 4096, 256000, torch.bfloat16),  # the full vocab and width
])
def test_fused_ce_kernel_matches_plain(dev, t, d, v, dtype):
    g = torch.Generator().manual_seed(t + v)
    x = torch.randn(t, d, generator=g).to(dtype).to(dev)
    w = (torch.randn(d, v, generator=g) / d**0.5).to(dtype).to(dev)
    lab = torch.randint(0, v, (t,), generator=g)
    # the vocab's first and last columns and both sides of a split boundary
    lab[:4] = torch.tensor([0, v - 1, min(1023, v - 1), min(1024, v - 1)])
    lab = lab.to(dev)
    before = cops.launch_count
    lse, tgt = cops.lse_and_target(x, w, lab)
    torch.cuda.synchronize()
    assert cops.launch_count == before + 1
    lse_ref, tgt_ref = fused_ce_ref(x, w, lab)
    # float32 sums of D products in another order; values O(10)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-4)
    torch.testing.assert_close(tgt, tgt_ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("t,d,v", [
    (1, 64, 1000),  # one token; V not a multiple of the 256-column tile
    (129, 64, 1000),  # a ragged token tile
    (37, 200, 1000),  # D not a multiple of the 64-deep stage
    (129, 4096, 2056),  # two split boundaries, a ragged last tile
    (4095, 64, 3000),  # the path's ragged T
    (4095, 4096, 1000),  # the path's ragged T and width
])
def test_fused_ce_wgmma_matches_plain(dev, t, d, v):
    """The bf16 kernel (TMA-fed wgmma) at ragged T, V and D, with labels at
    the vocab's ends, at 256-column tile edges and at 1024-column split
    edges; lse and tgt against the plain version at 1e-4 (float32 sums of
    D products in another order; values O(10))."""
    g = torch.Generator().manual_seed(t * 7 + d + v)
    x = torch.randn(t, d, generator=g).to(torch.bfloat16).to(dev)
    w = (torch.randn(d, v, generator=g) / d**0.5).to(torch.bfloat16).to(dev)
    lab = torch.randint(0, v, (t,), generator=g)
    edges = [0, v - 1, 255, 256, 511, 512, 1023, 1024, 2047, 2048]
    edges = [e for e in edges if e < v][:t]
    lab[:len(edges)] = torch.tensor(edges)
    lab = lab.to(dev)
    before = cops.launch_count
    lse, tgt = cops.lse_and_target(x, w, lab)
    torch.cuda.synchronize()
    assert cops.launch_count == before + 1
    lse_ref, tgt_ref = fused_ce_ref(x, w, lab)
    assert torch.isfinite(lse).all() and torch.isfinite(tgt).all()
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-4)
    torch.testing.assert_close(tgt, tgt_ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("t,d,v", [
    (129, 64, 1000),  # a ragged token tile
    (37, 200, 1000),  # D not a multiple of the 64-deep stage
    (4095, 4096, 1000),  # the path's ragged T and width
])
def test_fused_ce_round_logits_matches_plain(dev, t, d, v):
    """The bf16 kernel's rounding mode (each logit rounded to bf16 before
    the softmax: the model's bf16 loss) against the plain version at ragged
    T. lse and tgt within 1e-4 on at least 99% of the tokens, and within
    1e-4 plus one bf16 ulp of the largest |logit| on every token: the two
    float32 sums may round a logit to neighbouring bf16 values. The mode
    reaches the kernel: its tgt differs from the float32-products mode's."""
    g = torch.Generator().manual_seed(t * 11 + d + v)
    x = torch.randn(t, d, generator=g).to(torch.bfloat16).to(dev)
    w = (torch.randn(d, v, generator=g) / d**0.5).to(torch.bfloat16).to(dev)
    lab = torch.randint(0, v, (t,), generator=g)
    edges = [0, v - 1, 255, 256, 511, 512]
    lab[:len(edges)] = torch.tensor(edges)
    lab = lab.to(dev)
    before = cops.launch_count
    lse, tgt = cops.lse_and_target(x, w, lab, round_logits=True)
    torch.cuda.synchronize()
    assert cops.launch_count == before + 1
    lse_ref, tgt_ref = fused_ce_ref(x, w, lab, round_logits=True)
    top = float((x.float() @ w.float()).abs().max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    for a, ref in ((lse, lse_ref), (tgt, tgt_ref)):
        assert torch.isfinite(a).all()
        err = (a - ref).abs()
        assert float((err > 1e-4).float().mean()) <= 0.01
        assert float(err.max()) <= 1e-4 + ulp
    _, tgt_products = cops.lse_and_target(x, w, lab)
    assert float(((tgt - tgt_products).abs() > 1e-4).float().mean()) > 0.5


def test_fused_ce_gradient_on_card(dev):
    """FusedCE's backward on the card against autograd through the plain
    version, float32, with a chunk boundary inside the tokens."""
    g = torch.Generator().manual_seed(5)
    t, d, v = 300, 128, 2048
    x = torch.randn(t, d, generator=g).to(dev).requires_grad_()
    w = (torch.randn(d, v, generator=g) / d**0.5).to(dev).requires_grad_()
    lab = torch.randint(0, v, (t,), generator=g).to(dev)
    c = torch.rand(t, generator=g).to(dev)
    (cops.fused_ce(x, w, lab) * c).sum().backward()
    x2, w2 = x.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
    lse, tgt = fused_ce_ref(x2, w2, lab)
    ((lse - tgt) * c).sum().backward()
    for a, ref in ((x.grad, x2.grad), (w.grad, w2.grad)):
        torch.testing.assert_close(a, ref, rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("log_a,with_h0", [(-5.25, False), (-1e-6, True)])
def test_rglru_scan_gradient_on_card(dev, log_a, with_h0):
    """RGLRUScan's backward is one launch of the backward kernel; its
    gradients match autograd through the plain loop."""
    g = torch.Generator().manual_seed(3)
    b, s, c = 2, 200, 96
    la = (log_a * (0.9 + 0.2 * torch.rand(b, s, c, generator=g))).to(dev)
    bx = torch.randn(b, s, c, generator=g).to(dev)
    h0 = torch.randn(b, c, generator=g).to(dev) if with_h0 else None
    gh = torch.randn(b, s, c, generator=g).to(dev)
    gl = torch.randn(b, c, generator=g).to(dev)
    ins = [a.clone().requires_grad_() for a in (la, bx)] + (
        [h0.clone().requires_grad_()] if with_h0 else [])
    before, bwd_before = rops.launch_count, rops.bwd_launch_count
    y, hf = rops.rglru_scan(*ins[:2], ins[2] if with_h0 else None)
    ((y * gh).sum() + (hf * gl).sum()).backward()
    torch.cuda.synchronize()
    assert rops.launch_count == before + 2
    assert rops.bwd_launch_count == bwd_before + 1
    ref_ins = [a.clone().requires_grad_() for a in (la, bx)] + (
        [h0.clone().requires_grad_()] if with_h0 else [])
    y2, hf2 = rglru_ref(*ref_ins[:2], ref_ins[2] if with_h0 else None)
    ((y2 * gh).sum() + (hf2 * gl).sum()).backward()
    for a, ref in zip(ins, ref_ins):
        torch.testing.assert_close(a.grad, ref.grad, rtol=1e-5,
                                   atol=1e-5 * float(ref.grad.abs().max()))


def test_kernels_without_backward_raise_under_autograd(dev):
    r, k, v, lw = (torch.randn(1, 2, 8, 16, device=dev) for _ in range(4))
    lw = -lw.abs().clamp(1e-6, 1.0)
    u = torch.randn(2, 16, device=dev)
    with pytest.raises(NotImplementedError, match="item 9b"):
        wops.rwkv6_scan(r.requires_grad_(), k, v, lw, u)
    with torch.no_grad():
        wops.rwkv6_scan(r, k, v, lw, u)  # no graph: the kernel runs
    q = torch.randn(1, 4, 64, device=dev, requires_grad=True)
    kv = torch.randn(1, 16, 1, 64, device=dev)
    pos = torch.arange(16, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="step 4d"):
        aops.decode_attention(q, kv, kv, pos, 15)


def test_train_reduced_on_card(dev):
    """The reduced recurrentgemma twin through ``train_reduced`` on the
    card: one fused_ce launch and 4 RG-LRU layers × (forward + backward)
    scan launches per step, and a finite loss."""
    c0, r0 = cops.launch_count, rops.launch_count
    _, hist = train_reduced("recurrentgemma-9b", steps=2, batch=2, seq=65,
                            warmup_steps=1, dtype=torch.bfloat16, device=dev)
    assert cops.launch_count - c0 == 2
    assert rops.launch_count - r0 == 2 * 4 * 2  # 4 rglru layers in 6
    assert all(np.isfinite(h["loss"]) for h in hist)


# ---------------------------------------------------------- checkpointing


def _card_tree(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(64, 33, generator=g, device=dev)
    return {"f32": x, "bf16": x.to(torch.bfloat16),
            "i64": torch.arange(70, device=dev) * 2**40,
            "mask": x > 0, "count": 17, "job_id": "robust-3"}


def test_checkpoint_card_tree_restores_bitwise_on_card_and_cpu(dev, tmp_path):
    """A tree saved from the card restores bitwise onto the card (its
    target's device) and onto ``device="cpu"``; host values stay Python
    values."""
    from repro_torch.checkpoint import Checkpointer

    tree = _card_tree(dev)
    ck = Checkpointer(tmp_path)
    ck.save(1, tree, blocking=True)
    target = {k: torch.zeros_like(v) if isinstance(v, torch.Tensor) else
              type(v)() for k, v in tree.items()}
    for device, kind in ((None, dev.type), ("cpu", "cpu")):
        got, _ = ck.restore(target, device=device)
        assert got["count"] == 17 and got["job_id"] == "robust-3"
        for k in ("f32", "bf16", "i64", "mask"):
            assert got[k].device.type == kind and got[k].dtype == tree[k].dtype
            assert torch.equal(got[k].cpu(), tree[k].cpu()), k


def test_checkpoint_snapshot_on_card_is_taken_before_save_returns(dev,
                                                                  tmp_path):
    """An async save of card tensors, the writer held until the tensors are
    written in place on the stream: what lands on disk is the value at
    ``save`` time."""
    import threading

    from repro_torch.checkpoint import Checkpointer

    tree = _card_tree(dev)
    want = {k: tree[k].to("cpu", copy=True) for k in ("f32", "bf16", "i64")}
    ck = Checkpointer(tmp_path)
    go = threading.Event()
    ck._kill_hook = lambda p: go.wait(30) if p == "begin" else None
    ck.save(1, tree)
    for k in want:
        tree[k].add_(1)  # queued on the stream after save returned
    torch.cuda.synchronize()
    go.set()
    ck.wait()
    got, _ = ck.restore({k: torch.zeros_like(tree[k]) for k in want})
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


def test_service_checkpoint_restore_on_card_is_bitwise(dev, tmp_path):
    """The card mix through a service that checkpoints after its first
    step; a service restored from that checkpoint on the card runs to
    results bitwise the uninterrupted run's, launching both kernels."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.serve import Service
    from repro_torch.testing import chaos

    chunk = 16
    ref_svc = Service(slot_budget=6, chunk_size=chunk)
    for j in _card_mix(dev, 48):
        ref_svc.submit(j)
    ref = ref_svc.run()
    svc = Service(slot_budget=6, chunk_size=chunk,
                  checkpointer=Checkpointer(tmp_path), checkpoint_every=1)
    for j in _card_mix(dev, 48):
        svc.submit(j)
    svc.step()
    del svc
    restored = Service.restore(Checkpointer(tmp_path))
    assert restored.restored_from_step == 1 and len(restored._jobs) >= 4
    chaos.resubmit(restored, _card_mix(dev, 48), {})  # queued at the save
    b0, z0 = bops.launch_count, zops.launch_count
    res = restored.run()
    assert bops.launch_count > b0 and zops.launch_count > z0
    assert set(res) == set(ref)
    for job_id, r in ref.items():
        assert res[job_id].committed == r.committed, job_id
        assert _same(res[job_id].results, r.results), job_id
