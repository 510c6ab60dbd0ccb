"""The port's CUDA kernels on the card: each against its plain version, the
exactness contracts of a short chain run on the device, one slice and one
HMC step on the card against the CPU, the full-width
recurrentgemma serving path, the rwkv6 serving path, the training path
(the ``FusedCE``, ``RGLRUScan`` and ``RWKV6Scan`` gradients, the reduced
trainers of recurrentgemma and rwkv6), the
SP-mode families' training (dense, MoE, encdec, VLM twins against the CPU,
``remat``, ``fused_ce`` at their heads, bf16 AdamW moments), and
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
from repro_torch.kernels.rwkv6_scan.ref import (rwkv6_bwd_chunks_ref,
                                                 rwkv6_bwd_ds_ref,
                                                 rwkv6_bwd_du_ref,
                                                 rwkv6_bwd_ref,
                                                 rwkv6_bwd_split_ref,
                                                 rwkv6_chunked_ref)
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


def _device_kernels(fn, reps=10, tries=5, expect=1):
    """Names of the device activities (kernels, copies, memsets) that each
    of ``reps`` warm calls of ``fn`` puts on the card, from one profiler
    trace a call. The profiler now and then records nothing for a call, or
    fewer than the ``expect`` kernels its wrapper launched (counted apart
    by the wrapper); such a call is traced again, up to ``tries`` times.
    Returns the names a call and the number of calls made, the warm one and
    the retraced included."""
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
            if len(names) >= expect:
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


def _in_own_process(call: str):
    """``call`` (an expression over this module's names, returning JSON
    data) evaluated in a fresh Python process, and its result. Profiler
    traces that must not follow earlier traces of this process run so."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    here = Path(__file__).resolve().parent
    path = os.pathsep.join([str(here.parent / "src"), str(here)]
                           + [os.environ.get("PYTHONPATH", "")])
    code = ("import json, test_torch_cuda as t\n"
            f"print(json.dumps(t.{call}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=path))
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


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
    calls, made, launched = _in_own_process(
        f"_rglru_kernels_a_call({direction!r})")
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


def _rwkv6_grad_inputs(b, h, s, d, logw, dev, seed):
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn(b, h, s, d, generator=g) for _ in range(3))
    lw = (torch.full((b, h, s, d), logw) if logw is not None
          else -(1e-6 + (1 - 1e-6) * torch.rand(b, h, s, d, generator=g)))
    u = torch.randn(h, d, generator=g)
    s0 = torch.randn(b, h, d, d, generator=g)
    dy = torch.randn(b, h, s, d, generator=g)
    ds = torch.randn(b, h, d, d, generator=g)
    return [a.to(dev) for a in (r, k, v, lw, u, s0, dy, ds)]


def _close_to_largest(got, want, tol=1e-4):
    """Within ``tol`` relative plus ``tol`` of the largest value: float32
    sums in another order, scaled by e^{±cumsum logw}; dlogw's reverse
    cumulative sum cancels terms."""
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=tol,
                               atol=tol * float(want.abs().max()))


@pytest.mark.parametrize("b,h,s,d,chunk,logw,with_s0,with_ds", [
    (2, 64, 512, 64, 64, None, True, True),  # the training path's shape
    (2, 64, 512, 64, 64, -1.0, True, True),  # edge decay: e^{±64}
    (2, 64, 32, 64, 64, None, True, True),  # S = 32: c = 32
    (2, 64, 1, 64, 64, None, True, True),  # a single step
    (2, 4, 1024, 32, 64, None, False, False),  # the twin's heads, no d_state
    (1, 2, 33, 48, 64, None, True, False),  # c = 33, D not a power of two
    (2, 3, 40, 5, 8, None, True, True),  # D % 4 != 0, c = 8
    (1, 2, 64, 40, 64, None, True, True),  # one chunk, D = 40
    (2, 3, 192, 40, 64, None, False, True),  # three chunks, D = 40, no state0
    (1, 2, 96, 16, 32, None, True, False),  # c = 32 < 64, three chunks
    (2, 2, 48, 40, 16, None, False, False),  # c = 16, D = 40, neither
])
def test_rwkv6_scan_bwd_kernel_matches_plain(dev, b, h, s, d, chunk, logw,
                                             with_s0, with_ds):
    """The forward kernel's saved chunk states and the backward kernels
    against ``rwkv6_bwd_ref`` (same states) and against autograd through
    ``rwkv6_chunked_ref`` on the card; y and the final state of the
    state-saving forward bitwise the serving kernel's; the backward two
    launches and bitwise on a second call."""
    r, k, v, lw, u, s0, dy, ds = _rwkv6_grad_inputs(b, h, s, d, logw, dev,
                                                    seed=s * d + h)
    s0 = s0 if with_s0 else None
    ds = ds if with_ds else None
    c = min(chunk, s)
    y, st, states = wops._launch(r, k, v, lw, u, s0, c, save_states=True)
    y0, st0 = wops.rwkv6_scan(r, k, v, lw, u, s0, chunk=chunk)
    assert torch.equal(y, y0) and torch.equal(st, st0)
    _, _, ref_states = rwkv6_chunked_ref(r, k, v, lw, u, s0, c,
                                         return_states=True)
    _close_to_largest(states, ref_states, 1e-5)
    before = (wops.launch_count, wops.bwd_launch_count)
    got = wops.rwkv6_scan_backward(r, k, v, lw, u, states, dy, ds, chunk,
                                   want_dstate0=with_s0)
    again = wops.rwkv6_scan_backward(r, k, v, lw, u, states, dy, ds, chunk,
                                     want_dstate0=with_s0)
    torch.cuda.synchronize()
    assert (wops.launch_count, wops.bwd_launch_count) == (before[0] + 4,
                                                          before[1] + 4)
    assert (got[5] is None) == (not with_s0)
    for a, a2 in zip(got, again):
        assert a is None or torch.equal(a, a2)
    want = rwkv6_bwd_ref(r, k, v, lw, u, states, dy, ds, c)
    for a, w in zip(got, want):
        if a is not None:
            _close_to_largest(a, w)
    ins = [a.clone().requires_grad_() for a in (r, k, v, lw, u)] + (
        [s0.clone().requires_grad_()] if with_s0 else [])
    y2, st2 = rwkv6_chunked_ref(*ins[:5], ins[5] if with_s0 else None, c)
    out = (y2 * dy).sum() + ((st2 * ds).sum() if with_ds else 0.0)
    for a, w in zip(got, torch.autograd.grad(out, ins)):
        _close_to_largest(a, w)


def test_rwkv6_scan_gradient_on_card(dev):
    """``rwkv6_scan`` under autograd on the card: one forward and two
    backward launches, an unused final state's cotangent taken as zeros,
    the gradients of every input those of the plain version."""
    r, k, v, lw, u, s0, dy, _ = _rwkv6_grad_inputs(2, 4, 128, 32, None, dev,
                                                   seed=11)
    ins = [a.clone().requires_grad_() for a in (r, k, v, lw, u, s0)]
    before = (wops.launch_count, wops.bwd_launch_count)
    y, _ = wops.rwkv6_scan(*ins)
    (y * dy).sum().backward()
    torch.cuda.synchronize()
    assert (wops.launch_count, wops.bwd_launch_count) == (before[0] + 3,
                                                          before[1] + 2)
    ref = [a.clone().requires_grad_() for a in (r, k, v, lw, u, s0)]
    (rwkv6_chunked_ref(*ref)[0] * dy).sum().backward()
    for a, w in zip(ins, ref):
        _close_to_largest(a.grad, w.grad)


def _rwkv6_bwd_kernels_a_call():
    """The device kernels of each of 10 traced backward calls at the
    training path's shape (see :func:`_device_kernels`), the calls made and
    the backward launches counted (two a call)."""
    r, k, v, lw, u, s0, dy, ds = _rwkv6_grad_inputs(
        2, 64, 512, 64, None, torch.device("cuda"), seed=3)
    _, _, states = wops._launch(r, k, v, lw, u, s0, 64, save_states=True)
    fn = lambda: wops.rwkv6_scan_backward(r, k, v, lw, u, states, dy, ds)
    before = wops.bwd_launch_count
    calls, made = _device_kernels(fn, reps=10, expect=2)
    return calls, made, wops.bwd_launch_count - before


def test_rwkv6_scan_bwd_one_kernel_per_call(dev):
    """A backward call runs exactly two device kernels, in order,
    ``rwkv6_scan_bwd_ds_kernel`` and ``rwkv6_scan_bwd_chunk_kernel``: du's
    sum over batch rows is in them, and outputs and the dS scratch are
    allocated, not cleared (traced in a process of its own, as
    :func:`test_rglru_scan_one_kernel_per_call`)."""
    calls, made, launched = _in_own_process("_rwkv6_bwd_kernels_a_call()")
    assert launched == 2 * made
    assert all(len(c) == 2 and "rwkv6_scan_bwd_ds_kernel" in c[0]
               and "rwkv6_scan_bwd_chunk_kernel" in c[1]
               for c in calls), calls


@pytest.mark.parametrize("b,h,s,d,chunk,logw,with_ds", [
    (2, 64, 512, 64, 64, None, True),  # the training path's shape
    (2, 64, 512, 64, 64, -1.0, True),  # edge decay: e^{±64}
    (2, 64, 1, 64, 64, None, True),  # a single step
    (1, 2, 64, 40, 64, None, False),  # one chunk, D = 40, no d_state
    (2, 3, 192, 40, 64, None, True),  # three chunks, D = 40
    (1, 2, 96, 16, 32, None, True),  # c = 32 < 64
    (2, 3, 40, 5, 8, None, False),  # D % 4 != 0, c = 8
])
def test_rwkv6_scan_bwd_passes_match_their_plain_pieces(dev, b, h, s, d,
                                                        chunk, logw,
                                                        with_ds):
    """Each backward kernel against its own plain piece: the dS pass's
    scratch (dS leaving each chunk) and dstate0 against
    ``rwkv6_bwd_ds_ref``, its per-row du partials summed against
    ``rwkv6_bwd_du_ref``; the chunk pass, fed the kernel's own dS, against
    ``rwkv6_bwd_chunks_ref``; the composition ``rwkv6_bwd_split_ref``
    against ``rwkv6_bwd_ref``. 1e-4 relative plus 1e-4 of the largest
    value."""
    r, k, v, lw, u, s0, dy, ds = _rwkv6_grad_inputs(b, h, s, d, logw, dev,
                                                    seed=s * d + h + 1)
    ds = ds if with_ds else None
    c = min(chunk, s)
    _, _, states = wops._launch(r, k, v, lw, u, s0, c, save_states=True)
    grads, ds_all, du_part = wops._launch_bwd(r, k, v, lw, u, states, dy, ds,
                                              c, True, return_scratch=True)
    torch.cuda.synchronize()
    want_ds, want_ds0 = rwkv6_bwd_ds_ref(r, lw, dy, ds, c)
    _close_to_largest(ds_all, want_ds)
    _close_to_largest(grads[5], want_ds0)
    du = rwkv6_bwd_du_ref(r, k, v, dy)
    _close_to_largest(du_part.sum(0), du)
    _close_to_largest(grads[4], du)
    want = rwkv6_bwd_chunks_ref(r, k, v, lw, u, states, ds_all, dy, c)
    for a, w in zip(grads[:4], want):
        _close_to_largest(a, w)
    for a, w in zip(rwkv6_bwd_split_ref(r, k, v, lw, u, states, dy, ds, c),
                    rwkv6_bwd_ref(r, k, v, lw, u, states, dy, ds, c)):
        _close_to_largest(a, w)


def test_rwkv6_scan_bwd_is_bitwise_on_repeat(dev):
    """Two backward calls at the training path's shape give the same bits:
    every gradient, the dS scratch and du's partials (no atomics; every sum
    in a fixed order)."""
    r, k, v, lw, u, s0, dy, ds = _rwkv6_grad_inputs(2, 64, 512, 64, None,
                                                    dev, seed=27)
    _, _, states = wops._launch(r, k, v, lw, u, s0, 64, save_states=True)
    one = wops._launch_bwd(r, k, v, lw, u, states, dy, ds, 64, True,
                           return_scratch=True)
    two = wops._launch_bwd(r, k, v, lw, u, states, dy, ds, 64, True,
                           return_scratch=True)
    torch.cuda.synchronize()
    for a, a2 in zip((*one[0], *one[1:]), (*two[0], *two[1:])):
        assert torch.equal(a, a2)


@pytest.mark.parametrize("remat", [False, True])
def test_train_rwkv_reduced_on_card(dev, remat):
    """The reduced rwkv6 twin (2 layers, 4 heads × 32) through
    ``train_reduced`` on the card, 2 × 1024 tokens: a step makes one
    ``fused_ce`` launch, 2 layers × 2 time chunks WKV backward calls (two
    kernel launches each) and as many forwards (twice as many under
    ``remat``: each one-layer group's forward runs again in the backward);
    the losses are finite."""
    c0, w0, b0 = cops.launch_count, wops.launch_count, wops.bwd_launch_count
    a0, r0 = aops.launch_count, rops.launch_count
    steps = 2
    _, hist = train_reduced("rwkv6-7b", steps=steps, batch=2, seq=1025,
                            warmup_steps=1, dtype=torch.bfloat16, device=dev,
                            remat=remat)
    bwd = wops.bwd_launch_count - b0
    assert cops.launch_count - c0 == steps
    assert bwd == 2 * steps * 2 * 2
    assert wops.launch_count - w0 - bwd == (2 if remat else 1) * bwd // 2
    assert aops.launch_count == a0 and rops.launch_count == r0
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in hist)


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
    """``rwkv6_scan`` has its backward kernel now: under autograd it
    launches the forward and, for the gradient, the backward, and without
    a graph only the forward. ``decode_attention`` still raises under
    autograd: the reference defines no VJP for its kernel either."""
    r, k, v, lw = (torch.randn(1, 2, 8, 16, device=dev) for _ in range(4))
    lw = -lw.abs().clamp(1e-6, 1.0)
    u = torch.randn(2, 16, device=dev)
    before = (wops.launch_count, wops.bwd_launch_count)
    y, _ = wops.rwkv6_scan(r.requires_grad_(), k, v, lw, u)
    y.sum().backward()
    assert r.grad is not None and torch.isfinite(r.grad).all()
    assert (wops.launch_count, wops.bwd_launch_count) == (before[0] + 3,
                                                          before[1] + 2)
    with torch.no_grad():
        wops.rwkv6_scan(r, k, v, lw, u)  # no graph: the forward alone
    assert wops.bwd_launch_count == before[1] + 2
    q = torch.randn(1, 4, 64, device=dev, requires_grad=True)
    kv = torch.randn(1, 16, 1, 64, device=dev)
    pos = torch.arange(16, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="defines no VJP"):
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


# ---------------------------------------------------------------------------
# The lane axis ("vmap" service lanes) and data-sharded FlyMC on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["logistic", "student_t", "softmax"])
def test_bright_glm_lane_launch_is_its_per_lane_launches_bitwise(dev,
                                                                 family):
    """L = 3 lanes of K = 2 chains, uneven bright counts, padding past N:
    one lane-stacked launch is bitwise three single-lane launches, and
    within 1e-5 of the plain version."""
    lanes = [_bright_inputs(family, 700, 11, 2, 40, dev, seed=s)
             for s in range(3)]
    x, t, xi, arr, nb, theta = (torch.stack(a) for a in zip(*lanes))
    idx = arr[:, :, :40]  # strided views, as the step passes them
    idx[1, 0, -3:] = 700  # candidate sentinels
    nb = torch.stack([torch.tensor([40, 0]), torch.tensor([3, 39]),
                      torch.tensor([17, 1])]).to(dev)
    before = bops.launch_count
    delta, total = bops.bright_glm(x, t, xi, idx, nb, theta, family=family,
                                   **KW[family])
    assert bops.launch_count - before == 1
    d_ref, t_ref = bright_glm_ref(x, t, xi, idx, nb, theta, family=family,
                                  **KW[family])
    torch.testing.assert_close(delta, d_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(total, t_ref, rtol=1e-5, atol=1e-5)
    for lane in range(3):
        d1, t1 = bops.bright_glm(x[lane], t[lane], xi[lane], idx[lane],
                                 nb[lane], theta[lane], family=family,
                                 **KW[family])
        assert torch.equal(d1, delta[lane]) and torch.equal(t1, total[lane])


def test_z_candidates_lane_launch_is_its_per_lane_launches_bitwise(dev):
    """L = 3 lanes of K = 2 chains, uneven ``num`` (one chain with no dark
    datum), a lane stack that is a strided view: one launch, bitwise
    three single-lane launches and the plain version."""
    g = torch.Generator().manual_seed(5)
    n, cap = 30_000, 500
    wide = torch.stack([torch.stack([torch.randperm(n, generator=g)
                                     for _ in range(3)]) for _ in range(3)])
    arr = wide.to(torch.int32).to(dev)[:, 1:]
    num = torch.tensor([[0, 70], [n, 4000], [12, 29_999]], device=dev)
    kw = torch.randint(0, 2**32, (3, 2, 2), generator=g).to(dev)
    before = zops.launch_count
    cand, count = zops.z_candidates(arr, num, kw, 0.01, cap)
    assert zops.launch_count - before == 1
    c_ref, n_ref = z_candidates_ref(arr, num, kw, 0.01, cap)
    assert torch.equal(cand, c_ref) and torch.equal(count, n_ref)
    for lane in range(3):
        c1, n1 = zops.z_candidates(arr[lane], num[lane], kw[lane], 0.01, cap)
        assert torch.equal(c1, cand[lane]) and torch.equal(n1, count[lane])


def test_vmap_group_chunk_launches_each_kernel_once_a_step(dev):
    """A "vmap" group of 4 two-chain lanes on the card: each kernel
    launches once a group step (two ``bright_glm`` a RWMH step), and every
    lane's state after the chunk is bitwise the "map" engine's."""
    from repro_torch.serve import GroupEngine

    base = _card_mix(dev, 64)[1]
    assert base.num_chains == 2
    jobs = [dataclasses.replace(base, job_id=f"l{i}", seed=i,
                                data=logistic_data(jr.key(60 + i), n=2048,
                                                   d=16))
            for i in range(4)]
    engines = {}
    for backend in ("map", "vmap"):
        eng = GroupEngine(jobs[0], lane_backend=backend)
        for j in jobs:
            eng.admit(j)
        b0, z0, s0 = bops.launch_count, zops.launch_count, eng.group_steps
        eng.run_chunk(8)
        steps = eng.group_steps - s0
        assert steps == (8 if backend == "vmap" else 32) * (1 + eng.reruns)
        assert bops.launch_count - b0 == 2 * steps
        assert zops.launch_count - z0 == steps
        engines[backend] = eng
    for j in jobs:
        a = engines["map"].lane_of(j.job_id)
        b = engines["vmap"].lane_of(j.job_id)
        assert _same(a["state"], b["state"]) and _same(a["carries"],
                                                       b["carries"])


def test_dist_step_on_card_waits_only_in_its_collectives(dev):
    """2 ranks, gloo over CUDA tensors on the one card, the kernel
    engines: every host wait of 3 data-sharded RWMH steps is inside the
    collectives (``distributed/comm.py``), at most one a collective, and
    both ranks hold the same θ."""
    import _torch_dist_ranks as ranks
    from repro_torch.distributed.launch import run_ranks

    data = logistic_data(jr.key(3), n=4096, d=8)
    cfg = {"x": data.x.cpu().numpy(), "t": data.t.cpu().numpy(),
           "xi": np.full(4096, 1.5, np.float32), "device": "cuda",
           "seed": 9, "steps": 3,
           "spec": dict(kernel="rwmh", capacity=256, cand_capacity=256,
                        q_db=0.02)}
    out = run_ranks(ranks.dist_step_syncs, 2, backend="gloo", device="cuda",
                    args=(cfg,), timeout_s=300)
    for got in out:
        assert got["collectives"] == {"sum": 9, "max": 3}
        assert all(site.startswith("comm.py:") for site in got["sites"]), \
            got["sites"]
        assert sum(got["sites"].values()) <= 12
        np.testing.assert_array_equal(got["theta"], out[0]["theta"])


# ---------------------------------------------------------------------------
# The wide softmax path (an LM head), the collapsed term and the dense
# decoders on the card
# ---------------------------------------------------------------------------


def _wide_inputs(n, d, kc, k, c, dev, seed=0):
    """Softmax operands past the register kernel: θ at 0.3/√D, ξ the logits
    of a nearby θ (MAP-tuned-like), padding sentinels at the end."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g)
    t = torch.randint(0, kc, (n,), generator=g)
    theta = 0.3 * torch.randn(k, kc, d, generator=g) / d**0.5
    xi = x @ (theta[0] + 0.05 * torch.randn(kc, d, generator=g) / d**0.5).t()
    idx = torch.stack([torch.randperm(n, generator=g)[:c]
                       for _ in range(k)]).to(torch.int32)
    idx[:, -3:] = n
    nb = torch.randint(0, c, (k,), generator=g)
    return [a.to(dev) for a in (x, t, xi, idx, nb, theta)]


# δ: max|Δ| ≤ 1e-4 + 1e-5·|δ| against the plain version (classes summed in
# another order); the total against the plain sum of the kernel's own δ at
# rtol 1e-5 (log(expm1 δ) amplifies δ's rounding near 0).
_WIDE_DELTA = dict(rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n,d,kc,c", [
    (300, 7, 17, 40), (200, 128, 512, 24), (600, 70, 5000, 100),
    (90, 4100, 3, 9),
])
def test_bright_glm_wide_kernel_matches_plain(dev, n, d, kc, c):
    """Past 16 classes (or 48 KiB of Θ_k) the softmax goes to the wide
    kernel, one launch a call; the register kernel is not used."""
    from repro_torch.kernels.bright_glm.ref import total_of_delta

    x, t, xi, idx, nb, theta = _wide_inputs(n, d, kc, 2, c, dev)
    assert not bops.register_path(kc, d)
    before, wide = bops.launch_count, bops.wide_launch_count
    delta, total = bops.bright_glm(x, t, xi, idx, nb, theta, family="softmax")
    torch.cuda.synchronize()
    assert bops.launch_count - before == 1
    assert bops.wide_launch_count - wide == 1
    d_ref, _ = bright_glm_ref(x, t, xi, idx, nb, theta, family="softmax")
    torch.testing.assert_close(delta, d_ref, **_WIDE_DELTA)
    torch.testing.assert_close(total, total_of_delta(delta, nb), rtol=1e-5,
                               atol=1e-5)


def test_bright_glm_wide_kernel_is_capacity_and_batch_invariant(dev):
    """A row's δ and a chain's total do not depend on the buffer capacity
    (more padding past n_bright), on the chain count or on a lane stack:
    bitwise."""
    x, t, xi, idx, nb, theta = _wide_inputs(500, 64, 3000, 3, 200, dev,
                                            seed=1)
    nb = torch.tensor([150, 37, 0], device=dev)
    d_all, t_all = bops.bright_glm(x, t, xi, idx, nb, theta,
                                   family="softmax")
    d_cap, t_cap = bops.bright_glm(x, t, xi, idx[:, :160], nb, theta,
                                   family="softmax")
    assert torch.equal(d_cap, d_all[:, :160]) and torch.equal(t_cap, t_all)
    for k in range(3):
        d1, t1 = bops.bright_glm(x, t, xi, idx[k:k + 1], nb[k:k + 1],
                                 theta[k:k + 1], family="softmax")
        assert torch.equal(d1[0], d_all[k]) and torch.equal(t1[0], t_all[k])
    xl, tl, xil = (torch.stack([a, a]) for a in (x, t, xi))
    d_l, t_l = bops.bright_glm(xl, tl, xil, torch.stack([idx, idx]),
                               torch.stack([nb, nb]),
                               torch.stack([theta, theta]), family="softmax")
    assert torch.equal(d_l[1], d_all) and torch.equal(t_l[1], t_all)


def test_bright_glm_wide_many_tiles_repeated_is_bitwise_stable(dev):
    """32 row tiles × 3 splits a chain, K = 2, 300 calls: the tickets of
    both levels never let a total or a δ differ from the first call's, and
    the tile counters come back clean (a later call at another shape is
    still exact)."""
    x, t, xi, idx, nb, theta = _wide_inputs(3000, 48, 4500, 2, 2048, dev,
                                            seed=2)
    nb = torch.tensor([2048, 999], device=dev)
    d0, t0 = bops.bright_glm(x, t, xi, idx, nb, theta, family="softmax")
    diff = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(300):
        d, tot = bops.bright_glm(x, t, xi, idx, nb, theta, family="softmax")
        diff += (d != d0).sum() + (tot != t0).sum()
    assert int(diff) == 0
    d1, _ = bops.bright_glm(x, t, xi, idx[:, :33], nb.clamp(max=33), theta,
                            family="softmax")
    d_ref, _ = bright_glm_ref(x, t, xi, idx[:, :33], nb.clamp(max=33), theta,
                              family="softmax")
    torch.testing.assert_close(d1, d_ref, **_WIDE_DELTA)


def _wide_kernels_a_call():
    """The device kernels of each of 5 traced wide ``bright_glm`` calls
    (see :func:`_device_kernels`), the calls made and the wide launches
    counted."""
    x, t, xi, idx, nb, theta = _wide_inputs(400, 96, 2500, 2, 128,
                                            torch.device("cuda"))
    fn = lambda: bops.bright_glm(x, t, xi, idx, nb, theta, family="softmax")
    before = bops.wide_launch_count
    calls, made = _device_kernels(fn, reps=5)
    return calls, made, bops.wide_launch_count - before


def test_bright_glm_wide_one_device_kernel_per_call(dev):
    """One device kernel a call, the wide one, traced in a process of its
    own (see :func:`test_rglru_scan_one_kernel_per_call`: after the FlyMC
    kernels' traces in this process the profiler records nothing)."""
    calls, made, launched = _in_own_process("_wide_kernels_a_call()")
    assert launched == made
    assert all(len(c) == 1 and "bright_glm_wide_kernel" in c[0]
               for c in calls), calls


def test_bright_glm_wide_gradient_on_card(dev):
    """MALA's gradient through the wide kernel: its backward is the plain
    version's, on the card against the CPU's."""
    x, t, xi, idx, nb, theta = _wide_inputs(300, 40, 700, 2, 48, dev)
    th = theta.clone().requires_grad_(True)
    _, total = bops.bright_glm(x, t, xi, idx, nb, th, family="softmax")
    (g,) = torch.autograd.grad(total.sum(), th)
    cpu = [a.cpu() for a in (x, t, xi, idx, nb)]
    th_c = theta.cpu().requires_grad_(True)
    _, total_c = bops.bright_glm(*cpu, th_c, family="softmax")
    (g_c,) = torch.autograd.grad(total_c.sum(), th_c)
    torch.testing.assert_close(g.cpu(), g_c, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kc,d", [(512, 64), (4096, 128)])
def test_softmax_collapsed_is_batch_invariant_on_card(dev, kc, d):
    from _torch_grad_invariance import assert_softmax_collapsed_batch_invariant

    assert_softmax_collapsed_batch_invariant(kc, d, dev)


def test_lastlayer_chain_on_card(dev):
    """FlyMC over the reduced llama3.2-3b head on the card (Kc = 512, the
    wide kernel): every θ-update and candidate call launches it, the chain
    is finite, and its final bright set, started off the tangency so that
    it is not empty, has δ that agrees with the plain version (1e-5
    absolute and relative) and with the chains' stored δ."""
    from repro_torch.core import brightness
    from repro_torch.models.lastlayer import lastlayer_glm

    lm = T.init_model(get_reduced("llama3.2-3b"), 0, dev, torch.float32)
    toks = torch.randint(0, 512, (4, 33),
                         generator=torch.Generator().manual_seed(5)).to(dev)
    m = lastlayer_glm(lm, toks, prior_scale=0.003)
    theta_map = m.map_estimate(jr.key(6, device=dev), steps=40)
    tuned = m.map_tuned(theta_map)
    # a mean Böhning gap of ~0.05 a token: ¼·Kc·|x|²·ε0² over flat logits
    x2 = float(tuned.data.x.square().sum(1).mean())
    eps0 = (0.2 / (tuned.theta_shape[0] * x2)) ** 0.5
    theta0 = theta_map + eps0 * jr.normal(jr.key(8, device=dev),
                                          (2, *theta_map.shape))
    alg = api.firefly(tuned, kernel="mala", capacity=64, cand_capacity=64,
                      q_db=0.05, step_size=0.25 * eps0, adapt_target="auto",
                      device=dev)
    b0, w0, z0 = bops.launch_count, bops.wide_launch_count, zops.launch_count
    tr = api.sample(alg, jr.key(7, device=dev), 10, num_chains=2,
                    init_position=theta0, device=dev)
    assert bops.wide_launch_count - w0 == bops.launch_count - b0 > 0
    assert zops.launch_count - z0 == tr.steps_run > 0
    assert bool(torch.isfinite(tr.theta).all())
    fs, spec = tr.final_state, tr.algorithm.spec
    idx, mask = brightness.bright_buffer(fs.bright, spec.capacity)
    assert bool(mask.any(1).all())
    args = (tuned.data.x, tuned.data.t, tuned.data.xi, idx, fs.bright.num,
            fs.sampler.theta)
    kw = dict(family="softmax", **spec.bound.fused_kernel_kwargs())
    delta, _ = bops.bright_glm(*args, **kw)
    d_ref, _ = bright_glm_ref(*args, **kw)
    assert float(d_ref[mask].min()) > 1e-3
    torch.testing.assert_close(delta[mask], d_ref[mask], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(fs.sampler.aux[mask], delta[mask], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-7b", "stablelm-1.6b",
                                  "qwen1.5-110b"])
def test_serve_dense_reduced_on_card(dev, arch):
    """The dense decoders' reduced twins (2 layers) through ``serve`` on the
    card, in float32: one ``decode_attention`` launch a layer a decode
    step."""
    a0 = aops.launch_count
    ids, _ = serve(arch, batch=2, prompt_len=20, gen=4, seed=3,
                   dtype=torch.float32, device=dev)
    assert aops.launch_count - a0 == 2 * 3
    assert ids.shape == (2, 4) and bool(((ids >= 0) & (ids < 512)).all())


FAMILIES = ("mixtral-8x7b", "arctic-480b", "whisper-tiny",
            "llava-next-mistral-7b")


def _frontend(cfg, b, dev, gen):
    """The stub frontend's input of an encdec or VLM twin, else nothing."""
    if cfg.family == "encdec":
        return {"frames": 0.1 * torch.randn(b, cfg.encoder_seq, cfg.d_model,
                                            generator=gen, device=dev)}
    if cfg.family == "vlm":
        return {"patches": 0.1 * torch.randn(
            b, cfg.patch_positions, cfg.d_model, generator=gen, device=dev)}
    return {}


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_decode_step_never_waits_on_the_card(dev, arch):
    """The MoE, encdec and VLM twins' decode steps issue their work without
    making the host wait (the MoE's routing, sort, capacity and scatter
    have shapes fixed by the batch; whisper's cross-attention positions are
    made on the card): under ``set_sync_debug_mode("error")`` a
    synchronising call raises. mixtral's 70-token prompt is longer than
    its 64-token window: the ring wraps."""
    cfg = get_reduced(arch)
    model = T.init_model(cfg, 0, dev, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(5)
    prompt, steps = 70, 4
    prompts = torch.randint(0, cfg.vocab_size, (2, prompt), generator=gen,
                            device=dev)
    with torch.inference_mode():
        cache, h = SV.prefill(model, prompts, prompt + steps,
                              dtype=torch.bfloat16, kv_dtype=torch.bfloat16,
                              **_frontend(cfg, 2, dev, gen))
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


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "arctic-480b"])
@pytest.mark.parametrize("t", [4, 256])
def test_moe_tokens_on_card_matches_cpu(dev, arch, t):
    """``moe_tokens`` on the card against its CPU run in float32, the same
    weights and tokens (with a common mean, so that some pairs drop at
    T = 256): the routing (experts, sort order, kept pairs, slots) and
    ``drop_frac`` exactly, y and ``lb_loss`` at 1e-4 (products summed in
    another order); the routing held 1e-4 from ties first."""
    from repro_torch.models import layers as L

    cfg = get_reduced(arch)
    model = T.init_model(cfg, 0, "cpu", torch.float32)
    ffn = model.blocks[0].ffn
    x = torch.randn(t, cfg.d_model,
                    generator=torch.Generator().manual_seed(t)) + 1.0
    r_cpu = L.moe_route(x, ffn.router, cfg)
    p = r_cpu["probs"].sort(-1, descending=True).values
    assert float((p[:, 1] - p[:, 2]).min()) >= 1e-4
    y_cpu, aux_cpu = L.moe_tokens(x, L.moe_weights(ffn, x.dtype), cfg)
    ffn_dev = T.init_model(cfg, 0, "cpu", torch.float32).to(dev).blocks[0].ffn
    y, aux = L.moe_tokens(x.to(dev), L.moe_weights(ffn_dev, x.dtype), cfg)
    r = L.moe_route(x.to(dev), ffn_dev.router, cfg)
    for name in ("expert", "order", "ok", "slot"):
        assert torch.equal(r[name].cpu(), r_cpu[name]), name
    assert float(aux["drop_frac"]) == float(aux_cpu["drop_frac"])
    if t == 256:
        assert float(aux_cpu["drop_frac"]) > 0
    torch.testing.assert_close(y.cpu(), y_cpu, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux["lb_loss"].cpu(), aux_cpu["lb_loss"],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_family_reduced_on_card(dev, arch):
    """The MoE, encdec and VLM twins through ``serve`` on the card in
    float32: one ``decode_attention`` launch a layer a decode step, and for
    whisper one more over the encoder's K/V."""
    cross = get_reduced(arch).family == "encdec"
    a0 = aops.launch_count
    ids, _ = serve(arch, batch=2, prompt_len=70, gen=4, seed=3,
                   dtype=torch.float32, device=dev)
    assert aops.launch_count - a0 == (1 + cross) * 2 * 3
    assert ids.shape == (2, 4) and bool(((ids >= 0) & (ids < 512)).all())


# ---------------------------------------------------------------------------
# SP-mode training: the dense, MoE, encdec and VLM families
# ---------------------------------------------------------------------------

SP_TRAIN = ("llama3.2-3b", "mixtral-8x7b", "whisper-tiny",
            "llava-next-mistral-7b")


def _sp_steps(arch, dev, remat=False, steps=3):
    """``steps`` float32 train steps of ``arch``'s twin on ``dev`` from the
    seed-0 weights drawn on the CPU, on batches drawn on the CPU. Returns
    (the step's metrics, the model, the AdamW state)."""
    from repro_torch.launch.train import synthetic_batch

    cfg = get_reduced(arch)
    model = T.init_model(cfg, 0, "cpu", torch.float32).to(dev)
    model.requires_grad_(True)
    opt = T.init_opt(model)
    step = T.make_train_step(cfg, dtype=torch.float32, peak_lr=1e-3,
                             warmup_steps=0, remat=remat)
    gen = torch.Generator().manual_seed(7)
    mets = []
    for _ in range(steps):
        b = synthetic_batch(gen, cfg, 2, 65)
        mets.append(step(model, opt, {k: v.to(dev) for k, v in b.items()}))
    return mets, model, opt


@pytest.mark.parametrize("arch", SP_TRAIN)
def test_sp_twin_trains_on_card_as_on_cpu(dev, arch):
    """Three float32 steps of each SP family's twin on the card: one
    ``fused_ce`` launch a step, and each step's loss within 1e-3 of the same
    run on the CPU (products summed in another order)."""
    c0 = cops.launch_count
    card, _, _ = _sp_steps(arch, dev)
    torch.cuda.synchronize()
    assert cops.launch_count - c0 == 3
    cpu, _, _ = _sp_steps(arch, torch.device("cpu"))
    for a, b in zip(card, cpu):
        assert np.isfinite(float(a["loss"]))
        assert abs(float(a["loss"]) - float(b["loss"])) <= 1e-3, (a, b)


def test_remat_is_bitwise_on_card_for_mixtral(dev):
    """``remat=True`` gives ``remat=False``'s bits on the card for the
    mixtral twin: two steps' metrics, then every parameter and moment (its
    top-2 dispatch's ``index_select`` backward adds two values a token,
    which no order changes)."""
    off = _sp_steps("mixtral-8x7b", dev, remat=False, steps=2)
    on = _sp_steps("mixtral-8x7b", dev, remat=True, steps=2)
    for a, b in zip(on[0], off[0]):
        assert all(torch.equal(a[k], b[k]) for k in a), (a, b)
    for (n, p), (_, q) in zip(on[1].named_parameters(),
                              off[1].named_parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(on[2].m[n], off[2].m[n])
        assert torch.equal(on[2].v[n], off[2].v[n])


@pytest.mark.parametrize("d,v", [(384, 51968), (8192, 152064)])
def test_fused_ce_sp_heads_match_plain(dev, d, v):
    """``fused_ce`` at whisper-tiny's and qwen1.5-110b's heads (T = 500, a
    ragged token tile; enough tokens that the 1% allowance is more than one
    token): bf16 in the path's rounding mode (within 1e-4 on 99% of the
    tokens and one more bf16 ulp on every one) and float32 (1e-4), one
    launch a call; then ``FusedCE``'s backward in chunks of 32 rows against
    autograd through the plain version, float32, dx and dw within 1e-4 of
    their largest value, as the smoke's backward phase holds them (dx sums
    152,064 classes' products in float32 in another order)."""
    g = torch.Generator().manual_seed(d + v)
    t = 500
    x = torch.randn(t, d, generator=g).to(dev)
    w = (torch.randn(d, v, generator=g) / d**0.5).to(dev)
    lab = torch.randint(0, v, (t,), generator=g)
    lab[:4] = torch.tensor([0, v - 1, 1023, 1024])
    lab = lab.to(dev)
    xb, wb = x.bfloat16(), w.bfloat16()
    before = cops.launch_count
    lse, tgt = cops.lse_and_target(xb, wb, lab, round_logits=True)
    lse32, tgt32 = cops.lse_and_target(x, w, lab)
    torch.cuda.synchronize()
    assert cops.launch_count == before + 2
    lse_ref, tgt_ref = fused_ce_ref(xb, wb, lab, round_logits=True)
    top = float((xb.float() @ wb.float()).abs().max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    for a, ref in ((lse, lse_ref), (tgt, tgt_ref)):
        err = (a - ref).abs()
        assert float((err > 1e-4).float().mean()) <= 0.01
        assert float(err.max()) <= 1e-4 + ulp
    lse_ref, tgt_ref = fused_ce_ref(x, w, lab)
    torch.testing.assert_close(lse32, lse_ref, rtol=0, atol=1e-4)
    torch.testing.assert_close(tgt32, tgt_ref, rtol=0, atol=1e-4)
    c = torch.rand(t, generator=g).to(dev)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    (cops.fused_ce(xg, wg, lab, chunk=32) * c).sum().backward()
    x2, w2 = x.clone().requires_grad_(), w.clone().requires_grad_()
    lse, tgt = fused_ce_ref(x2, w2, lab)
    ((lse - tgt) * c).sum().backward()
    for a, ref in ((xg.grad, x2.grad), (wg.grad, w2.grad)):
        torch.testing.assert_close(a, ref, rtol=0,
                                   atol=1e-4 * float(ref.abs().max()))


def _reference_tree(model, leaf):
    """The reference's parameter tree for a one-slot-pattern ``model``
    (``blocks/slot0`` stacked over the layers, the attention named
    ``attn``), each leaf ``leaf(parameter)`` as numpy: what
    ``convert.lm_params`` reads, built without JAX."""
    def tree(mod):
        out = {n: tree(c) for n, c in mod.named_children()}
        out.update({n: leaf(getattr(mod, n)) for n in mod.defs})
        return out

    layers = [{("attn" if n == "mix" else n): tree(c)
               for n, c in blk.named_children()} for blk in model.blocks]

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(x[k] for x in leaves)) for k in leaves[0]}
        return np.stack(leaves)

    return {"embed": tree(model.embed), "final_norm": tree(model.final_norm),
            "blocks": {"slot0": stack(*layers)}}


def test_adamw_state_keeps_bf16_moments_on_card(dev):
    """``convert.adamw_state`` carries the qwen1.5-110b twin's bfloat16
    moments onto the card in bfloat16, bit for bit, and a train step there
    keeps them bfloat16."""
    from types import SimpleNamespace

    from repro_torch import convert
    from repro_torch.launch.train import synthetic_batch

    cfg = get_reduced("qwen1.5-110b")
    model = T.init_model(cfg, 0, dev, torch.float32).requires_grad_(True)
    g = torch.Generator().manual_seed(9)
    draw = lambda p: (torch.randn(p.shape, generator=g) * 1e-3).bfloat16(
        ).float().numpy()
    m = _reference_tree(model, draw)
    v = _reference_tree(model, lambda p: np.abs(draw(p)) * 1e-3)
    opt = convert.adamw_state(SimpleNamespace(step=np.int32(2), m=m, v=v),
                              model)
    assert int(opt.step) == 2
    moments = dict(opt.m)
    for n, t in list(opt.m.items()) + list(opt.v.items()):
        assert t.dtype == torch.bfloat16 and t.device.type == dev.type, n
    m_back = convert.lm_params(m, cfg, "cpu")
    for n, p in m_back.named_parameters():
        assert torch.equal(moments[n].cpu().float(), p.detach()), n
    step = T.make_train_step(cfg, dtype=torch.bfloat16, warmup_steps=0)
    b = synthetic_batch(torch.Generator(device=dev).manual_seed(1), cfg, 2,
                        33)
    met = step(model, opt, b)
    assert np.isfinite(float(met["loss"])) and int(opt.step) == 3
    assert all(t.dtype == torch.bfloat16 for t in opt.m.values())


# ---------------------------------------------------------------------------
# The sharded train step: fused_ce at a vocabulary shard, the merge, the
# vocab-parallel backward, a 1-rank NCCL step
# ---------------------------------------------------------------------------


def _shard_inputs(dev, t=1031, d=256, v=4096, seed=28):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(t, d, generator=g).to(torch.bfloat16).to(dev)
    w = (torch.randn(d, v, generator=g) / d**0.5).to(torch.bfloat16).to(dev)
    lab = torch.randint(0, v, (t,), generator=g)
    lab[:4] = torch.tensor([0, v // 2 - 1, v // 2, v - 1])
    return x, w, lab.to(dev)


def test_fused_ce_vocab_shard_matches_plain(dev):
    """Each half of the head with the labels shifted into its columns:
    the kernel against its plain version (the rounding mode's bound, as
    ``test_fused_ce_round_logits_matches_plain``), and a label of the
    other half gives a target of exactly 0 in both."""
    x, w, lab = _shard_inputs(dev)
    vb = w.shape[1] // 2
    for r in range(2):
        ws, ls = w[:, r * vb:(r + 1) * vb].contiguous(), lab - r * vb
        lse, tgt = cops.lse_and_target(x, ws, ls, round_logits=True)
        lse_ref, tgt_ref = fused_ce_ref(x, ws, ls, round_logits=True)
        torch.cuda.synchronize()
        out = (ls < 0) | (ls >= vb)
        assert out.any() and (~out).any()
        assert bool((tgt[out] == 0).all()) and bool((tgt_ref[out] == 0).all())
        top = float((x.float() @ ws.float()).abs().max())
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
        for a, ref in ((lse, lse_ref), (tgt, tgt_ref)):
            err = (a - ref).abs()
            assert float((err > 1e-4).float().mean()) <= 0.01
            assert float(err.max()) <= 1e-4 + ulp


def test_fused_ce_merged_shards_match_the_whole_head(dev):
    """M + log Σ_r exp(lse_r − M) and Σ_r tgt_r of the two halves against
    one launch over the whole head, to 1e-4 (float32 sums grouped another
    way)."""
    x, w, lab = _shard_inputs(dev)
    vb = w.shape[1] // 2
    parts = [cops.lse_and_target(x, w[:, r * vb:(r + 1) * vb].contiguous(),
                                 lab - r * vb, round_logits=True)
             for r in range(2)]
    m = torch.maximum(parts[0][0], parts[1][0])
    lse = m + torch.log(sum(torch.exp(p[0] - m) for p in parts))
    tgt = parts[0][1] + parts[1][1]
    lse_w, tgt_w = cops.lse_and_target(x, w, lab, round_logits=True)
    torch.testing.assert_close(lse, lse_w, rtol=0, atol=1e-4)
    torch.testing.assert_close(tgt, tgt_w, rtol=0, atol=1e-4)


def test_vocab_parallel_backward_matches_the_whole_head(dev):
    """``ce_backward`` on each half against the merged lse (the
    vocab-parallel backward of ``fused_ce_shard``): the halves' dx sum to
    the whole head's and their dw are its column blocks, float32."""
    g = torch.Generator().manual_seed(6)
    t, d, v = 300, 128, 2048
    x = torch.randn(t, d, generator=g).to(dev)
    w = (torch.randn(d, v, generator=g) / d**0.5).to(dev)
    lab = torch.randint(0, v, (t,), generator=g).to(dev)
    c = torch.rand(t, generator=g).to(dev)
    vb = v // 2
    shards = [(w[:, r * vb:(r + 1) * vb].contiguous(), lab - r * vb)
              for r in range(2)]
    parts = [cops.lse_and_target(x, ws, ls) for ws, ls in shards]
    m = torch.maximum(parts[0][0], parts[1][0])
    lse = m + torch.log(sum(torch.exp(p[0] - m) for p in parts))
    grads = [cops.ce_backward(x, ws, ls, c, chunk=128, lse=lse)
             for ws, ls in shards]
    dx, dw = cops.ce_backward(x, w, lab, c, chunk=128)
    torch.testing.assert_close(grads[0][0] + grads[1][0], dx, rtol=1e-5,
                               atol=1e-5 * float(dx.abs().max()))
    torch.testing.assert_close(torch.cat([grads[0][1], grads[1][1]], 1), dw,
                               rtol=1e-5, atol=1e-5 * float(dw.abs().max()))


def test_one_nccl_rank_sharded_step_is_bitwise_single_device(dev):
    """The reduced llama twin in bf16 with remat: 2 steps of the sharded
    step on a (1, 1) mesh of one NCCL rank are bitwise the single-device
    step's (loss, grad_norm, every weight); each rank step is one
    ``fused_ce`` launch."""
    import _torch_lm_ranks as ranks
    from repro_torch.distributed.launch import single_rank

    cfg = get_reduced("llama3.2-3b")
    gen = np.random.default_rng(4)
    batch = {k: gen.integers(0, cfg.vocab_size, (8, 64), dtype=np.int64)
             for k in ("tokens", "labels")}
    model = T.init_model(cfg, 0, dev).requires_grad_(True)
    opt = T.init_opt(model)
    step = T.make_train_step(cfg, torch.bfloat16, remat=True, warmup_steps=1)
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    single = [ranks.metrics_of(step(model, opt, b)) for _ in range(2)]
    before = cops.launch_count
    with single_rank("nccl", "cuda") as group:
        got = ranks.train(group, dict(arch="llama3.2-3b", device="cuda",
                                      batch=batch, steps=2, remat=True,
                                      dtype=torch.bfloat16,
                                      kw=dict(warmup_steps=1),
                                      mesh=((1, 1), ("data", "model"))))
    assert cops.launch_count == before + 2
    assert got["metrics"] == single
    assert got["tally"]["all_gather"]["calls"] > 0  # through NCCL
    for n, p in model.named_parameters():
        assert np.array_equal(got["params"][n], p.detach().float().cpu()
                              .numpy()), n


def test_one_nccl_rank_sharded_save_is_the_logical_array(dev, tmp_path):
    """A sharded save on a mesh of one NCCL rank gathers its CUDA shards
    through NCCL and writes the logical arrays: a single-device restore
    reads them, and the mesh restore gives them back bitwise."""
    import _torch_lm_ranks as ranks
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed.launch import single_rank

    with single_rank("nccl", "cuda") as group:
        got = ranks.sharded_save(group, {"dir": str(tmp_path), "ranks": 1,
                                         "device": "cuda"})
    full = (torch.arange(24, dtype=torch.float32).reshape(4, 6) / 7).to(
        torch.bfloat16)
    whole, _ = Checkpointer(tmp_path).restore(
        {"cols": torch.zeros(4, 6, dtype=torch.bfloat16),
         "rep": torch.zeros(3), "step": torch.tensor(0)}, step=1)
    assert torch.equal(whole["cols"], full) and int(whole["step"]) == 5
    assert np.array_equal(got["cols"], full.float().numpy())
    assert got["rep"].tolist() == [0.0, 0.0, 0.0] and got["gathers"] == 2


# ---------------------------------------------------------------------------
# The sharded prefill and decode: the merge of the kernel's blocks on the
# card, one NCCL rank, 4 gloo ranks sharing the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", [70, 20])
def test_decode_attention_merge_of_blocks_on_card(dev, t):
    """The kernel on each of 3 blocks of one ring, merged by the ranks'
    formula, against the plain version over the whole ring (t = 20: the
    last two blocks wholly empty)."""
    g = torch.Generator().manual_seed(29)
    b, h, hk, d, w_loc = 2, 24, 8, 128, 32
    w = 3 * w_loc
    q = torch.randn(b, h, d, generator=g).to(dev)
    k = torch.randn(b, w, hk, d, generator=g).to(torch.bfloat16).to(dev)
    v = torch.randn(b, w, hk, d, generator=g).to(torch.bfloat16).to(dev)
    pos = torch.where(torch.arange(w) <= t, torch.arange(w), -1).to(
        torch.int32).to(dev)
    before = aops.launch_count
    parts = [aops.decode_attention(q, k[:, i:i + w_loc].contiguous(),
                                   v[:, i:i + w_loc].contiguous(),
                                   pos[i:i + w_loc].contiguous(), t)
             for i in range(0, w, w_loc)]
    assert aops.launch_count == before + 3
    got = aops.merge_stacked(*(torch.stack(x) for x in zip(*parts)))
    want = decode_attention_ref(q, k, v, pos, t)[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _serve_single(cfg, dev, prompt, feed_len, seq, **frontend):
    """The single-device prefill of ``prompt`` (with whisper's ``frames``
    or llava's ``patches``) and ``feed_len`` greedy steps (float32, bf16
    ring): hidden, logits, tokens, final cache."""
    model = T.init_model(cfg, 0, dev)
    cache, h = SV.prefill(model, prompt, seq, torch.float32, **frontend)
    tok = torch.as_tensor(prompt[:, -1:])  # any token: fed to both runs
    feed, logits, toks = [], [], []
    for _ in range(feed_len):
        feed.append(tok.cpu().numpy())
        tok, lg, cache = SV.decode_step(model, cache, tok, seq, torch.float32)
        logits.append(lg)
        toks.append(tok)
    return h, logits, toks, cache, feed


def test_one_nccl_rank_sharded_serve_is_bitwise_single_device(dev):
    """The reduced llama twin on a (1, 1) mesh of one NCCL rank: the
    sharded prefill's hidden and 5 decode steps' logits, tokens and cache
    bit for bit the single device's; one decode-attention launch a layer
    a step."""
    import _torch_serve_ranks as ranks
    from repro_torch.distributed.launch import single_rank

    cfg = get_reduced("llama3.2-3b")
    prompt = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (4, 28)), device=dev)
    h, logits, toks, cache, feed = _serve_single(cfg, dev, prompt, 5, 32)
    with single_rank("nccl", "cuda"):
        got = ranks.serve(None, dict(
            arch="llama3.2-3b", device="cuda", mesh=((1, 1), ("data", "model")),
            seq_len=32, batch=4, prompt=prompt.cpu().numpy(), feed=feed))
    assert got["launches"] == [cfg.n_layers] * 5
    assert np.array_equal(got["hidden"], h.float().cpu().numpy())
    for a, b in zip(got["logits"], logits):
        assert np.array_equal(a, b.cpu().numpy())
    for a, b in zip(got["tokens"], toks):
        assert np.array_equal(a, b.cpu().numpy())
    for g_, w_ in zip(got["cache"]["layers"], cache["layers"]):
        for n in g_:
            assert np.array_equal(g_[n], w_[n].float().cpu().numpy()), n


def test_four_gloo_ranks_sharded_serve_on_card(dev):
    """4 gloo ranks over CUDA tensors on the card, mesh (2, 2): the fsdp
    prefill and 5 decode steps, and the tp layout's 5 steps from an empty
    cache, against the single device (float32; logits to 5e-4, the bf16
    rings within one ulp); one decode-attention launch a layer a step on
    every rank."""
    import _torch_serve_ranks as ranks
    from repro_torch.distributed.launch import run_ranks

    cfg = get_reduced("llama3.2-3b")
    prompt = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (4, 28)), device=dev)
    h, logits, _, _, feed = _serve_single(cfg, dev, prompt, 5, 32)
    model = T.init_model(cfg, 0, dev)
    cache = SV.init_cache(cfg, 4, 32, torch.bfloat16, dev)
    tp_logits = []
    for tok in feed:
        _, lg, cache = SV.decode_step(model, cache, torch.as_tensor(
            tok, device=dev), 32, torch.float32)
        tp_logits.append(lg)
    base = dict(arch="llama3.2-3b", device="cuda", seq_len=32, batch=4,
                mesh=((2, 2), ("data", "model")), feed=feed)
    jobs = [("serve", dict(base, prompt=prompt.cpu().numpy())),
            ("serve", dict(base, layout="tp"))]
    outs = run_ranks(ranks.many, 4, backend="gloo", device="cuda",
                     args=(jobs,))
    for fsdp, tp in outs:
        assert fsdp["launches"] == tp["launches"] == [cfg.n_layers] * 5
        np.testing.assert_allclose(fsdp["hidden"], h.cpu().numpy(), rtol=0,
                                   atol=1e-5)
        for got, want in ((fsdp, logits), (tp, tp_logits)):
            for a, b in zip(got["logits"], want):
                np.testing.assert_allclose(a, b.cpu().numpy(), rtol=0,
                                           atol=5e-4)


# ---------------------------------------------------------------------------
# The sharded MoE, encoder-decoder and VLM families: one NCCL rank, and the
# merge of whisper's cross K/V blocks on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "arctic-480b",
                                  "whisper-tiny", "llava-next-mistral-7b"])
def test_one_nccl_rank_sharded_family_serve_is_bitwise_single_device(dev,
                                                                      arch):
    """A family twin on a (1, 1) mesh of one NCCL rank: the sharded
    prefill (frames or patches through ``batch_slice``) and 5 decode steps
    (the MoE's expert-ff partial and its psum, whisper's cross blocks and
    their merge) bit for bit the single device's; one decode-attention
    launch a layer a step, two for whisper."""
    import _torch_serve_ranks as ranks
    from repro_torch.distributed.launch import single_rank

    cfg = get_reduced(arch)
    prompt = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (4, 28)), device=dev)
    front = _frontend(cfg, 4, dev,
                      torch.Generator(device=dev).manual_seed(11))
    h, logits, toks, cache, feed = _serve_single(cfg, dev, prompt, 5, 32,
                                                 **front)
    with single_rank("nccl", "cuda"):
        got = ranks.serve(None, dict(
            arch=arch, device="cuda", mesh=((1, 1), ("data", "model")),
            seq_len=32, batch=4, prompt=prompt.cpu().numpy(), feed=feed,
            **{k: v.cpu().numpy() for k, v in front.items()}))
    per_layer = 2 if cfg.family == "encdec" else 1
    assert got["launches"] == [per_layer * cfg.n_layers] * 5
    assert np.array_equal(got["hidden"], h.float().cpu().numpy())
    for a, b in zip(got["logits"], logits):
        assert np.array_equal(a, b.cpu().numpy())
    for a, b in zip(got["tokens"], toks):
        assert np.array_equal(a, b.cpu().numpy())
    for g_, w_ in zip(got["cache"]["layers"], cache["layers"]):
        assert set(g_) == set(w_)
        for n in g_:
            assert np.array_equal(g_[n], w_[n].float().cpu().numpy()), n


def test_one_nccl_rank_sharded_moe_step_is_bitwise_single_device(dev):
    """The reduced mixtral twin in bf16 with remat, at its own capacity
    factor: 2 steps of the sharded step on a (1, 1) mesh of one NCCL rank
    are bitwise the single-device step's (loss, lb_loss, drop_frac,
    grad_norm, every weight)."""
    import _torch_lm_ranks as ranks
    from repro_torch.distributed.launch import single_rank

    cfg = get_reduced("mixtral-8x7b")
    gen = np.random.default_rng(3)
    toks = gen.integers(0, cfg.vocab_size, (8, 65), dtype=np.int64)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    model = T.init_model(cfg, 0, dev).requires_grad_(True)
    opt = T.init_opt(model)
    step = T.make_train_step(cfg, torch.bfloat16, remat=True, warmup_steps=1)
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    single = [ranks.metrics_of(step(model, opt, b)) for _ in range(2)]
    with single_rank("nccl", "cuda") as group:
        got = ranks.train(group, dict(arch="mixtral-8x7b", device="cuda",
                                      batch=batch, steps=2, remat=True,
                                      dtype=torch.bfloat16,
                                      kw=dict(warmup_steps=1),
                                      mesh=((1, 1), ("data", "model"))))
    assert got["metrics"] == single
    for n, p in model.named_parameters():
        assert np.array_equal(got["params"][n], p.detach().float().cpu()
                              .numpy()), n


@pytest.mark.parametrize("blocks", [2, 4])
def test_decode_attention_cross_blocks_merge_on_card(dev, blocks):
    """Whisper-tiny's cross K/V (H = Hk = 6, D = 64, 1,504 encoder
    positions, bf16) cut into ``blocks`` blocks of positions, as the model
    ranks hold them: the kernel on each block at the cross query position
    (every position valid, no window), merged by the ranks' formula,
    within 1e-6 of the kernel and of the plain version over the whole
    cross cache."""
    g = torch.Generator().manual_seed(30)
    b, h, hk, d, s_enc = 2, 6, 6, 64, 1504
    loc = s_enc // blocks
    q = torch.randn(b, h, d, generator=g).to(dev)
    k = torch.randn(b, s_enc, hk, d, generator=g).to(torch.bfloat16).to(dev)
    v = torch.randn(b, s_enc, hk, d, generator=g).to(torch.bfloat16).to(dev)
    pos = torch.arange(loc, dtype=torch.int32, device=dev)
    before = aops.launch_count
    parts = [aops.decode_attention(q, k[:, i:i + loc].contiguous(),
                                   v[:, i:i + loc].contiguous(), pos,
                                   SV.CROSS_T)
             for i in range(0, s_enc, loc)]
    assert aops.launch_count == before + blocks
    got = aops.merge_stacked(*(torch.stack(x) for x in zip(*parts)))
    whole_pos = torch.arange(s_enc, dtype=torch.int32, device=dev)
    whole = aops.decode_attention(q, k, v, whole_pos, SV.CROSS_T)[0]
    plain = decode_attention_ref(q, k, v, whole_pos, SV.CROSS_T)[0]
    assert float((got - whole).abs().max()) <= 1e-6
    assert float((got - plain).abs().max()) <= 1e-6


# ---------------------------------------------------------------------------
# The TP-mode archs' sharded paths: the four kernels at a (2, 2) rank's
# shapes, and one reduced sharded step per arch on 4 gloo ranks
# ---------------------------------------------------------------------------


def test_tp_shard_rglru_scan_at_the_rank_width(dev):
    """recurrentgemma-9b's RG-LRU at r/mp = 2,048 channels (a data rank's
    training row of 2,048 steps): the forward and the backward kernel
    against their plain versions, each one launch."""
    la, bx, _, gh, gl = _rglru_inputs(1, 2048, 2048, -5.0, dev, seed=31)
    before = rops.launch_count
    y, hf = rops.rglru_scan(la, bx, None)
    y_ref, hf_ref = rglru_ref(la, bx, None)
    torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(hf, hf_ref, rtol=1e-5, atol=1e-5)
    got = rops.rglru_scan_backward(la, y, None, gh, gl)
    want = rglru_bwd_ref(la, y, None, gh, gl)
    assert rops.launch_count == before + 2 and got[2] is None
    for a, w in zip(got[:2], want[:2]):
        _close_to_largest(a, w, 1e-5)


def test_tp_shard_rwkv6_scan_at_the_rank_heads(dev):
    """rwkv6-7b's WKV at H/mp = 32 heads over one 512-step time chunk of a
    data rank's row: the forward and the two-pass backward against their
    plain versions."""
    r, k, v, lw, u, s0, dy, ds = _rwkv6_grad_inputs(1, 32, 512, 64, None,
                                                    dev, seed=31)
    y, st = wops.rwkv6_scan(r, k, v, lw, u, s0)
    y_ref, st_ref = rwkv6_chunked_ref(r, k, v, lw, u, s0, chunk=64)
    _close_to_largest(y, y_ref, 1e-5)
    _close_to_largest(st, st_ref, 1e-5)
    _, _, states = wops._launch(r, k, v, lw, u, s0, 64, save_states=True)
    before = wops.bwd_launch_count
    got = wops.rwkv6_scan_backward(r, k, v, lw, u, states, dy, ds)
    assert wops.bwd_launch_count == before + 2
    want = rwkv6_bwd_ref(r, k, v, lw, u, states, dy, ds, chunk=64)
    for a, w in zip(got, want):
        _close_to_largest(a, w)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-7b"])
def test_tp_shard_fused_ce_on_the_rank_vocab_block(dev, arch):
    """``fused_ce`` on a model rank's vocabulary block of the published
    head (V/mp = 128,000 and 32,768 columns, D = 4,096) at a data rank's
    2,048 rows, bf16 logits, against its plain version."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    x, w, lab = _shard_inputs(dev, t=2048, d=cfg.d_model,
                              v=cfg.padded_vocab(), seed=31)
    vb = w.shape[1] // 2
    ws, ls = w[:, vb:].contiguous(), lab - vb
    del w
    lse, tgt = cops.lse_and_target(x, ws, ls, round_logits=True)
    lse_ref, tgt_ref = fused_ce_ref(x, ws, ls, round_logits=True)
    top = float((x.float() @ ws.float()).abs().max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    for a, ref in ((lse, lse_ref), (tgt, tgt_ref)):
        err = (a - ref).abs()
        assert float((err > 1e-4).float().mean()) <= 0.01
        assert float(err.max()) <= 1e-4 + ulp


def test_tp_shard_decode_attention_on_the_whole_mqa_ring(dev):
    """recurrentgemma-9b's local attention at a model rank: 8 query heads
    against the whole MQA ring (Hk = 1, W = 2,048, D = 256, window 2,048,
    bf16) after the ring wrapped, against the plain version."""
    g = torch.Generator().manual_seed(31)
    b, h, d, w, t = 2, 8, 256, 2048, 2051
    q = torch.randn(b, h, d, generator=g).to(dev)
    k = torch.randn(b, w, 1, d, generator=g).to(torch.bfloat16).to(dev)
    v = torch.randn(b, w, 1, d, generator=g).to(torch.bfloat16).to(dev)
    slots = torch.arange(w)
    pos = (slots + ((t - slots) // w) * w).to(torch.int32).to(dev)
    before = aops.launch_count
    got = aops.decode_attention(q, k, v, pos, t, w)
    assert aops.launch_count == before + 1
    for a, r in zip(got, decode_attention_ref(q, k, v, pos, t, w)):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-7b"])
def test_tp_sharded_step_on_four_gloo_ranks(dev, arch):
    """The reduced twin's sharded loss and gradient on 4 gloo ranks over
    CUDA tensors, mesh (2, 2), against the single device's (float32): the
    loss to 1e-5 relative, every weight's gradient to 1e-4 of its largest
    entry (``tests/test_torch_train_sharded_tp.py``'s rwkv6 bound; rwkv6's
    ``wa`` has a zero gradient at the init, whose ``wb`` is zero: there
    both are 0)."""
    import _torch_lm_ranks as ranks
    from repro_torch.distributed.launch import run_ranks

    cfg = get_reduced(arch)
    gen = np.random.default_rng(31)
    batch = {k: gen.integers(0, cfg.vocab_size, (8, 64), dtype=np.int64)
             for k in ("tokens", "labels")}
    model = T.init_model(cfg, 0, dev).requires_grad_(True)
    loss, _ = T.loss_fn(model, {k: torch.as_tensor(v, device=dev)
                                for k, v in batch.items()},
                        torch.float32, remat=True)
    loss.backward()
    outs = run_ranks(ranks.many, 4, backend="gloo", device="cuda", args=(
        [("grads", dict(arch=arch, device="cuda", batch=batch, remat=True,
                        mesh=((2, 2), ("data", "model"))))],))
    got = outs[0][0]
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    for n, p in model.named_parameters():
        want = p.grad.cpu().numpy()
        gap = (np.abs(got["grads"][n] - want).max()
               / max(np.abs(want).max(), 1e-30))
        assert gap <= 1e-4, (n, gap)
