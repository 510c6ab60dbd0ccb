#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``, at
first use), then runs two paths — the FlyMC chain and the recurrentgemma-9b
LM serving path — each with its kernels:

1. holds each kernel against its plain PyTorch version on the card and
   times it: ``ms`` is the kernels' device time per call (torch.profiler;
   where the trace holds no record of the kernel, back-to-back calls between
   CUDA events), ``call_ms`` and ``plain_ms`` the median of warm calls
   between CUDA events, host overhead included.
   FlyMC, at the paper's widths: ``bright_glm`` for the logistic (MNIST 7v9,
   N=12,214, D=51), softmax (CIFAR-3, N=18,000, D=256, 3 classes) and
   Student-t (OPV, N=1.8M, D=57) families, δ and totals to rtol/atol 1e-5;
   ``z_update`` bitwise at N=12,214 and N=1.8M.
   LM serving, at the path's shapes, to rtol/atol 1e-5:
   ``decode_attention`` (B=4, H=16, Hk=1, D=256, W=2048, window 2048, bf16
   K/V; a wrapped and a partly filled ring; one f32 case with G=4, Hk=2,
   D=128), with ``scaled_dot_product_attention`` as the library yardstick;
   ``rglru_scan`` (B=4, S=2304, C=4096; log a ≈ -5, the model's decays, and
   ≈ -1e-6);
2. drives the FlyMC main path at the MNIST width: ``GLMModel.logistic`` →
   ``map_estimate`` → ``map_tuned`` → ``api.firefly`` (RWMH) → ``api.sample``
   with 2 chains (250 warmup, then 750 samples resumed with streaming
   collectors), counting kernel launches, and compares it with the
   ``regular_mcmc`` baseline (queries/iter, R̂, posterior means); then runs
   the same path at the MNIST N with D = 3 to convergence (split-R̂ < 1.1,
   posterior means within 4 Monte-Carlo standard errors);
3. runs the gradient path: softmax/MALA at the CIFAR width through the
   bright-GLM ``autograd.Function``;
4. checks exactness on the card: a run at capacity 64 (overflow re-runs)
   equals the run at 512 bitwise, and two batched chains equal the chains
   run one at a time;
5. checks the serving contract at recurrentgemma-9b's published width in
   float32: prefill 2100 tokens, decode one, and compare the logits with the
   full forward over 2101 tokens (rtol/atol 2e-3) and the greedy token with
   the forward's argmax;
6. drives the serving path once through ``repro_torch.launch.serve.serve``
   at the published width in bfloat16 (38 layers, d_model 4096, vocab
   256,000, seeded random weights): batch 4, a 2304-token prompt (longer
   than the 2048 window, so the ring wraps), 32 greedy tokens; prints
   prefill ms, decode ms/token, tokens/s and peak memory, and checks 26
   ``rglru_scan`` launches per prefill and 12 ``decode_attention`` launches
   per decode step.

Any failure raises (nonzero exit, no result line). The last two lines are the
``{"kernels": [...]}`` table and ``{"ok": true, "device": {...}}``. Needs one
CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12  # H100 SXM, outside the tensor cores

# The paper's widths (benchmarks/table1.py): MNIST 7v9, CIFAR-3, OPV.
N_MNIST, D_MNIST = 12214, 51
N_CIFAR, D_CIFAR, K_CIFAR = 18000, 256, 3
N_OPV, D_OPV = 1_800_000, 57
CAPACITY = 512
# Main path: 2 chains, 250 warmup + 750 samples at the MNIST width. RWMH in
# 51 correlated dimensions mixes far too slowly for split-R̂ to reach 1.1 in
# 1,000 iterations (FlyMC or full-data alike), so convergence is checked on a
# second run at the MNIST N with D = 3, long enough to converge.
WARMUP, SAMPLES, CHAINS = 250, 750, 2
D_CONV, WARMUP_CONV, SAMPLES_CONV = 3, 1000, 5000
# LM serving path: recurrentgemma-9b at its published width.
ARCH = "recurrentgemma-9b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 2304, 32
EXACT_BATCH, EXACT_PROMPT = 2, 2100


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 25, warm: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` warm calls (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, names, reps: int = 20):
    """Device time per call of the kernels whose names contain one of
    ``names`` (torch.profiler, CUDA activity). If the trace holds none of
    them, logs the kernel names it does hold and returns the time per call
    of ``reps`` back-to-back calls between two CUDA events instead (device
    time plus any launch gaps); the log line says which."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    seen = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        seen.append((us, ev.key[:90]))
        if any(n in ev.key for n in names):
            total_us += us
    if total_us > 0:
        return total_us / reps / 1e3
    log(f"  profiler: no kernel named {names} among {len(seen)} keys "
        f"{sorted(seen, reverse=True)[:4]}; timing {reps} back-to-back calls "
        "with CUDA events")
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_f = flops / FP32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ---------------------------------------------------------------------------
# 1. Kernel phases
# ---------------------------------------------------------------------------


def bright_phase(name, family, data, k, c, kc, dev, gen):
    from repro_torch.kernels.bright_glm import ops
    from repro_torch.kernels.bright_glm.ref import bright_glm_ref

    n, d = data.x.shape
    kw = {"nu": 4.0, "sigma": 1.0} if family == "student_t" else {}
    if family == "softmax":
        xi = torch.randn(n, kc, generator=gen).to(dev)
        theta = (0.3 * torch.randn(k, kc, d, generator=gen) / d**0.5).to(dev)
    else:
        # ξ away from tightness (|s| for logistic, |t - s| for Student-t, and
        # |s| < 3 here): log(expm1 δ) amplifies rounding at δ ≈ 0.
        far = (5.0 if family == "logistic" else data.t.abs().cpu() + 5.0)
        xi = (far + torch.rand(n, generator=gen)).to(dev)
        theta = (0.5 * torch.randn(k, d, generator=gen) / d**0.5).to(dev)
    arr = torch.stack([torch.randperm(n, generator=gen) for _ in range(k)])
    idx = arr.to(torch.int32).to(dev)[:, :c]  # strided, as the step passes it
    idx[:, -8:] = n  # candidate-buffer sentinels, clamped by the kernel
    nb = torch.tensor([c - 37, c // 3], device=dev)[:k]
    args = (data.x, data.t, xi, idx, nb, theta)
    delta, total = ops.bright_glm(*args, family=family, **kw)
    d_ref, t_ref = bright_glm_ref(*args, family=family, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(delta, d_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(total, t_ref, rtol=1e-5, atol=1e-5)
    err = float((delta - d_ref).abs().max())
    call = lambda: ops.bright_glm(*args, family=family, **kw)
    ms = median_ms(call)
    dev_ms = device_ms(call, ("bright_glm_rows", "bright_glm_total"))
    plain = median_ms(lambda: bright_glm_ref(*args, family=family, **kw))
    kt = kc if family == "softmax" else 1
    t_bytes = data.t.element_size()
    row_in = 4 + 4 * d + t_bytes + 4 * (kc if family == "softmax" else 1)
    b_ms, b_by = bound(k * c * row_in + k * c * 4 + k * 4 + k * kt * d * 4,
                       2.0 * k * c * d * kt)
    log(f"bright_glm[{name}: N={n} D={d} K={k} C={c}] max|δ-δ_plain|={err:.3g} "
        f"call {ms:.4f} ms (device {dev_ms} ms), plain {plain:.4f} ms, "
        f"bound {b_ms:.6f} ms ({b_by})")
    return {"phase": name, "N": n, "D": d, "K": k, "C": c, "max_abs_err": err,
            "ms": dev_ms, "call_ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by}


def z_phase(name, n, k, q_db, cap, dev, gen):
    from repro_torch.kernels.z_update import ops
    from repro_torch.kernels.z_update.ref import z_candidates_ref

    arr = torch.stack([torch.randperm(n, generator=gen) for _ in range(k)])
    arr = arr.to(torch.int32).to(dev)
    num = torch.tensor([n // 50, 0], device=dev)[:k]
    kw = torch.randint(0, 2**32, (k, 2), generator=gen).to(dev)
    cand, count = ops.z_candidates(arr, num, kw, q_db, cap)
    c_ref, n_ref = z_candidates_ref(arr, num, kw, q_db, cap)
    torch.cuda.synchronize()
    if not (torch.equal(cand, c_ref) and torch.equal(count, n_ref)):
        raise AssertionError(f"z_update[{name}] differs from its plain version")
    call = lambda: ops.z_candidates(arr, num, kw, q_db, cap)
    ms = median_ms(call)
    dev_ms = device_ms(call, ("z_tile_counts", "z_scan", "z_scatter"))
    plain = median_ms(lambda: z_candidates_ref(arr, num, kw, q_db, cap))
    b_ms, b_by = bound(k * n * 4 + k * cap * 4 + k * 8 * 3 + k * 4, 0.0)
    log(f"z_update[{name}: N={n} K={k} cap={cap} q={q_db}] bitwise equal "
        f"(count {count.tolist()}), call {ms:.4f} ms (device {dev_ms} ms), "
        f"plain {plain:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    return {"phase": name, "N": n, "K": k, "cap": cap, "max_abs_err": 0.0,
            "ms": dev_ms, "call_ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by}


def kernel_phases(dev):
    from repro_torch import random as jr
    from repro_torch.data import logistic_data, robust_data, softmax_data

    gen = torch.Generator().manual_seed(0)
    mnist = logistic_data(jr.key(0), n=N_MNIST, d=D_MNIST)
    cifar = softmax_data(jr.key(1), n=N_CIFAR, d=D_CIFAR, k=K_CIFAR)
    bright = [
        bright_phase("logistic", "logistic", mnist, 2, CAPACITY, 0, dev, gen),
        bright_phase("softmax", "softmax", cifar, 2, CAPACITY, K_CIFAR, dev, gen),
    ]
    del cifar
    opv, _ = robust_data(jr.key(2), n=N_OPV, d=D_OPV)
    bright.append(bright_phase("student_t", "student_t", opv, 2, CAPACITY, 0,
                               dev, gen))
    del opv
    torch.cuda.empty_cache()
    z = [
        z_phase("mnist", N_MNIST, 2, 0.01, CAPACITY, dev, gen),
        z_phase("opv", N_OPV, 2, 0.01, N_OPV // 64, dev, gen),
    ]
    return bright, z, mnist


# ---------------------------------------------------------------------------
# 2. Main path, 3. gradient path, 4. exactness on the card
# ---------------------------------------------------------------------------


def _mean_se(theta: np.ndarray):
    from repro_torch.core import diagnostics

    th = theta.astype(np.float64)
    flat = th.reshape(th.shape[0], th.shape[1], -1)
    se = []
    for j in range(flat.shape[2]):
        ess = sum(diagnostics.effective_sample_size(flat[c, :, j])
                  for c in range(flat.shape[0]))
        se.append(flat[:, :, j].std() / np.sqrt(max(ess, 1.0)))
    return flat.reshape(-1, flat.shape[2]).mean(0), np.array(se)


def _flymc_vs_regular(data, warmup, samples, key0):
    """MAP-tune, run FlyMC (warmup, then a resumed sampling run with
    streaming collectors) and the full-data baseline from the same start.
    Returns the numbers both paths print and check."""
    from repro_torch import api
    from repro_torch import random as jr
    from repro_torch.core import diagnostics
    from repro_torch.kernels.bright_glm import ops as bops
    from repro_torch.kernels.z_update import ops as zops
    from repro_torch.models.bayes_glm import GLMModel

    n, d = data.x.shape
    model = GLMModel.logistic(data, prior_scale=1.0, xi=1.5)
    theta_map = model.map_estimate(jr.key(key0), steps=400)
    tuned = model.map_tuned(theta_map)
    alg = api.firefly(tuned, kernel="rwmh", capacity=CAPACITY,
                      cand_capacity=CAPACITY, q_db=0.01, step_size=0.03,
                      adapt_target="auto", num_warmup=warmup)

    bops.launch_count = 0
    zops.launch_count = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = api.sample(alg, jr.key(key0 + 1), warmup, num_chains=CHAINS,
                      init_position=theta_map, collectors={})
    tr = api.sample(
        warm.algorithm, jr.key(key0 + 2), samples, num_chains=CHAINS,
        init_state=warm.final_state,
        collectors={"moments": api.OnlineMoments(), "rhat": api.RHat(),
                    "queries": api.QueryBudget(),
                    "trace": api.FullTrace(with_stats=False)},
    )
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = {"bright_glm": bops.launch_count, "z_update": zops.launch_count}
    steps = warm.steps_run + tr.steps_run
    want = {"bright_glm": 2 * steps + warm.inits_run + tr.inits_run,
            "z_update": steps}
    if launches != want or min(launches.values()) == 0:
        raise AssertionError(f"FlyMC launches {launches}; expected {want}")

    theta = tr.results["trace"]["theta"].cpu().numpy()
    if theta.shape != (CHAINS, samples, d) or not np.isfinite(theta).all():
        raise AssertionError(f"bad FlyMC samples {theta.shape}")
    np.testing.assert_allclose(tr.results["moments"]["mean"], theta.mean(1),
                               atol=1e-3)
    base = api.regular_mcmc(model, kernel="rwmh", step_size=0.03,
                            adapt_target="auto", num_warmup=warmup)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ref = api.sample(base, jr.key(key0 + 3), warmup + samples,
                     num_chains=CHAINS, init_position=theta_map)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    ref_theta = ref.theta[:, warmup:].cpu().numpy()
    m_f, se_f = _mean_se(theta)
    m_r, se_r = _mean_se(ref_theta)
    return {
        "n": n, "d": d, "launches": launches, "steps": steps,
        "q_fly": tr.results["queries"] / (CHAINS * samples),
        "q_reg": float(ref.stats.lik_queries[:, warmup:].double().mean()),
        "rhat_fly": tr.results["rhat"]["r_hat"],
        "rhat_reg": diagnostics.split_r_hat(ref_theta),
        "dmean": float(np.abs(m_f - m_r).max()),
        "z": float((np.abs(m_f - m_r) / np.sqrt(se_f**2 + se_r**2)).max()),
        "fly_ms": (t1 - t0) * 1e3 / (warmup + samples),
        "reg_ms": (t3 - t2) * 1e3 / (warmup + samples),
        "capacity": tr.algorithm.spec.capacity,
    }


def _report(name, r, warmup, samples):
    log(f"{name} [logistic N={r['n']} D={r['d']}, {CHAINS} chains, {warmup} "
        f"warmup + {samples} samples]: queries/iter flymc {r['q_fly']:.1f} vs "
        f"regular {r['q_reg']:.0f}; split-R̂ flymc {r['rhat_fly']:.4f}, regular "
        f"{r['rhat_reg']:.4f}; max|Δ posterior mean| {r['dmean']:.4g} "
        f"({r['z']:.2f} MC s.e.); ms/iter flymc {r['fly_ms']:.3f}, regular "
        f"{r['reg_ms']:.3f}; capacity {r['capacity']}; launches "
        f"{r['launches']} over {r['steps']} steps")
    if not r["q_fly"] < r["n"] / 10:
        raise AssertionError(f"FlyMC queries/iter {r['q_fly']} not << N")


def main_path(mnist):
    """The main path at the MNIST width; returns its kernel launch counts."""
    r = _flymc_vs_regular(mnist, WARMUP, SAMPLES, key0=2)
    _report("main path", r, WARMUP, SAMPLES)
    return r["launches"]


def convergence_path():
    """The same path at the MNIST N with D = 3, run to convergence: split-R̂
    below 1.1 and FlyMC's posterior means within 4 Monte-Carlo standard
    errors of the full-data chain's."""
    from repro_torch import random as jr
    from repro_torch.data import logistic_data

    data = logistic_data(jr.key(20), n=N_MNIST, d=D_CONV)
    r = _flymc_vs_regular(data, WARMUP_CONV, SAMPLES_CONV, key0=21)
    _report("convergence", r, WARMUP_CONV, SAMPLES_CONV)
    if not (r["rhat_fly"] < 1.1 and r["rhat_reg"] < 1.1):
        raise AssertionError(f"split-R̂ {r['rhat_fly']}, {r['rhat_reg']} >= 1.1")
    if not r["z"] < 4.0:
        raise AssertionError(f"posterior means differ by {r['z']:.2f} MC s.e.")


def gradient_path():
    from repro_torch import api
    from repro_torch import random as jr
    from repro_torch.data import softmax_data
    from repro_torch.kernels.bright_glm import ops as bops
    from repro_torch.kernels.z_update import ops as zops
    from repro_torch.models.bayes_glm import GLMModel

    data = softmax_data(jr.key(5), n=N_CIFAR, d=D_CIFAR, k=K_CIFAR)
    model = GLMModel.softmax(data, n_classes=K_CIFAR)
    theta_map = model.map_estimate(jr.key(6), steps=200)
    tuned = model.map_tuned(theta_map)
    alg = api.firefly(tuned, kernel="mala", capacity=1024, cand_capacity=1024,
                      q_db=0.01, step_size=0.002, adapt_target="auto",
                      num_warmup=50)
    bops.launch_count = 0
    zops.launch_count = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = api.sample(alg, jr.key(7), 100, num_chains=2, init_position=theta_map)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 100
    launches = {"bright_glm": bops.launch_count, "z_update": zops.launch_count}
    want = {"bright_glm": 3 * tr.steps_run + tr.inits_run,
            "z_update": tr.steps_run}
    if launches != want:
        raise AssertionError(f"gradient path launches {launches}, want {want}")
    th = tr.theta.cpu().numpy()
    if th.shape != (2, 100, K_CIFAR, D_CIFAR) or not np.isfinite(th).all():
        raise AssertionError("gradient path produced bad samples")
    acc = float(tr.stats.accept_prob.mean())
    log(f"gradient path [softmax/MALA N={N_CIFAR} D={D_CIFAR} K={K_CIFAR}, "
        "2 chains, 100 iters]: "
        f"accept {acc:.3f}, bright {float(tr.stats.n_bright.double().mean()):.1f}, "
        f"queries/iter {float(tr.stats.lik_queries.double().mean()):.1f}, "
        f"ms/iter {ms:.3f}, launches {launches}")
    if not 0.0 < acc:
        raise AssertionError("MALA never accepted")
    return launches


def exactness(mnist):
    from repro_torch import api
    from repro_torch import random as jr
    from repro_torch.models.bayes_glm import GLMModel

    model = GLMModel.logistic(mnist)
    tuned = model.map_tuned(model.map_estimate(jr.key(2), steps=200))

    def run(cap, key, n, **kw):
        alg = api.firefly(tuned, kernel="rwmh", capacity=cap, cand_capacity=cap,
                          q_db=0.01, step_size=0.02, adapt_target="auto",
                          num_warmup=50)
        return api.sample(alg, key, n, **kw)

    key = jr.key(11)
    big = run(CAPACITY, key, 150, num_chains=2)
    small = run(64, key, 150, num_chains=2, chunk_size=25)
    if not small.steps_run > 150:
        raise AssertionError("capacity 64 never overflowed")
    if not torch.equal(big.theta, small.theta):
        raise AssertionError("capacity 64 run differs from capacity 512 run")
    for a, b in zip(big.stats, small.stats):
        if not torch.equal(a, b):
            raise AssertionError("capacity 64 stats differ from capacity 512")
    k_init, k_steps = jr.split(key)
    init_keys, chain_keys = jr.split(k_init, 2), jr.split(k_steps, 2)
    alg = big.algorithm
    for c in range(2):
        st = alg.init(init_keys[c:c + 1], alg.default_position[None])
        one = api.sample(alg, chain_keys[c], 150, init_state=st)
        if not torch.equal(one.theta[0], big.theta[c]):
            raise AssertionError(f"chain {c} alone differs from the batched run")
    log(f"exactness: capacity 64 ({small.steps_run} steps run, grown to "
        f"{small.algorithm.spec.capacity}) == capacity 512, bitwise; 2 batched "
        f"chains == chains run alone, bitwise")


# ---------------------------------------------------------------------------
# 1. LM kernel phases, 5. serving exactness, 6. the serving path
# ---------------------------------------------------------------------------


def _ring_pos(w: int, t: int, dev) -> torch.Tensor:
    """Ring positions after writing 0..t: slot s holds the largest p <= t
    with p ≡ s (mod W), or -1."""
    slots = torch.arange(w)
    p = slots + torch.div(t - slots, w, rounding_mode="floor") * w
    return torch.where(p >= 0, p, -1).to(torch.int32).to(dev)


def decode_attention_phase(name, b, h, hk, d, w, t, window, dtype, dev, gen):
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    q = torch.randn(b, h, d, generator=gen).to(dev)
    k = torch.randn(b, w, hk, d, generator=gen).to(dtype).to(dev)
    v = torch.randn(b, w, hk, d, generator=gen).to(dtype).to(dev)
    pos = _ring_pos(w, t, dev)
    args = (q, k, v, pos, t, window)
    got = ops.decode_attention(*args)
    want = decode_attention_ref(*args)
    torch.cuda.synchronize()
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)
    err = max(float((a - r).abs().max()) for a, r in zip(got, want))
    call = lambda: ops.decode_attention(*args)
    ms = median_ms(call)
    dev_ms = device_ms(call, ("decode_attention_kernel",))
    plain = median_ms(lambda: decode_attention_ref(*args))
    # Yardstick: one library call of the same function (GQA, boolean mask).
    valid = (pos >= 0) & (pos <= t)
    if window is not None:
        valid &= pos > t - window
    qs = q.to(dtype).view(b, h, 1, d)
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    mask = valid.view(1, 1, 1, w)
    sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                  enable_gqa=True)
    lib_err = float((sdpa().float().view(b, h, d) - want[0]).abs().max())
    lib_ms = median_ms(sdpa)
    n_valid = int(valid.sum())
    g = h // hk
    b_ms, b_by = bound(2 * b * n_valid * hk * d * k.element_size()
                       + 2 * b * h * d * 4 + 2 * b * hk * g * 4 + w * 4,
                       4.0 * b * h * n_valid * d)
    log(f"decode_attention[{name}: B={b} H={h} Hk={hk} D={d} W={w} t={t} "
        f"window={window} {str(dtype)[6:]}] max|Δ|={err:.3g}, call {ms:.4f} ms "
        f"(device {dev_ms:.6f} ms), plain {plain:.4f} ms, library (sdpa) "
        f"{lib_ms:.4f} ms (max|Δ| {lib_err:.3g}), bound {b_ms:.6f} ms ({b_by})")
    return {"phase": name, "B": b, "H": h, "Hk": hk, "D": d, "W": w, "t": t,
            "window": window, "dtype": str(dtype)[6:], "max_abs_err": err,
            "ms": dev_ms, "call_ms": ms, "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}


def rglru_phase(name, b, s, c, log_a, with_h0, dev, gen):
    from repro_torch.kernels.rglru_scan import ops
    from repro_torch.kernels.rglru_scan.ref import rglru_ref

    la = (log_a * (0.9 + 0.2 * torch.rand(b, s, c, generator=gen))).to(dev)
    bx = torch.randn(b, s, c, generator=gen).to(dev)
    h0 = torch.randn(b, c, generator=gen).to(dev) if with_h0 else None
    y, hf = ops.rglru_scan(la, bx, h0)
    y_ref, hf_ref = rglru_ref(la, bx, h0)
    torch.cuda.synchronize()
    if not (torch.isfinite(y).all() and torch.isfinite(hf).all()):
        raise AssertionError(f"rglru_scan[{name}] is not finite")
    torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(hf, hf_ref, rtol=1e-5, atol=1e-5)
    err = float((y - y_ref).abs().max())
    call = lambda: ops.rglru_scan(la, bx, h0)
    ms = median_ms(call)
    dev_ms = device_ms(call, ("rglru_scan_kernel",))
    plain = median_ms(lambda: rglru_ref(la, bx, h0), reps=5, warm=1)
    b_ms, b_by = bound(3 * b * s * c * 4 + b * c * 4 * (2 if with_h0 else 1),
                       3.0 * b * s * c)
    log(f"rglru_scan[{name}: B={b} S={s} C={c} log_a≈{log_a:g} h0={with_h0}] "
        f"max|Δ|={err:.3g}, call {ms:.4f} ms (device {dev_ms:.6f} ms), plain "
        f"{plain:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    return {"phase": name, "B": b, "S": s, "C": c, "log_a": log_a,
            "max_abs_err": err, "ms": dev_ms, "call_ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by}


def lm_kernel_phases(dev):
    """Both LM kernels at the shapes the serving path gives them, read off
    the published config: MQA heads of the local attention over a full
    window, and the RG-LRU width over the serving prompt."""
    from repro_torch.configs import get_config

    cfg = get_config(ARCH)
    h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    w = cfg.local_attn_window
    gen = torch.Generator().manual_seed(12)
    bf16 = torch.bfloat16
    attn = [
        decode_attention_phase("path-wrapped", SERVE_BATCH, h, hk, d, w,
                               SERVE_PROMPT + 96, w, bf16, dev, gen),
        decode_attention_phase("path-partial", SERVE_BATCH, h, hk, d, w,
                               w // 2 - 24, w, bf16, dev, gen),
        decode_attention_phase("f32-gqa", SERVE_BATCH, 8, 2, 128, w // 2,
                               w // 2 - 324, None, torch.float32, dev, gen),
    ]
    scan = [
        rglru_phase("path", SERVE_BATCH, SERVE_PROMPT, cfg.rnn_dim, -5.0,
                    False, dev, gen),
        rglru_phase("slow-decay", SERVE_BATCH, SERVE_PROMPT, cfg.rnn_dim,
                    -1e-6, True, dev, gen),
    ]
    torch.cuda.empty_cache()
    return attn, scan


def serve_exactness(dev):
    """tests/test_serving.py::test_decode_matches_forward at the published
    width, in float32: prefill + one decode step against the full forward."""
    from repro_torch.configs import get_config
    from repro_torch.models import serving as SV
    from repro_torch.models import transformer as T

    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    model = T.init_model(cfg, 0, dev, torch.float32)
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (EXACT_BATCH, EXACT_PROMPT + 1),
                         generator=gen, device=dev)
    seq_len = EXACT_PROMPT + 1
    with torch.inference_mode():
        cache, _ = SV.prefill(model, toks[:, :EXACT_PROMPT], seq_len,
                              torch.float32, torch.float32)
        nxt, logits, cache = SV.decode_step(model, cache,
                                            toks[:, EXACT_PROMPT:], seq_len,
                                            torch.float32)
        del cache
        h = T.forward_hidden(model, toks, torch.float32)
        ref = (h[:, -1:] @ model.embed.head).float()
    torch.cuda.synchronize()
    err = float((logits - ref).abs().max())
    torch.testing.assert_close(logits, ref, rtol=2e-3, atol=2e-3)
    if not torch.equal(nxt[:, 0], ref[:, 0].argmax(-1)):
        raise AssertionError("greedy token differs from the forward's argmax")
    log(f"serving exactness [{ARCH} full width, {n_params / 1e9:.3f} B "
        f"params, float32, batch {EXACT_BATCH}]: prefill {EXACT_PROMPT} + 1 "
        f"decode step vs forward over {seq_len} tokens: max|Δ logits| "
        f"{err:.3g} (tolerance 2e-3), greedy tokens {nxt[:, 0].tolist()} == "
        f"forward argmax; {time.perf_counter() - t0:.1f} s")
    del model, h, ref, logits
    torch.cuda.empty_cache()


def serve_path(dev):
    """The LM serving path through its entry point; returns its kernels'
    launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as aops
    from repro_torch.kernels.rglru_scan import ops as rops
    from repro_torch.launch.serve import serve

    torch.cuda.reset_peak_memory_stats(dev)
    aops.launch_count = 0
    rops.launch_count = 0
    ids, stats = serve(ARCH, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                       gen=SERVE_GEN, seed=0, full=True, dtype=torch.bfloat16,
                       device=dev)
    launches = {"decode_attention": aops.launch_count,
                "rglru_scan": rops.launch_count}
    peak = torch.cuda.max_memory_allocated(dev)
    steps = SERVE_GEN - 1
    want = {"decode_attention": 12 * steps, "rglru_scan": 26}
    if launches != want:
        raise AssertionError(f"serving launches {launches}, want {want}")
    vocab = get_config(ARCH).vocab_size
    if ids.shape != (SERVE_BATCH, SERVE_GEN) or not bool(
            ((ids >= 0) & (ids < vocab)).all()):
        raise AssertionError(f"bad generated ids {tuple(ids.shape)}")
    log(f"serve path [{ARCH} full width, bf16, batch {SERVE_BATCH}, prompt "
        f"{SERVE_PROMPT}, {SERVE_GEN} greedy tokens]: prefill "
        f"{stats['prefill_s'] * 1e3:.3f} ms, decode "
        f"{stats['decode_s'] * 1e3 / steps:.3f} ms/token ({steps} steps), "
        f"{stats['tok_per_s']:.1f} tok/s, peak memory {peak / 2**30:.2f} GiB; "
        f"launches per prefill: rglru_scan {launches['rglru_scan']}; per "
        f"decode step: decode_attention {launches['decode_attention'] / steps:g}; "
        f"first tokens {ids[0, :8].tolist()}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build

    card = card_line()
    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    log(f"card: {card}")
    log(f"kernel build: {build_s:.1f} s (nvcc, sm_90a, {len(list(_build.CSRC.glob('*.cu')))} sources)")
    build_log = _build.BUILD_DIR / "build.log"
    if build_log.exists():
        for line in build_log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())

    bright, z, mnist = kernel_phases(dev)
    attn, scan = lm_kernel_phases(dev)
    launches = main_path(mnist)
    convergence_path()
    gradient_path()
    exactness(mnist)
    del mnist
    torch.cuda.empty_cache()

    serve_exactness(dev)
    serve_launches = serve_path(dev)

    main_b = next(p for p in bright if p["phase"] == "logistic")
    main_z = next(p for p in z if p["phase"] == "mnist")
    table = {"kernels": [
        {"name": "bright_glm", "route": "cuda",
         "source": "src/repro_torch/csrc/bright_glm.cu",
         "replaces": "src/repro/kernels/bright_glm/kernel.py:173",
         "launches": launches["bright_glm"],
         "max_abs_err": max(p["max_abs_err"] for p in bright),
         "ms": main_b["ms"], "call_ms": main_b["call_ms"],
         "plain_ms": main_b["plain_ms"],
         "bound_ms": main_b["bound_ms"], "bound_by": main_b["bound_by"],
         "library_ms": None, "phases": bright},
        {"name": "z_update", "route": "cuda",
         "source": "src/repro_torch/csrc/z_update.cu",
         "replaces": "src/repro/kernels/z_update/kernel.py:129",
         "launches": launches["z_update"], "max_abs_err": 0.0,
         "ms": main_z["ms"], "call_ms": main_z["call_ms"],
         "plain_ms": main_z["plain_ms"],
         "bound_ms": main_z["bound_ms"], "bound_by": main_z["bound_by"],
         "library_ms": None, "phases": z},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention/kernel.py:115",
         "launches": serve_launches["decode_attention"],
         "max_abs_err": max(p["max_abs_err"] for p in attn),
         "ms": attn[0]["ms"], "call_ms": attn[0]["call_ms"],
         "plain_ms": attn[0]["plain_ms"], "bound_ms": attn[0]["bound_ms"],
         "bound_by": attn[0]["bound_by"], "library_ms": attn[0]["library_ms"],
         "phases": attn},
        {"name": "rglru_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru_scan/kernel.py:61",
         "launches": serve_launches["rglru_scan"],
         "max_abs_err": max(p["max_abs_err"] for p in scan),
         "ms": scan[0]["ms"], "call_ms": scan[0]["call_ms"],
         "plain_ms": scan[0]["plain_ms"], "bound_ms": scan[0]["bound_ms"],
         "bound_by": scan[0]["bound_by"], "library_ms": None,
         "phases": scan},
    ]}
    log(card)  # as nvidia-smi prints it: name, power limit
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
