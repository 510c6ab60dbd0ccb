#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``, at
first use), then runs four paths — the FlyMC chain, the recurrentgemma-9b
and the rwkv6-7b LM serving paths, and the recurrentgemma-9b training step —
each with its kernels (six in all):

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
   ≈ -1e-6); ``rwkv6_scan`` (B=4, H=64, D=64 with a carried-in state: the
   path's 512-step time chunk with log w uniform in [-1, -1e-6], the edge
   decay log w ≡ -1, S=32 (chunk 32) and S=1), to rtol 1e-5 plus 1e-5 of
   the largest value (products in 3xTF32 on the tensor cores, float32
   sums in another order, scaled by e^{±cumsum log w});
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
   per decode step;
7. checks the rwkv6-7b serving contract at its published width in float32
   (32 layers, d_model 4096, 64 heads × 64, d_ff 14,336, vocab 65,536;
   the init's zero token-shift mixes, decay LoRA and bonus overwritten with
   seeded random values): prefill 1024 tokens (two 512-step time chunks,
   so the WKV state carries across), then 64 teacher-forced decode steps,
   each step's logits against the full forward over 1088 tokens at that
   position (rtol/atol 2e-3; the forward runs 17 time chunks of 64) and
   each greedy token against the forward's argmax; 64 ``rwkv6_scan``
   launches in the prefill, none in decode;
8. drives the rwkv6-7b serving path once through ``serve`` at the published
   width in bfloat16: batch 4, a 2048-token prompt, 32 greedy tokens;
   prints prefill ms, decode ms/token, tokens/s and peak memory, and checks
   128 ``rwkv6_scan`` launches (32 layers × 4 time chunks of the prefill);
9. holds ``fused_ce`` against its plain version at the training path's
   shape (T = 4096 tokens, D = 4096, V = 256,000; bf16 inputs in the path's
   mode, which rounds each logit to bf16, and in the float32-products mode,
   f32 inputs, and a ragged T = 4095 in the path's mode; labels at vocab
   column 0, V − 1 and both sides of a split boundary), ``lse`` and ``tgt``
   to 1e-4 absolute (in the rounding mode on 99% of the tokens, the rest
   within one more bf16 ulp), with ``F.cross_entropy(x @ w)`` as the
   library yardstick (its max|Δ nll| printed) and the bound at the bf16
   tensor-core peak (bf16 inputs: the TMA-fed ``wgmma`` kernel, its TFLOP/s
   printed) or the f32 CUDA-core peak (f32 inputs);
10. checks the backwards on the card: ``FusedCE`` (f32, the path's shape)
   against autograd through the plain version over token chunks, dx and dw
   within 1e-4 of their largest value; ``RGLRUScan`` (B=2, S=2048, C=4096;
   log a ≈ -5 and ≈ -1e-6 with h0) against autograd through the plain loop,
   rtol 1e-5 plus 1e-5 of the largest value, its backward one more launch;
11. drives the training path through ``repro_torch.launch.train.
   train_reduced`` at the published width cut to 3 layers (rglru, rglru,
   attn; 2.603 B params), f32 master weights and AdamW state, bf16
   compute, batch 2 × 2048 tokens, 6 steps: prints each step's loss, grad
   norm and lr, the median step ms after the first, tokens/s and peak
   memory, and checks a finite loss, 1 ``fused_ce`` and 4 ``rglru_scan``
   launches per step;
12. a descent check: 8 ``make_train_step`` steps (warmup 1) on one fixed
   batch at that width; the last loss must be below the first.

Any failure raises (nonzero exit, no result line). The build's ptxas
registers, shared memory and spills are printed per kernel. The last two
lines are the ``{"kernels": [...]}`` table and ``{"ok": true, "device":
{...}}``. Needs one CUDA card; imports nothing of JAX.
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
BF16_FLOP_PER_S = 989e12  # H100 SXM, bf16 tensor cores, dense

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
# LM serving path: rwkv6-7b at its published width.
RWKV_ARCH = "rwkv6-7b"
RWKV_BATCH, RWKV_PROMPT, RWKV_GEN = 4, 2048, 32
RWKV_EXACT_BATCH, RWKV_EXACT_PROMPT, RWKV_EXACT_STEPS = 2, 1024, 64
# LM training path: recurrentgemma-9b at its published width, depth cut to
# one (rglru, rglru, attn) group: 38 layers' f32 weights, gradients and
# AdamW moments (137 GB) do not fit one 80 GB card.
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 3, 2, 2049, 6
DESCENT_STEPS = 8
CE_TOKENS = TRAIN_BATCH * (TRAIN_SEQ - 1)  # fused_ce's T on the path: 4096


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


def bound(bytes_moved: float, flops: float,
          flop_per_s: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_f = flops / flop_per_s * 1e3
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
    dev_ms = device_ms(call, ("decode_attention_split",
                              "decode_attention_merge"))
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
    split, n_split = ops.plan_splits(b * hk, w, ops.sm_count(dev.index))
    b_ms, b_by = bound(2 * b * n_valid * hk * d * k.element_size()
                       + 2 * b * h * d * 4 + 2 * b * hk * g * 4 + w * 4,
                       4.0 * b * h * n_valid * d)
    log(f"decode_attention[{name}: B={b} H={h} Hk={hk} D={d} W={w} t={t} "
        f"window={window} {str(dtype)[6:]}; {n_split} splits of {split} "
        f"slots] max|Δ|={err:.3g}, call {ms:.4f} ms "
        f"(device {dev_ms:.6f} ms), plain {plain:.4f} ms, library (sdpa) "
        f"{lib_ms:.4f} ms (max|Δ| {lib_err:.3g}), bound {b_ms:.6f} ms ({b_by})")
    return {"phase": name, "B": b, "H": h, "Hk": hk, "D": d, "W": w, "t": t,
            "window": window, "dtype": str(dtype)[6:], "splits": n_split,
            "split_slots": split, "max_abs_err": err,
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


def rwkv_phase(name, b, h, s, d, logw, dev, gen):
    """``rwkv6_scan`` against its plain version at (B, H, S, D) with a
    carried-in state; ``logw`` None draws log w uniform in [-1, -1e-6] (the
    model's clip), else every step decays by e^{logw}."""
    from repro_torch.kernels.rwkv6_scan import ops
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_chunked_ref

    r, k, v = (torch.randn(b, h, s, d, generator=gen).to(dev)
               for _ in range(3))
    lw = (-(1e-6 + (1.0 - 1e-6) * torch.rand(b, h, s, d, generator=gen))
          if logw is None else torch.full((b, h, s, d), logw)).to(dev)
    u = torch.randn(h, d, generator=gen).to(dev)
    s0 = torch.randn(b, h, d, d, generator=gen).to(dev)
    args = (r, k, v, lw, u, s0)
    c = min(64, s)
    y, st = ops.rwkv6_scan(*args)
    y_ref, st_ref = rwkv6_chunked_ref(*args, chunk=c)
    torch.cuda.synchronize()
    if not (torch.isfinite(y).all() and torch.isfinite(st).all()):
        raise AssertionError(f"rwkv6_scan[{name}] is not finite")
    for a, ref in ((y, y_ref), (st, st_ref)):
        torch.testing.assert_close(a, ref, rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()))
    err = max(float((y - y_ref).abs().max()), float((st - st_ref).abs().max()))
    call = lambda: ops.rwkv6_scan(*args)
    ms = median_ms(call)
    dev_ms = device_ms(call, ("rwkv6_scan_kernel",))
    plain = median_ms(lambda: rwkv6_chunked_ref(*args, chunk=c))
    # bytes: r, k, v, logw, u and state0 in, y and the state out; operations:
    # per chunk the four products of the closed form, in FMAs c(c-1)/2·D for
    # each of the two strictly lower triangular ones (rq·kkᵀ and A·v) and
    # c·D² for each of rq·S₀ and k2ᵀ·v, two flops each
    b_ms, b_by = bound(4 * (5 * b * h * s * d + h * d + 2 * b * h * d * d),
                       2.0 * b * h * (s // c) * (c * (c - 1) * d + 2 * c * d * d))
    log(f"rwkv6_scan[{name}: B={b} H={h} S={s} D={d} c={c} "
        f"logw={'U[-1,-1e-6]' if logw is None else logw}] max|Δ|={err:.3g} "
        f"(max|y| {float(y_ref.abs().max()):.4g}), call {ms:.4f} ms (device "
        f"{dev_ms:.6f} ms), plain {plain:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    return {"phase": name, "B": b, "H": h, "S": s, "D": d, "c": c,
            "logw": logw, "max_abs_err": err, "ms": dev_ms, "call_ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by}


def rwkv_kernel_phases(dev):
    """``rwkv6_scan`` at the shapes the rwkv6-7b serving path gives it: the
    published heads over one 512-step time chunk of the batch-4 prefill."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import RWKV_TIME_CHUNK

    cfg = get_config(RWKV_ARCH)
    h, d = cfg.n_heads, cfg.resolved_head_dim
    gen = torch.Generator().manual_seed(13)
    phases = [
        rwkv_phase("path", RWKV_BATCH, h, RWKV_TIME_CHUNK, d, None, dev, gen),
        rwkv_phase("edge-decay", RWKV_BATCH, h, RWKV_TIME_CHUNK, d, -1.0, dev,
                   gen),
        rwkv_phase("short", RWKV_BATCH, h, 32, d, None, dev, gen),
        rwkv_phase("single", RWKV_BATCH, h, 1, d, None, dev, gen),
    ]
    torch.cuda.empty_cache()
    return phases


def _randomize_rwkv_zero_inits(model, seed: int) -> None:
    """Overwrite the init's zero token-shift mixes ``mu`` (uniform in [0,
    1]), decay LoRA ``wb`` and bonus ``u`` with seeded values, so a wrong
    shift, decay or bonus path shows."""
    gen = torch.Generator(device=model.embed.table.device).manual_seed(seed)
    with torch.no_grad():
        for blk in model.blocks:
            w = blk.mix
            w.mu.copy_(torch.rand(w.mu.shape, generator=gen,
                                  device=w.mu.device))
            w.wb.copy_(0.3 * torch.randn(w.wb.shape, generator=gen,
                                         device=w.wb.device))
            w.u.copy_(0.5 * torch.randn(w.u.shape, generator=gen,
                                        device=w.u.device))


def rwkv_serve_exactness(dev):
    """The rwkv6-7b serving contract at the published width, in float32:
    prefill, then teacher-forced decode steps, against the full forward at
    each position. Returns the parameter count."""
    from repro_torch.configs import get_config
    from repro_torch.configs.rwkv6_7b import N_PARAMS
    from repro_torch.kernels.rwkv6_scan import ops as wops
    from repro_torch.models import serving as SV
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import RWKV_TIME_CHUNK

    cfg = get_config(RWKV_ARCH)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = T.init_model(cfg, 0, dev, torch.float32)
    _randomize_rwkv_zero_inits(model, seed=7)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != N_PARAMS:
        raise AssertionError(f"{RWKV_ARCH}: {n_params} parameters")
    n, steps = RWKV_EXACT_PROMPT, RWKV_EXACT_STEPS
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (RWKV_EXACT_BATCH, n + steps),
                         generator=gen, device=dev)
    seq_len = n + steps
    with torch.inference_mode():
        wops.launch_count = 0
        cache, _ = SV.prefill(model, toks[:, :n], seq_len, torch.float32,
                              torch.float32)
        torch.cuda.synchronize()
        prefill_launches = wops.launch_count
        wops.launch_count = 0
        logits = []
        for i in range(steps):
            nxt, lg, cache = SV.decode_step(model, cache, toks[:, n + i:n + i + 1],
                                            seq_len, torch.float32)
            logits.append(lg[:, 0])
        decode_launches = wops.launch_count
        del cache
        got = torch.stack(logits, 1)  # (B, steps, V)
        h = T.forward_hidden(model, toks, torch.float32)
        ref = (h[:, n:] @ model.embed.head).float()
    torch.cuda.synchronize()
    want_prefill = cfg.n_layers * (n // RWKV_TIME_CHUNK)
    if (prefill_launches, decode_launches) != (want_prefill, 0):
        raise AssertionError(
            f"rwkv6_scan launches: prefill {prefill_launches} (want "
            f"{want_prefill}), decode {decode_launches} (want 0)")
    err = float((got - ref).abs().max())
    # the gap step by step: rounding stays flat, a drift of the carried state
    # grows with the step
    by_step = (got - ref).abs().amax(dim=(0, 2)).tolist()
    by_block = [max(by_step[i:i + 8]) for i in range(0, steps, 8)]
    torch.testing.assert_close(got, ref, rtol=2e-3, atol=2e-3)
    greedy, want = got.argmax(-1), ref.argmax(-1)
    if not torch.equal(greedy, want):
        top2 = ref.topk(2, dim=-1).values
        bad = (greedy != want).nonzero().tolist()
        raise AssertionError(
            f"greedy tokens differ from the forward's argmax at (row, step) "
            f"{bad[:8]}; forward top-2 margins there "
            f"{[float(top2[r, i, 0] - top2[r, i, 1]) for r, i in bad[:8]]}")
    log(f"rwkv serving exactness [{RWKV_ARCH} full width, {n_params / 1e9:.3f} "
        f"B params, float32, batch {RWKV_EXACT_BATCH}, mu/wb/u random]: prefill "
        f"{n} + {steps} teacher-forced decode steps vs forward over {seq_len} "
        f"tokens: max|Δ logits| {err:.3g} (tolerance 2e-3, max|logit| "
        f"{float(ref.abs().max()):.3g}); max|Δ| at decode steps 1, 2, "
        f"{steps // 2}, {steps}: {by_step[0]:.3g}, {by_step[1]:.3g}, "
        f"{by_step[steps // 2 - 1]:.3g}, {by_step[-1]:.3g}; per 8 steps "
        f"{[float(f'{e:.3g}') for e in by_block]}; {steps * RWKV_EXACT_BATCH} "
        f"greedy tokens == forward argmax; rwkv6_scan launches: prefill "
        f"{prefill_launches}, decode {decode_launches}; "
        f"{time.perf_counter() - t0:.1f} s")
    del model, h, ref, got, logits
    torch.cuda.empty_cache()
    return n_params


def rwkv_serve_path(dev):
    """The rwkv6-7b serving path through its entry point; returns its
    kernels' launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as aops
    from repro_torch.kernels.rglru_scan import ops as rops
    from repro_torch.kernels.rwkv6_scan import ops as wops
    from repro_torch.launch.serve import serve
    from repro_torch.models.layers import RWKV_TIME_CHUNK

    cfg = get_config(RWKV_ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    aops.launch_count = rops.launch_count = wops.launch_count = 0
    ids, stats = serve(RWKV_ARCH, batch=RWKV_BATCH, prompt_len=RWKV_PROMPT,
                       gen=RWKV_GEN, seed=0, full=True, dtype=torch.bfloat16,
                       device=dev)
    launches = {"rwkv6_scan": wops.launch_count,
                "decode_attention": aops.launch_count,
                "rglru_scan": rops.launch_count}
    peak = torch.cuda.max_memory_allocated(dev)
    steps = RWKV_GEN - 1
    want = {"rwkv6_scan": cfg.n_layers * (RWKV_PROMPT // RWKV_TIME_CHUNK),
            "decode_attention": 0, "rglru_scan": 0}
    if launches != want:
        raise AssertionError(f"rwkv serving launches {launches}, want {want}")
    if ids.shape != (RWKV_BATCH, RWKV_GEN) or not bool(
            ((ids >= 0) & (ids < cfg.vocab_size)).all()):
        raise AssertionError(f"bad generated ids {tuple(ids.shape)}")
    log(f"serve path [{RWKV_ARCH} full width, bf16, batch {RWKV_BATCH}, prompt "
        f"{RWKV_PROMPT}, {RWKV_GEN} greedy tokens]: prefill "
        f"{stats['prefill_s'] * 1e3:.3f} ms, decode "
        f"{stats['decode_s'] * 1e3 / steps:.3f} ms/token ({steps} steps), "
        f"{stats['tok_per_s']:.1f} tok/s, peak memory {peak / 2**30:.2f} GiB; "
        f"launches per prefill: rwkv6_scan {launches['rwkv6_scan']}, none in "
        f"decode; first tokens {ids[0, :8].tolist()}")
    return launches


# ---------------------------------------------------------------------------
# 9. fused_ce, 10. the backwards, 11. the training path, 12. descent
# ---------------------------------------------------------------------------


def _check_rounded(name, got, ref):
    """Rounding mode: each logit is rounded to bf16, and the kernel's and the
    plain version's float32 sums may round one to neighbouring bf16 values.
    Within 1e-4 on at least 99% of the tokens, and within 1e-4 plus one bf16
    ulp of the plain value on every token."""
    err = (got - ref).abs()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
    frac = float((err > 1e-4).float().mean())
    if frac > 0.01 or bool((err > 1e-4 + ulp).any()):
        raise AssertionError(f"fused_ce[{name}]: {frac:.4f} of the tokens "
                             f"beyond 1e-4, max|Δ| {float(err.max()):.3g}")
    return frac


def fused_ce_phase(name, t, d, v, dtype, dev, gen, round_logits=False):
    """``fused_ce`` against its plain version at (T, D, V) with labels at
    vocab column 0, V - 1 and both sides of a split boundary; ``lse`` and
    ``tgt`` to 1e-4 absolute (float32 sums of D products in another order,
    values O(10)), or, with ``round_logits`` (each logit rounded to bf16, the
    training path's loss), by :func:`_check_rounded`. Times the kernel, the
    plain version and the library yardstick ``F.cross_entropy(x @ w)`` (two
    PyTorch calls, in ``dtype``: a bf16 product rounds its logits to bf16,
    so in the rounding mode it computes the same function)."""
    import torch.nn.functional as F

    from repro_torch.kernels.fused_ce import ops
    from repro_torch.kernels.fused_ce.ref import fused_ce_ref

    x = torch.randn(t, d, generator=gen, device=dev).to(dtype)
    w = (torch.randn(d, v, generator=gen, device=dev) / d**0.5).to(dtype)
    lab = torch.randint(0, v, (t,), generator=gen, device=dev)
    edge = [0, v - 1, ops.SPLIT_COLS - 1, ops.SPLIT_COLS,
            (v - 1) // ops.SPLIT_COLS * ops.SPLIT_COLS]
    lab[:len(edge)] = torch.tensor([min(e, v - 1) for e in edge], device=dev)
    lse, tgt = ops.lse_and_target(x, w, lab, round_logits)
    lse_ref, tgt_ref = fused_ce_ref(x, w, lab, round_logits)
    torch.cuda.synchronize()
    if not (torch.isfinite(lse).all() and torch.isfinite(tgt).all()):
        raise AssertionError(f"fused_ce[{name}] is not finite")
    flipped = None
    if round_logits:
        flipped = max(_check_rounded(name, lse, lse_ref),
                      _check_rounded(name, tgt, tgt_ref))
    else:
        torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-4)
        torch.testing.assert_close(tgt, tgt_ref, rtol=0, atol=1e-4)
    err = max(float((lse - lse_ref).abs().max()),
              float((tgt - tgt_ref).abs().max()))
    del lse_ref, tgt_ref
    call = lambda: ops.lse_and_target(x, w, lab, round_logits)
    dev_ms = device_ms(call, ("ce_wgmma_kernel", "ce_tiles_kernel",
                              "ce_merge_kernel"), reps=3)
    ms = median_ms(call, reps=3, warm=1)
    plain = median_ms(lambda: fused_ce_ref(x, w, lab, round_logits), reps=3,
                      warm=1)
    lib = lambda: F.cross_entropy(x @ w, lab, reduction="none")
    lib_err = float((lib().float() - (lse - tgt)).abs().max())
    lib_ms = median_ms(lib, reps=5, warm=1)
    es = x.element_size()
    b_ms, b_by = bound(t * d * es + d * v * es + t * 8 + t * 8,
                       2.0 * t * d * v,
                       BF16_FLOP_PER_S if dtype == torch.bfloat16
                       else FP32_FLOP_PER_S)
    mode = ", bf16 logits" if round_logits else ""
    beyond = ("" if flipped is None
              else f", {flipped:.2g} of the tokens beyond 1e-4")
    log(f"fused_ce[{name}: T={t} D={d} V={v} {str(dtype)[6:]}{mode}] max|Δ|="
        f"{err:.3g}{beyond} (max lse {float(lse.max()):.4g}), call {ms:.4f} ms "
        f"(device {dev_ms:.6f} ms, {2.0 * t * d * v / dev_ms / 1e9:.1f} "
        f"TFLOP/s), plain {plain:.4f} ms, library (x@w + cross_entropy) "
        f"{lib_ms:.4f} ms (max|Δ nll| {lib_err:.3g}), bound {b_ms:.6f} ms "
        f"({b_by})")
    del x, w
    torch.cuda.empty_cache()
    return {"phase": name, "T": t, "D": d, "V": v, "dtype": str(dtype)[6:],
            "round_logits": round_logits, "max_abs_err": err, "ms": dev_ms,
            "call_ms": ms, "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms,
            "library_max_abs_err": lib_err}


def fused_ce_grad_phase(t, d, v, dev, gen):
    """``FusedCE``'s backward (the reference's chunk VJP) at the path's
    shape in float32, against autograd through the plain version over
    1024-token chunks: dx and dw within 1e-4 of their largest value."""
    from repro_torch.kernels.fused_ce import ops
    from repro_torch.kernels.fused_ce.ref import fused_ce_ref

    x = torch.randn(t, d, generator=gen, device=dev)
    w = torch.randn(d, v, generator=gen, device=dev) / d**0.5
    lab = torch.randint(0, v, (t,), generator=gen, device=dev)
    c = torch.rand(t, generator=gen, device=dev) / t

    def backward_ms(dtype):
        xg = x.to(dtype, copy=True).requires_grad_()
        wg = w.to(dtype, copy=True).requires_grad_()
        loss = (ops.fused_ce(xg, wg, lab) * c).sum()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, xg.grad, wg.grad

    backward_ms(torch.bfloat16)  # the first call allocates and picks kernels
    bwd_bf16_ms, _, _ = backward_ms(torch.bfloat16)  # the training step's
    torch.cuda.empty_cache()
    bwd_ms, dx, dw = backward_ms(torch.float32)
    wr = w.requires_grad_()
    dx_ref = torch.empty_like(x)
    for t0 in range(0, t, 1024):
        xc = x[t0:t0 + 1024].clone().requires_grad_()
        lse, tgt = fused_ce_ref(xc, wr, lab[t0:t0 + 1024])
        ((lse - tgt) * c[t0:t0 + 1024]).sum().backward()
        dx_ref[t0:t0 + 1024] = xc.grad
    torch.cuda.synchronize()
    errs = []
    for a, ref in ((dx, dx_ref), (dw, wr.grad)):
        scale = float(ref.abs().max())
        torch.testing.assert_close(a, ref, rtol=0, atol=1e-4 * scale)
        errs.append(float((a - ref).abs().max()) / scale)
    log(f"FusedCE backward[T={t} D={d} V={v} float32, chunks of "
        f"{ops.BWD_CHUNK}]: max|Δ dx|, max|Δ dw| = {errs[0]:.3g}, "
        f"{errs[1]:.3g} of their largest value (tolerance 1e-4); backward "
        f"{bwd_ms:.3f} ms in float32 (first call), {bwd_bf16_ms:.3f} ms in "
        f"bfloat16 (second call; host clock)")
    del x, w, wr, dx, dw, dx_ref
    torch.cuda.empty_cache()
    return {"phase": "backward-f32", "T": t, "D": d, "V": v,
            "max_rel_err": max(errs), "bwd_ms": bwd_ms,
            "bwd_bf16_ms": bwd_bf16_ms}


def rglru_grad_phase(name, b, s, c, log_a, with_h0, dev, gen):
    """``RGLRUScan``'s backward (one more scan launch, reversed in time)
    against autograd through the plain loop: ∂log_a, ∂b (and ∂h0) to rtol
    1e-5 plus 1e-5 of the largest value."""
    from repro_torch.kernels.rglru_scan import ops
    from repro_torch.kernels.rglru_scan.ref import rglru_ref

    la = (log_a * (0.9 + 0.2 * torch.rand(b, s, c, generator=gen))).to(dev)
    bx = torch.randn(b, s, c, generator=gen).to(dev)
    h0 = torch.randn(b, c, generator=gen).to(dev) if with_h0 else None
    gh = torch.randn(b, s, c, generator=gen).to(dev)
    gl = torch.randn(b, c, generator=gen).to(dev)

    def forward(scan):
        ins = [la.clone().requires_grad_(), bx.clone().requires_grad_()]
        if with_h0:
            ins.append(h0.clone().requires_grad_())
        y, hf = scan(ins[0], ins[1], ins[2] if with_h0 else None)
        return (y * gh).sum() + (hf * gl).sum(), ins

    before = ops.launch_count
    out, ins = forward(ops.rglru_scan)
    got = torch.autograd.grad(out, ins, retain_graph=True)
    torch.cuda.synchronize()
    if ops.launch_count - before != 2:
        raise AssertionError(f"rglru_scan forward + backward launched "
                             f"{ops.launch_count - before} times, want 2")
    ref_out, ref_ins = forward(rglru_ref)
    want = torch.autograd.grad(ref_out, ref_ins)
    torch.cuda.synchronize()
    err = 0.0
    for a, ref in zip(got, want):
        if not torch.isfinite(a).all():
            raise AssertionError(f"rglru_scan backward[{name}] not finite")
        scale = float(ref.abs().max())
        torch.testing.assert_close(a, ref, rtol=1e-5, atol=1e-5 * scale)
        err = max(err, float((a - ref).abs().max()))
    del ref_out, ref_ins, want
    bwd = lambda: torch.autograd.grad(out, ins, retain_graph=True)
    bwd_ms = median_ms(bwd, reps=10, warm=2)
    # bytes: log_a, the saved h and ḡ read, ∂log_a and ∂b written
    b_ms, b_by = bound(5 * b * s * c * 4 + b * c * 4 * (3 if with_h0 else 2),
                       6.0 * b * s * c)
    log(f"rglru_scan backward[{name}: B={b} S={s} C={c} log_a≈{log_a:g} "
        f"h0={with_h0}] max|Δ|={err:.3g}, backward call {bwd_ms:.4f} ms, "
        f"bound {b_ms:.6f} ms ({b_by})")
    torch.cuda.empty_cache()
    return {"phase": name, "B": b, "S": s, "C": c, "log_a": log_a,
            "max_abs_err": err, "bwd_call_ms": bwd_ms, "bound_ms": b_ms,
            "bound_by": b_by}


def train_kernel_phases(dev):
    """fused_ce at the training path's shape (T = 4096 tokens of the
    published width and vocab; bf16 in the path's rounding mode and in the
    float32-products mode, f32, and a ragged T), FusedCE's and RGLRUScan's
    backwards."""
    from repro_torch.configs import get_config

    cfg = get_config(ARCH)
    d, v = cfg.d_model, cfg.padded_vocab()
    gen = torch.Generator(device=dev).manual_seed(14)
    ce = [
        fused_ce_phase("path", CE_TOKENS, d, v, torch.bfloat16, dev, gen,
                       round_logits=True),
        fused_ce_phase("f32-products", CE_TOKENS, d, v, torch.bfloat16, dev,
                       gen),
        fused_ce_phase("f32", CE_TOKENS, d, v, torch.float32, dev, gen),
        fused_ce_phase("ragged-T", CE_TOKENS - 1, d, v, torch.bfloat16, dev,
                       gen, round_logits=True),
    ]
    ce_grad = fused_ce_grad_phase(CE_TOKENS, d, v, dev, gen)
    cgen = torch.Generator().manual_seed(15)
    scan_bwd = [
        rglru_grad_phase("backward", TRAIN_BATCH, TRAIN_SEQ - 1, cfg.rnn_dim,
                         -5.0, False, dev, cgen),
        rglru_grad_phase("backward-slow-decay", TRAIN_BATCH, TRAIN_SEQ - 1,
                         cfg.rnn_dim, -1e-6, True, dev, cgen),
    ]
    return ce, ce_grad, scan_bwd


def train_path(dev):
    """The training path through its entry point: ``train_reduced`` at the
    published width with 3 layers in bf16 (f32 master weights and AdamW
    state). Returns (launch counts, the model for the descent check)."""
    from repro_torch.kernels.decode_attention import ops as aops
    from repro_torch.kernels.fused_ce import ops as cops
    from repro_torch.kernels.rglru_scan import ops as rops
    from repro_torch.kernels.rwkv6_scan import ops as wops
    from repro_torch.launch.train import train_reduced
    from repro_torch.models.config import layer_kinds

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cops.launch_count = rops.launch_count = 0
    aops.launch_count = wops.launch_count = 0
    model, hist = train_reduced(ARCH, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                                seq=TRAIN_SEQ, log_every=TRAIN_STEPS, seed=0,
                                full=True, n_layers=TRAIN_LAYERS,
                                dtype=torch.bfloat16, device=dev)
    launches = {"fused_ce": cops.launch_count, "rglru_scan": rops.launch_count,
                "decode_attention": aops.launch_count,
                "rwkv6_scan": wops.launch_count}
    peak = torch.cuda.max_memory_allocated(dev)
    n_rglru = layer_kinds(model.cfg).count("rglru")
    want = {"fused_ce": TRAIN_STEPS, "rglru_scan": 2 * n_rglru * TRAIN_STEPS,
            "decode_attention": 0, "rwkv6_scan": 0}
    if launches != want:
        raise AssertionError(f"training launches {launches}, want {want}")
    if not all(np.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"training loss not finite: {hist}")
    n_params = sum(p.numel() for p in model.parameters())
    step_ms = statistics.median(h["seconds"] for h in hist[1:]) * 1e3
    tokens = TRAIN_BATCH * (TRAIN_SEQ - 1)
    lrs = [float(f"{h['lr']:.4g}") for h in hist]
    log(f"train path [{ARCH} full width, {TRAIN_LAYERS} layers, "
        f"{n_params / 1e9:.3f} B params, bf16 compute, f32 master + AdamW, "
        f"batch {TRAIN_BATCH} x {TRAIN_SEQ - 1} tokens, {TRAIN_STEPS} "
        f"steps]: step ms {[round(h['seconds'] * 1e3, 3) for h in hist]}, "
        f"median after the first {step_ms:.3f} ms, "
        f"{tokens / step_ms * 1e3:.1f} tokens/s, peak memory "
        f"{peak / 2**30:.2f} GiB; loss {[round(h['loss'], 4) for h in hist]}, "
        f"grad norm {[round(h['grad_norm'], 4) for h in hist]}, lr {lrs}; "
        f"launches per step: "
        f"fused_ce {launches['fused_ce'] / TRAIN_STEPS:g}, rglru_scan "
        f"{launches['rglru_scan'] / TRAIN_STEPS:g}")
    return launches, model, {"step_ms": step_ms,
                             "tokens_per_s": tokens / step_ms * 1e3,
                             "peak_gib": peak / 2**30}


def step_breakdown(model, dev):
    """One more training step at the path's width, split by CUDA events:
    the forward (``loss_fn``, with its ``fused_ce`` launch), the backward
    (``loss.backward()``, with the CE's chunked VJP and 2 ``rglru_scan``
    launches) and the optimizer (global norm, clip and AdamW over every
    parameter), as ``make_train_step`` runs them."""
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_update, warmup_cosine

    opt = T.init_opt(model)
    batch = synthetic_batch(torch.Generator(device=dev).manual_seed(98),
                            model.cfg, TRAIN_BATCH, TRAIN_SEQ)
    params = dict(model.named_parameters())
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    ev[0].record()
    loss, _ = T.loss_fn(model, batch, torch.bfloat16)
    ev[1].record()
    loss.backward()
    ev[2].record()
    grads = {n: p.grad for n, p in params.items()}
    gnorm = T.global_grad_norm(grads)
    adamw_update(params, grads, opt,
                 warmup_cosine(opt.step, peak_lr=3e-4, warmup_steps=1),
                 grad_scale=torch.clamp(1.0 / (gnorm + 1e-6), max=1.0))
    ev[3].record()
    ev[3].synchronize()
    for p in params.values():
        p.grad = None
    del opt, grads, loss
    torch.cuda.empty_cache()
    parts = {"forward_ms": ev[0].elapsed_time(ev[1]),
             "backward_ms": ev[1].elapsed_time(ev[2]),
             "optimizer_ms": ev[2].elapsed_time(ev[3])}
    log(f"train step breakdown [{ARCH} full width, {model.cfg.n_layers} "
        f"layers, bf16, batch {TRAIN_BATCH} x {TRAIN_SEQ - 1}; CUDA events]: "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    return parts


def descent_check(model, dev):
    """8 steps of ``make_train_step`` (warmup 1) on one fixed batch at the
    published width: the last loss must be below the first."""
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import transformer as T

    cfg = model.cfg
    opt = T.init_opt(model)
    step = T.make_train_step(cfg, dtype=torch.bfloat16, warmup_steps=1)
    batch = synthetic_batch(torch.Generator(device=dev).manual_seed(99), cfg,
                            TRAIN_BATCH, TRAIN_SEQ)
    losses = [float(step(model, opt, batch)["loss"])
              for _ in range(DESCENT_STEPS)]
    log(f"descent [{ARCH} full width, {cfg.n_layers} layers, one fixed batch, "
        f"warmup 1, peak lr 3e-4]: losses {[round(x, 4) for x in losses]}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"loss did not fall on a fixed batch: {losses}")
    del opt
    torch.cuda.empty_cache()


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
            if ("Compiling entry function" in line or "registers" in line
                    or "spill" in line):
                log("  ptxas: " + line.strip())

    bright, z, mnist = kernel_phases(dev)
    attn, scan = lm_kernel_phases(dev)
    wkv = rwkv_kernel_phases(dev)
    ce, ce_grad, scan_bwd = train_kernel_phases(dev)
    launches = main_path(mnist)
    convergence_path()
    gradient_path()
    exactness(mnist)
    del mnist
    torch.cuda.empty_cache()

    serve_exactness(dev)
    serve_launches = serve_path(dev)
    rwkv_serve_exactness(dev)
    rwkv_launches = rwkv_serve_path(dev)
    torch.cuda.empty_cache()

    train_launches, model, _ = train_path(dev)
    step_breakdown(model, dev)
    descent_check(model, dev)
    del model
    torch.cuda.empty_cache()

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
         "launches_train": train_launches["rglru_scan"],
         "max_abs_err": max(p["max_abs_err"] for p in scan + scan_bwd),
         "ms": scan[0]["ms"], "call_ms": scan[0]["call_ms"],
         "plain_ms": scan[0]["plain_ms"], "bound_ms": scan[0]["bound_ms"],
         "bound_by": scan[0]["bound_by"], "library_ms": None,
         "phases": scan + scan_bwd},
        {"name": "rwkv6_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/rwkv6_scan.cu",
         "replaces": "src/repro/kernels/rwkv6_scan/kernel.py:91",
         "launches": rwkv_launches["rwkv6_scan"],
         "max_abs_err": max(p["max_abs_err"] for p in wkv),
         "ms": wkv[0]["ms"], "call_ms": wkv[0]["call_ms"],
         "plain_ms": wkv[0]["plain_ms"], "bound_ms": wkv[0]["bound_ms"],
         "bound_by": wkv[0]["bound_by"], "library_ms": None, "phases": wkv},
        {"name": "fused_ce", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_ce.cu",
         "replaces": "src/repro/kernels/fused_ce/kernel.py:88",
         "launches": train_launches["fused_ce"],
         "max_abs_err": max(p["max_abs_err"] for p in ce),
         "ms": ce[0]["ms"], "call_ms": ce[0]["call_ms"],
         "plain_ms": ce[0]["plain_ms"], "bound_ms": ce[0]["bound_ms"],
         "bound_by": ce[0]["bound_by"], "library_ms": ce[0]["library_ms"],
         "phases": ce + [ce_grad]},
    ]}
    log(card)  # as nvidia-smi prints it: name, power limit
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
