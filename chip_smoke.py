#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``, at
first use), then runs its paths — the FlyMC chain (RWMH, MALA, HMC and the
paper's robust-regression slice path), the recurrentgemma-9b and the
rwkv6-7b LM serving paths, and the recurrentgemma-9b training step —
each with its kernels (six sources; ``rglru_scan.cu`` holds a forward and a
backward kernel):

1. holds each kernel against its plain PyTorch version on the card and
   times it: ``ms`` is the kernels' device time per call (torch.profiler;
   where the trace holds no record of the kernel, back-to-back calls between
   CUDA events), ``call_ms`` and ``plain_ms`` the median of warm calls
   between CUDA events, host overhead included.
   FlyMC, at the paper's widths: ``bright_glm`` for the logistic (MNIST 7v9,
   N=12,214, D=51), softmax (CIFAR-3, N=18,000, D=256, 3 classes) and
   Student-t (OPV, N=1.8M, D=57) families, δ and totals to rtol/atol 1e-5;
   ``z_update`` bitwise at N=12,214 and N=1.8M; each one device kernel a
   call (profiler); ``host`` is the host time a call over 100 back-to-back
   calls, ``queued`` the device time a call with 100 calls queued back to
   back behind a spin kernel (kernels and the gaps between them, the host's
   issue time hidden). ``z_update``'s bound is the larger of its bytes and its
   hashes, one Threefry-2x32-20 a position in [num, N), counted from the
   hash's definition and split by pipe (rotations and xors on the ALU pipe,
   64 lanes an SM; every operation within 128 issued lanes an SM), at the
   SM clock that ``nvidia-smi`` reports.
   LM serving, at the path's shapes, to rtol/atol 1e-5:
   ``decode_attention`` (B=4, H=16, Hk=1, D=256, W=2048, window 2048, bf16
   K/V; a wrapped and a partly filled ring; one f32 case with G=4, Hk=2,
   D=128), with ``scaled_dot_product_attention`` as the library yardstick;
   ``rglru_scan`` (B=4, S=2304, C=4096; log a ≈ -5, the model's decays, and
   ≈ -1e-6; and at the training shape B=2, S=2048; h_final bitwise y[:, -1];
   one device kernel a call; ``queued`` as for the FlyMC kernels);
   ``rwkv6_scan`` (B=4, H=64, D=64 with a carried-in state: the
   path's 512-step time chunk with log w uniform in [-1, -1e-6], the edge
   decay log w ≡ -1, S=32 (chunk 32) and S=1), to rtol 1e-5 plus 1e-5 of
   the largest value (products in 3xTF32 on the tensor cores, float32
   sums in another order, scaled by e^{±cumsum log w});
2. drives the FlyMC main path at the MNIST width: ``GLMModel.logistic`` →
   ``map_estimate`` → ``map_tuned`` → ``api.firefly`` (RWMH) → ``api.sample``
   with 2 chains (250 warmup, then 750 samples resumed with streaming
   collectors), counting kernel launches and printing a digest of the
   samples, and compares it with the ``regular_mcmc`` baseline
   (queries/iter, R̂, posterior means); checks under
   ``set_sync_debug_mode("warn")`` that a step never waits for the card;
   then runs the same path at the MNIST N with D = 3 to convergence
   (split-R̂ < 1.1, posterior means within 4 Monte-Carlo standard errors);
3. runs the gradient path: softmax/MALA at the CIFAR width through the
   bright-GLM ``autograd.Function``;
4. checks exactness on the card for RWMH, slice sampling and HMC: a run at
   capacity 64 (overflow re-runs) equals the run at 512 bitwise, and two
   batched chains equal the chains run one at a time; then runs HMC at the
   MNIST width (FlyMC and full-data: split-R̂, accept rate, ms/iter,
   queries/iter; launch counts; no host wait a step), the main path's
   configuration on the plain engines and in explicit mode beside the
   kernel engines (ms/iter; no kernel launch), and the paper's
   robust-regression experiment at the OPV width: ``robust_data`` (N =
   1.8M, D = 57, ν = 4), ``GLMModel.robust`` MAP-tuned (600 Adam steps),
   ``api.firefly(kernel="slice")`` over 2 chains from θ_MAP for 200
   iterations: ms/iter, queries/iter, bright count, grown capacity, density
   evaluations a step and each chain's ``n_evals``, host waits a step (the
   sync debug mode's count held to ``samplers.waits``), the posterior-mean
   RMSE against θ_true (below 0.02), launch counts worked out from the
   steps, inits and slice trips, and the full-data slice chain's
   queries/iter;
5. drives the FlyMC sampling service (``repro_torch.serve.Service``) on a
   JAX-free copy of ``benchmarks/_util.py::job_mix``'s five kinds at the
   paper's widths: 8 jobs (logistic MNIST with 1 and 2 chains, softmax
   CIFAR-3, robust OPV, and a 2-chain logistic job stopped on batch-means
   ESS, its target the ESS a solo probe run reads at the first check, so
   that it stops early), a slot budget of 8 chains (the mix has 11, so jobs
   queue and join between chunks), 128 samples in chunks of 32, the kernel
   engines; and the same jobs one after another through ``api.sample``.
   An instrumented service run (sync debug mode, counted launches) warms
   both sides; then sequential, service, service, sequential, timed.
   Prints the service's wall seconds beside the sequential runs', committed
   chain-samples/s and the re-run share of the lane-steps, latency p50/p95,
   mean slot occupancy, overflow re-runs and grown capacities, ms per
   lane-step, host waits a group chunk, launches and the ESS job's
   committed count and ESS. Checks every service run's results bitwise the
   solo runs', no fault event and every job retired on ``max_samples`` or
   ``converged``, the ESS job stopped early, the launches against the
   engines' lane-steps and inits, one host wait a group chunk without
   overflow, and both kernels against their plain versions on each
   group's final lane;
6. survives crashes on the card (``checkpoint_path``): the same jobs
   through a ``Service`` that checkpoints after every step
   (``repro_torch.checkpoint.Checkpointer``, keep 3); the save of its third
   step is killed at ``pre_rename`` and the process restarts cold from disk
   through ``Service.restore`` (which must load the second step); after one
   more step, one bit of the newest step's files is flipped, and the next
   restart must report ``checkpoint_fallback`` and load an older step; that
   service runs to the end. Every job's delivered results must be bitwise
   the uninterrupted service run's (a job replayed after a restart must
   deliver the same results twice), and the restored run must launch both
   kernels. Prints a checkpoint's bytes and the seconds of a blocking save,
   of an async save until ``save`` returns and until its write is joined,
   and of ``Service.restore``, beside the card's name and power limit. Then
   ``repro_torch.testing.chaos.run_schedule`` on the card for one seed
   whose schedule fires a checkpoint kill and a corruption;
7. checks the serving contract at recurrentgemma-9b's published width in
   float32: prefill 2100 tokens, decode one, and compare the logits with the
   full forward over 2101 tokens (rtol/atol 2e-3) and the greedy token with
   the forward's argmax;
8. drives the serving path once through ``repro_torch.launch.serve.serve``
   at the published width in bfloat16 (38 layers, d_model 4096, vocab
   256,000, seeded random weights): batch 4, a 2304-token prompt (longer
   than the 2048 window, so the ring wraps), 32 greedy tokens; prints
   prefill ms, decode ms/token, tokens/s and peak memory, and checks 26
   ``rglru_scan`` launches per prefill and 12 ``decode_attention`` launches
   per decode step;
9. checks the rwkv6-7b serving contract at its published width in float32
   (32 layers, d_model 4096, 64 heads × 64, d_ff 14,336, vocab 65,536;
   the init's zero token-shift mixes, decay LoRA and bonus overwritten with
   seeded random values): prefill 1024 tokens (two 512-step time chunks,
   so the WKV state carries across), then 64 teacher-forced decode steps,
   each step's logits against the full forward over 1088 tokens at that
   position (rtol/atol 2e-3; the forward runs 17 time chunks of 64) and
   each greedy token against the forward's argmax; 64 ``rwkv6_scan``
   launches in the prefill, none in decode;
10. drives the rwkv6-7b serving path once through ``serve`` at the published
   width in bfloat16: batch 4, a 2048-token prompt, 32 greedy tokens;
   prints prefill ms, decode ms/token, tokens/s and peak memory, and checks
   128 ``rwkv6_scan`` launches (32 layers × 4 time chunks of the prefill);
11. holds ``fused_ce`` against its plain version at the training path's
   shape (T = 4096 tokens, D = 4096, V = 256,000; bf16 inputs in the path's
   mode, which rounds each logit to bf16, and in the float32-products mode,
   f32 inputs, and a ragged T = 4095 in the path's mode; labels at vocab
   column 0, V − 1 and both sides of a split boundary), ``lse`` and ``tgt``
   to 1e-4 absolute (in the rounding mode on 99% of the tokens, the rest
   within one more bf16 ulp), with ``F.cross_entropy(x @ w)`` as the
   library yardstick (its max|Δ nll| printed) and the bound at the bf16
   tensor-core peak (bf16 inputs: the TMA-fed ``wgmma`` kernel, its TFLOP/s
   printed) or the f32 CUDA-core peak (f32 inputs);
12. checks the backwards on the card: ``FusedCE`` (f32, the path's shape)
   against autograd through the plain version over token chunks, dx and dw
   within 1e-4 of their largest value; ``RGLRUScan`` (B=2, S=2048, C=4096;
   log a ≈ -5 and ≈ -1e-6 with h0; and B=4, S=2304) against autograd
   through the plain loop, rtol 1e-5 plus 1e-5 of the largest value, its
   backward one launch of ``rglru_scan_bwd_kernel`` and one device kernel a
   call; prints that kernel's device time, the device time of all the
   backward's work, the backward call's time and the plain backward's
   (``rglru_bwd_ref``);
13. drives the training path through ``repro_torch.launch.train.
   train_reduced`` at the published width cut to 3 layers (rglru, rglru,
   attn; 2.603 B params), f32 master weights and AdamW state, bf16
   compute, batch 2 × 2048 tokens, 6 steps: prints each step's loss, grad
   norm and lr, the median step ms after the first, tokens/s and peak
   memory, and checks a finite loss, 1 ``fused_ce`` and 4 ``rglru_scan``
   launches per step (2 of them the backward kernel);
14. a descent check: 8 ``make_train_step`` steps (warmup 1) on one fixed
   batch at that width; the last loss must be below the first;
15. resumes training from a checkpoint: the reduced recurrentgemma-9b twin
   in bf16 through ``train_reduced``, 8 steps in one run against 4 steps,
   a save, a fresh call that restores and 4 more; losses, final
   parameters, AdamW state and the batch generator's state must be bitwise
   equal. Prints the twin's checkpoint bytes and save seconds beside the
   size the training path's state would have (12 bytes a parameter; not
   written).

Any failure raises (nonzero exit, no result line). The build's ptxas
registers, shared memory and spills are printed per kernel. The last two
lines are the ``{"kernels": [...]}`` table and ``{"ok": true, "device":
{...}}``. Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import math
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
# Robust-regression path (paper §4.3): OPV width, slice sampling, from θ_MAP.
# The posterior mean at N = 1.8M lies within ~1e-3 of θ_true; 0.02 is the
# limit, far below the O(1) error of a sampler gone astray.
ROBUST_ITERS, ROBUST_BURN, ROBUST_FULL_ITERS = 200, 50, 3
ROBUST_RMSE_MAX = 0.02
# HMC path at the MNIST width, and the plain-engine yardstick.
HMC_WARMUP, HMC_SAMPLES, HMC_LEAPFROG = 60, 150, 10
PLAIN_ITERS = 100
# The sampling service: job_mix's five kinds at the paper's widths, 8 jobs,
# 8 chain slots (the mix has 11 chains), 128 samples in chunks of 32. The
# timed comparison with the sequential solo runs alternates the two sides
# (sequential, service, service, sequential) after an instrumented service
# run that warms both.
SERVICE_SLOTS, SERVICE_SAMPLES, SERVICE_CHUNK, SERVICE_WARMUP = 8, 128, 32, 100
SERVICE_REASONS = ("max_samples", "converged")
# The chaos harness on the card: a seed whose schedule, at run_schedule's
# default sizes, fires a checkpoint kill and a checkpoint corruption.
CHAOS_SEED, CHAOS_CKPT_EVERY = 4, 1
# Training resume: the reduced twin, this many steps of batch × (seq − 1)
# tokens contiguous against half, a restore in a fresh call, and the other
# half.
RESUME_STEPS, RESUME_BATCH, RESUME_SEQ = 8, 8, 129
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


def device_ms(fn, names, reps: int = 20, fallback: bool = True):
    """Device time per call of the kernels whose names contain one of
    ``names`` (torch.profiler, CUDA activity). If the trace holds none of
    them, logs the kernel names it does hold and returns the time per call
    of ``reps`` back-to-back calls between two CUDA events instead (device
    time plus any launch gaps; the log line says which), or None where
    ``fallback`` is false."""
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
    if not fallback:
        return None
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


def host_ms(fn, reps: int = 100) -> float:
    """Host time per call over ``reps`` back-to-back warm calls, on the host
    clock: what the caller waits for before its next operation."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def queued_ms(fn, reps: int = 100, spin_cycles: int = 40_000_000) -> float:
    """Device time per call with ``reps`` calls queued back to back behind a
    spin kernel (~20 ms), so the host's issue time is hidden: the kernels
    and the gaps between them, as a CUDA graph of the caller would see
    them."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_kernels(fn, reps: int = 10, tries: int = 5):
    """The device activities (kernels, copies, memsets) of each of ``reps``
    warm calls of ``fn``, from one profiler trace a call: a list of names a
    call. The profiler now and then records nothing for a call; such a call
    is traced again, up to ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    calls, empty = [], 0
    for _ in range(reps):
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type == DeviceType.CUDA]
            if names:
                break
            empty += 1
        calls.append(names)
    if empty:
        log(f"  profiler: {empty} traces of one call recorded nothing")
    return calls


def one_kernel_a_call(phase: dict, kernel: str) -> None:
    """Raises unless every traced call of the phase ran exactly one device
    kernel, the one named ``kernel``."""
    bad = [c for c in phase["device_kernels"]
           if len(c) != 1 or kernel not in c[0]]
    if bad:
        raise AssertionError(f"{phase['phase']}: {len(bad)} of "
                             f"{len(phase['device_kernels'])} calls ran "
                             f"{bad[0]}, not one {kernel}")


def sm_clocks_per_s() -> float:
    """SM-clocks a second over the card: its SMs times the maximum SM clock
    that nvidia-smi reports."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * mhz * 1e6


# Integer operations of one Threefry-2x32-20 (Salmon et al. 2011) of which
# only the first word is kept, as csrc/z_update.cu keeps it. 20 rounds of
# add, rotate, xor, of which the last rotate and xor feed only the second
# word; the key injections: the datum word's first add (the counter word's
# is the same for every datum) and, after every 4 rounds, one add into each
# word (the last into the second word is dead).
THREEFRY_ALU_OPS = 19 + 19  # rotations (funnel shifts) and xors
THREEFRY_OPS = THREEFRY_ALU_OPS + 1 + 20 + 5 + 4  # and the adds
# Hopper, per SM and clock: 64 lanes of the ALU pipe, which alone runs
# shifts and logic; 64 of the FMA pipe, which runs an add as an IMAD; 4 warp
# instructions issued, 128 lanes.
ALU_LANES, ISSUE_LANES = 64, 128


def hash_bound_ms(hashes: int, sm_clocks: float) -> float:
    """The least time the card takes for ``hashes`` Threefry hashes: the
    ALU pipe's share, or every operation at the issue rate."""
    clocks = max(THREEFRY_ALU_OPS / ALU_LANES, THREEFRY_OPS / ISSUE_LANES)
    return hashes * clocks / sm_clocks * 1e3


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
    # The profiles hold only this call's kernels; the prefix names the
    # kernels of any design of it, so a phase times an earlier tree too.
    dev_ms = device_ms(call, ("bright_glm",))
    kernels = device_kernels(call)
    per_call = sum(map(len, kernels)) / len(kernels)
    q_ms = queued_ms(call)
    h_ms = host_ms(call)
    plain = median_ms(lambda: bright_glm_ref(*args, family=family, **kw))
    kt = kc if family == "softmax" else 1
    t_bytes = data.t.element_size()
    row_in = 4 + 4 * d + t_bytes + 4 * (kc if family == "softmax" else 1)
    b_ms, b_by = bound(k * c * row_in + k * c * 4 + k * 4 + k * kt * d * 4,
                       2.0 * k * c * d * kt)
    log(f"bright_glm[{name}: N={n} D={d} K={k} C={c}] max|δ-δ_plain|={err:.3g} "
        f"call {ms:.4f} ms (host {h_ms:.4f} ms; device {dev_ms} ms, "
        f"{per_call} device kernels a call, queued {q_ms:.6f} ms), plain "
        f"{plain:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    return {"phase": name, "N": n, "D": d, "K": k, "C": c, "max_abs_err": err,
            "ms": dev_ms, "call_ms": ms, "kernels_per_call": per_call,
            "device_kernels": kernels,
            "queued_ms": q_ms, "host_ms": h_ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by}


def z_phase(name, n, k, q_db, cap, dev, gen, sm_clocks):
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
    dev_ms = device_ms(call, ("z_",))  # only this call's kernels, as above
    kernels = device_kernels(call)
    per_call = sum(map(len, kernels)) / len(kernels)
    q_ms = queued_ms(call)
    h_ms = host_ms(call)
    plain = median_ms(lambda: z_candidates_ref(arr, num, kw, q_db, cap))
    # bytes: arr, num and the key words in, cand and count out; operations:
    # one Threefry a position in [num, N)
    bytes_moved = k * n * 4 + k * cap * 4 + k * 8 * 3 + k * 4
    hashed = k * n - int(num.sum())
    by_bytes = bound(bytes_moved, 0.0)[0]
    by_ops = hash_bound_ms(hashed, sm_clocks)
    b_ms, b_by = (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                                 "operations")
    log(f"z_update[{name}: N={n} K={k} cap={cap} q={q_db}] bitwise equal "
        f"(count {count.tolist()}), call {ms:.4f} ms (host {h_ms:.4f} ms; "
        f"device {dev_ms} ms, "
        f"{per_call} device kernels a call, queued {q_ms:.6f} ms), plain "
        f"{plain:.4f} ms, bound "
        f"{b_ms:.6f} ms ({b_by}; bytes {by_bytes:.6f} ms, {hashed} hashes "
        f"{by_ops:.6f} ms)")
    return {"phase": name, "N": n, "K": k, "cap": cap, "max_abs_err": 0.0,
            "ms": dev_ms, "call_ms": ms, "kernels_per_call": per_call,
            "device_kernels": kernels,
            "queued_ms": q_ms, "host_ms": h_ms, "plain_ms": plain,
            "bound_ms": b_ms,
            "bound_by": b_by, "bound_bytes_ms": by_bytes,
            "bound_ops_ms": by_ops}


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
    sm_clocks = sm_clocks_per_s()
    log(f"Threefry bound: {THREEFRY_ALU_OPS} ALU-pipe of {THREEFRY_OPS} "
        f"integer operations a hash, {sm_clocks / 1e12:.4f} T SM-clocks/s")
    z = [
        z_phase("mnist", N_MNIST, 2, 0.01, CAPACITY, dev, gen, sm_clocks),
        z_phase("opv", N_OPV, 2, 0.01, N_OPV // 64, dev, gen, sm_clocks),
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


def _reset_launches() -> None:
    from repro_torch.kernels.bright_glm import ops as bops
    from repro_torch.kernels.z_update import ops as zops

    bops.launch_count = 0
    zops.launch_count = 0


def _launches() -> dict:
    from repro_torch.kernels.bright_glm import ops as bops
    from repro_torch.kernels.z_update import ops as zops

    return {"bright_glm": bops.launch_count, "z_update": zops.launch_count}


def _flymc_vs_regular(data, warmup, samples, key0):
    """MAP-tune, run FlyMC (warmup, then a resumed sampling run with
    streaming collectors) and the full-data baseline from the same start.
    Returns the numbers both paths print and check."""
    from repro_torch import api
    from repro_torch import random as jr
    from repro_torch.core import diagnostics
    from repro_torch.models.bayes_glm import GLMModel

    n, d = data.x.shape
    model = GLMModel.logistic(data, prior_scale=1.0, xi=1.5)
    theta_map = model.map_estimate(jr.key(key0), steps=400)
    tuned = model.map_tuned(theta_map)
    alg = api.firefly(tuned, kernel="rwmh", capacity=CAPACITY,
                      cand_capacity=CAPACITY, q_db=0.01, step_size=0.03,
                      adapt_target="auto", num_warmup=warmup)

    _reset_launches()
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
    launches = _launches()
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
        # the chain's samples, to compare runs and trees bitwise
        "digest": hashlib.sha256(theta.tobytes()).hexdigest()[:16],
    }


def _report(name, r, warmup, samples):
    log(f"{name} [logistic N={r['n']} D={r['d']}, {CHAINS} chains, {warmup} "
        f"warmup + {samples} samples]: queries/iter flymc {r['q_fly']:.1f} vs "
        f"regular {r['q_reg']:.0f}; split-R̂ flymc {r['rhat_fly']:.4f}, regular "
        f"{r['rhat_reg']:.4f}; max|Δ posterior mean| {r['dmean']:.4g} "
        f"({r['z']:.2f} MC s.e.); ms/iter flymc {r['fly_ms']:.3f}, regular "
        f"{r['reg_ms']:.3f}; capacity {r['capacity']}; launches "
        f"{r['launches']} over {r['steps']} steps; samples sha256 "
        f"{r['digest']}")
    if not r["q_fly"] < r["n"] / 10:
        raise AssertionError(f"FlyMC queries/iter {r['q_fly']} not << N")


def main_path(mnist):
    """The main path at the MNIST width; returns its kernel launch counts."""
    r = _flymc_vs_regular(mnist, WARMUP, SAMPLES, key0=2)
    _report("main path", r, WARMUP, SAMPLES)
    return r["launches"]


def _syncs(alg, position=None, steps: int = 4):
    """``steps`` steps of ``alg`` (K = 2, from ``position``, after 3 warm
    steps) under ``torch.cuda.set_sync_debug_mode("warn")``: returns the
    lines that issued an operation making the host wait for the card, with
    their counts, and the slice steps' own count of their waits over those
    steps. A step without waits can be captured as a graph."""
    import warnings
    from collections import Counter

    from repro_torch import random as jr
    from repro_torch.core import samplers

    position = alg.default_position if position is None else position
    k_init, k_steps = jr.split(jr.key(12))
    state = alg.init(jr.split(k_init, CHAINS), torch.stack([position] * CHAINS))
    keys = jr.split(k_steps, CHAINS)
    for _ in range(3):
        state, _ = alg.step(keys, state)
        keys = state.rng
    torch.cuda.synchronize()
    w0 = samplers.waits
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(steps):
                state, _ = alg.step(keys, state)
                keys = state.rng
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # The sync warning itself, not the notice that the mode is a prototype.
    sites = Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                    if "called a synchronizing CUDA operation"
                    in str(w.message))
    return dict(sites), samplers.waits - w0


def step_syncs(mnist):
    """Four FlyMC steps at the MNIST width (K = 2, RWMH): the lines that
    made the host wait for the card (none is the contract)."""
    from repro_torch import api
    from repro_torch import random as jr
    from repro_torch.models.bayes_glm import GLMModel

    model = GLMModel.logistic(mnist)
    tuned = model.map_tuned(model.map_estimate(jr.key(2), steps=200))
    alg = api.firefly(tuned, kernel="rwmh", capacity=CAPACITY,
                      cand_capacity=CAPACITY, q_db=0.01, step_size=0.03,
                      adapt_target="auto", num_warmup=50)
    sites, _ = _syncs(alg)
    log(f"FlyMC steps [MNIST width, {CHAINS} chains, 4 steps]: operations "
        f"that wait for the card: {sites or 'none'}")
    return sites


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
    from repro_torch.models.bayes_glm import GLMModel

    data = softmax_data(jr.key(5), n=N_CIFAR, d=D_CIFAR, k=K_CIFAR)
    model = GLMModel.softmax(data, n_classes=K_CIFAR)
    theta_map = model.map_estimate(jr.key(6), steps=200)
    tuned = model.map_tuned(theta_map)
    alg = api.firefly(tuned, kernel="mala", capacity=1024, cand_capacity=1024,
                      q_db=0.01, step_size=0.002, adapt_target="auto",
                      num_warmup=50)
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = api.sample(alg, jr.key(7), 100, num_chains=2, init_position=theta_map)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 100
    launches = _launches()
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


EXACT_RUNS = (  # θ-kernel, its knobs, iterations
    ("rwmh", {"step_size": 0.02}, 150),
    ("slice", {"step_size": 0.05}, 40),
    ("hmc", {"step_size": 0.005, "kernel_params": (("n_leapfrog", 5),)}, 24),
)


def exactness(mnist):
    from repro_torch import api
    from repro_torch import random as jr
    from repro_torch.models.bayes_glm import GLMModel

    model = GLMModel.logistic(mnist)
    tuned = model.map_tuned(model.map_estimate(jr.key(2), steps=200))

    for kernel, kw, iters in EXACT_RUNS:
        def run(cap, cand, key, n, **sample_kw):
            alg = api.firefly(tuned, kernel=kernel, capacity=cap,
                              cand_capacity=cand, q_db=0.01,
                              adapt_target="auto", num_warmup=50, **kw)
            return api.sample(alg, key, n, **sample_kw)

        key = jr.key(11)
        big = run(CAPACITY, CAPACITY, key, iters, num_chains=2)
        # ~120 dark→bright candidates a step overflow 8 slots: re-runs
        small = run(64, 8, key, iters, num_chains=2, chunk_size=iters // 6)
        if not small.steps_run > iters:
            raise AssertionError(f"{kernel}: capacity 64 never overflowed")
        if not torch.equal(big.theta, small.theta):
            raise AssertionError(f"{kernel}: capacity 64 run differs from "
                                 "capacity 512 run")
        for a, b in zip(big.stats, small.stats):
            if not torch.equal(a, b):
                raise AssertionError(f"{kernel}: capacity 64 stats differ "
                                     "from capacity 512")
        k_init, k_steps = jr.split(key)
        init_keys, chain_keys = jr.split(k_init, 2), jr.split(k_steps, 2)
        alg = big.algorithm
        for c in range(2):
            st = alg.init(init_keys[c:c + 1], alg.default_position[None])
            one = api.sample(alg, chain_keys[c], iters, init_state=st)
            if not torch.equal(one.theta[0], big.theta[c]):
                raise AssertionError(f"{kernel}: chain {c} alone differs from "
                                     "the batched run")
        if not np.isfinite(big.theta.cpu().numpy()).all():
            raise AssertionError(f"{kernel}: non-finite samples")
        log(f"exactness [{kernel}, {iters} iters]: capacity 64 "
            f"({small.steps_run} steps run, grown to "
            f"{small.algorithm.spec.capacity}) == capacity 512, bitwise; 2 "
            "batched chains == chains run alone, bitwise")


# ---------------------------------------------------------------------------
# 5. The robust-regression path, the HMC path, the plain engines
# ---------------------------------------------------------------------------


def robust_kernels_held(spec, data, stats, fs, key, family="student_t",
                        label="robust path"):
    """Both kernels held against their plain versions at the shapes the
    robust path (or a ``family`` service lane, ``label``) gave them, on its
    final state ``fs``: ``bright_glm`` on the
    bright buffer at the grown capacity, where the stored δ (the slice
    step's carry) and the stored log-density must also agree with a fresh
    evaluation at the stored θ; then a candidate draw at the grown
    candidate capacity, and ``bright_glm`` on those candidates. Returns
    the largest |δ − δ_plain|.

    The candidates' total (which the path discards) is held against the
    plain sum of the kernel's own δ, not against the plain total: most of
    the ~q_db·N candidates have δ near 0, where log(expm1 δ) turns two
    float32 evaluations of δ that agree to ~1e-6 into terms that differ by
    up to O(1), so the two totals differ by ~1e-3 relative while every δ
    and the summation agree. The smoke prints that difference."""
    from repro_torch import random as jr
    from repro_torch.core import brightness, flymc
    from repro_torch.core.numerics import key_words_of
    from repro_torch.kernels.bright_glm import ops as bops
    from repro_torch.kernels.bright_glm.ref import (bright_glm_ref,
                                                    total_of_delta)
    from repro_torch.kernels.z_update import ops as zops
    from repro_torch.kernels.z_update.ref import z_candidates_ref

    close = dict(rtol=1e-5, atol=1e-5)
    kw = dict(family=family, **spec.bound.fused_kernel_kwargs())
    theta = fs.sampler.theta
    idx, mask = brightness.bright_buffer(fs.bright, spec.capacity)
    args = (data.x, data.t, data.xi, idx, fs.bright.num, theta)
    delta, total = bops.bright_glm(*args, **kw)
    d_ref, t_ref = bright_glm_ref(*args, **kw)
    torch.testing.assert_close(delta, d_ref, **close)
    torch.testing.assert_close(total, t_ref, **close)
    carry = float((fs.sampler.aux - delta).abs()[mask].max()) if bool(
        mask.any()) else 0.0  # a chain may end with no bright datum
    torch.testing.assert_close(fs.sampler.aux[mask], delta[mask], **close)
    f = flymc.make_joint_logpost(spec, data, stats, idx, fs.bright.num)
    lp, _ = f(theta)
    torch.testing.assert_close(fs.sampler.lp, lp, **close)
    errs = [float((delta - d_ref).abs().max())]

    cap = spec.cand_capacity
    words = key_words_of(jr.split(key, theta.shape[0]))
    cand, n_cand = zops.z_candidates(fs.bright.arr, fs.bright.num, words,
                                     spec.q_db, cap)
    c_ref, n_ref = z_candidates_ref(fs.bright.arr, fs.bright.num, words,
                                    spec.q_db, cap)
    if not (torch.equal(cand, c_ref) and torch.equal(n_cand, n_ref)):
        raise AssertionError(f"{label}: z_update at the grown candidate "
                             "capacity differs from its plain version")
    nb = torch.clamp(n_cand, max=cap).to(torch.int64)
    args = (data.x, data.t, data.xi, cand, nb, theta)
    delta, total = bops.bright_glm(*args, **kw)
    d_ref, t_ref = bright_glm_ref(*args, **kw)
    torch.testing.assert_close(delta, d_ref, **close)
    torch.testing.assert_close(total, total_of_delta(delta, nb), **close)
    errs.append(float((delta - d_ref).abs().max()))
    rel = ((total - t_ref).abs() / t_ref.abs()).tolist()
    drawn = torch.arange(cap, device=nb.device) < nb[:, None]
    smallest = float(d_ref[drawn].min()) if bool(drawn.any()) else math.nan
    log(f"{label} kernels held on the final state: bright_glm at C="
        f"{spec.capacity} (bright {fs.bright.num.tolist()}) and at the "
        f"candidates' C={cap} ({n_cand.tolist()} drawn, z_update bitwise) "
        f"within 1e-5 of plain, max|δ-δ_plain| {max(errs):.3g}; stored δ "
        f"vs fresh max {carry:.3g}, stored lp {fs.sampler.lp.tolist()} vs "
        f"fresh {lp.tolist()}; the candidates' total {total.tolist()}, "
        f"plain {t_ref.tolist()} (relative {rel}), smallest δ "
        f"{smallest:.3g}")
    return max(errs)


def robust_path():
    """The paper's third experiment (§4.3) at the OPV width: robust
    Student-t regression (ν = 4, σ = 1, Laplace prior), MAP-tuned bounds,
    FlyMC with slice sampling, 2 chains from θ_MAP; then a few iterations
    of the full-data slice chain. Returns the FlyMC run's kernel launches
    and the largest |δ − δ_plain| of ``robust_kernels_held``."""
    from repro_torch import api
    from repro_torch import random as jr
    from repro_torch.core import brightness, flymc, samplers
    from repro_torch.data import robust_data
    from repro_torch.models.bayes_glm import GLMModel

    data, theta_true = robust_data(jr.key(30), n=N_OPV, d=D_OPV, nu=4.0)
    model = GLMModel.robust(data, nu=4.0, sigma=1.0, prior_scale=1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    theta_map = model.map_estimate(jr.key(31), steps=600, lr=0.02)
    tuned = model.map_tuned(theta_map)
    torch.cuda.synchronize()
    map_s = time.perf_counter() - t0
    alg = api.firefly(tuned, kernel="slice", capacity=2048, cand_capacity=2048,
                      q_db=0.01, step_size=0.05)

    _reset_launches()
    w0 = samplers.waits
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = api.sample(alg, jr.key(32), ROBUST_ITERS, num_chains=CHAINS,
                    init_position=theta_map)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = _launches()
    trips = samplers.waits - w0  # density evaluations, all chains at once
    want = {"bright_glm": trips + tr.steps_run + tr.inits_run,
            "z_update": tr.steps_run}
    if launches != want or min(launches.values()) == 0:
        raise AssertionError(f"robust path launches {launches}; want {want}")

    theta = tr.theta.cpu().numpy()
    if theta.shape != (CHAINS, ROBUST_ITERS, D_OPV) or not np.isfinite(
            theta).all():
        raise AssertionError(f"bad robust-path samples {theta.shape}")
    # a slice step moves its chain unless shrinkage hits its cap
    moved = (np.abs(np.diff(theta, axis=1)).max(-1) > 0).mean(1)
    if not (moved > 0.5).all():
        raise AssertionError(f"robust-path chains moved on {moved} of steps")
    truth = theta_true.cpu().numpy()
    post = theta[:, ROBUST_BURN:].reshape(-1, D_OPV).mean(0)
    rmse = float(np.sqrt(np.mean((post - truth) ** 2)))
    map_rmse = float(np.sqrt(np.mean((theta_map.cpu().numpy() - truth) ** 2)))
    st = tr.stats
    q = float(st.lik_queries[:, ROBUST_BURN:].double().mean())
    bright = float(st.n_bright[:, ROBUST_BURN:].double().mean())

    fs, spec = tr.final_state, tr.algorithm.spec
    err = robust_kernels_held(spec, tuned.data, tuned.stats, fs, jr.key(35))

    # n_evals of each chain: ten slice steps from the chain's final state
    idx, _ = brightness.bright_buffer(fs.bright, spec.capacity)
    f = flymc.make_joint_logpost(spec, tuned.data, tuned.stats, idx,
                                 fs.bright.num)
    keys = jr.split(jr.key(33), CHAINS)
    sampler, evals = fs.sampler, []
    for i in range(10):
        sampler, info = samplers.slice_step(f, jr.fold_in(keys, i), sampler,
                                            torch.exp(fs.log_step))
        evals.append(info.n_evals)
    n_evals = torch.stack(evals).double()

    sites, waited = _syncs(tr.algorithm, theta_map)
    if sum(sites.values()) != waited:
        raise AssertionError(f"slice steps waited at {sites}, but counted "
                             f"{waited} loop checks")

    base = api.regular_mcmc(model, kernel="slice", step_size=0.05)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ref = api.sample(base, jr.key(34), ROBUST_FULL_ITERS, num_chains=CHAINS,
                     init_position=theta_map)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    q_full = float(ref.stats.lik_queries.double().mean())
    log(f"robust path [Student-t N={N_OPV} D={D_OPV}, slice, {CHAINS} chains, "
        f"{ROBUST_ITERS} iters, burn {ROBUST_BURN}]: ms/iter "
        f"{(t1 - t0) * 1e3 / ROBUST_ITERS:.3f} (init and growth included); "
        f"queries/iter {q:.1f}; bright {bright:.1f}; capacity grown to "
        f"{spec.capacity} ({tr.inits_run} inits, {tr.steps_run} steps run); "
        f"density evaluations a step {trips / tr.steps_run:.3f} (all chains "
        f"at once), n_evals a chain a step {float(n_evals.mean()):.2f} "
        f"(per chain {n_evals.mean(0).tolist()}); host waits a step "
        f"{waited / 4:.2f} at {sites}; posterior-mean RMSE vs θ_true "
        f"{rmse:.5f} (θ_MAP {map_rmse:.5f}, MAP {map_s:.1f} s); steps on "
        f"which each chain moved {moved.tolist()}; launches "
        f"{launches}; full-data slice: queries/iter {q_full:.0f}, ms/iter "
        f"{(t3 - t2) * 1e3 / ROBUST_FULL_ITERS:.3f}")
    if not rmse < ROBUST_RMSE_MAX:
        raise AssertionError(f"robust posterior-mean RMSE {rmse} >= "
                             f"{ROBUST_RMSE_MAX}")
    # ~q_db·N candidates a step, plus n_evals · bright: far below the
    # full-data chain's n_evals · N
    if not q < 2 * spec.q_db * N_OPV:
        raise AssertionError(f"robust FlyMC queries/iter {q} >= 2·q_db·N")
    return launches, err


def service_mix(seed: int = 0, n_jobs: int = 8):
    """A JAX-free copy of ``benchmarks/_util.py::job_mix``'s five kinds at
    the paper's widths: job i is kind i % 5 — logistic K = 1 (MNIST),
    logistic K = 2 (MNIST), softmax (CIFAR-3), robust (OPV, ν = 4), and
    logistic K = 2 stopped on batch-means ESS (min_ess = max_samples / 3,
    checked every 2 chunks, collectors trace + R̂ + ESS; ``service_path``
    lowers the target to one the job reaches). Each job has its own dataset
    (key 1000·seed + i) and seed + i as its chain seed; ``capacity =
    cand_capacity = n // 4``; the kernel engines and RWMH, the Job's
    defaults."""
    from repro_torch import api
    from repro_torch import random as jr
    from repro_torch.data import logistic_data, robust_data, softmax_data
    from repro_torch.serve import Job, TerminationPolicy

    fixed = TerminationPolicy(max_samples=SERVICE_SAMPLES)
    conv = TerminationPolicy(
        max_samples=SERVICE_SAMPLES, min_samples=max(2, SERVICE_SAMPLES // 8),
        min_ess=max(8.0, SERVICE_SAMPLES / 3), check_every=2)
    jobs = []
    for i in range(n_jobs):
        key = jr.key(1000 * seed + i)
        kind = i % 5
        n = {2: N_CIFAR, 3: N_OPV}.get(kind, N_MNIST)
        common = dict(seed=seed + i, capacity=max(32, n // 4),
                      cand_capacity=max(32, n // 4),
                      num_warmup=SERVICE_WARMUP)
        if kind in (0, 1):
            jobs.append(Job(job_id=f"logistic{'2c' * kind}-{i}",
                            family="logistic", num_chains=1 + kind,
                            data=logistic_data(key, n=n, d=D_MNIST),
                            policy=fixed, **common))
        elif kind == 2:
            jobs.append(Job(job_id=f"softmax-{i}", family="softmax",
                            data=softmax_data(key, n=n, d=D_CIFAR,
                                              k=K_CIFAR),
                            n_classes=K_CIFAR, policy=fixed, **common))
        elif kind == 3:
            data, _ = robust_data(key, n=n, d=D_OPV)
            jobs.append(Job(job_id=f"robust-{i}", family="robust", data=data,
                            policy=fixed, **common))
        else:
            jobs.append(Job(
                job_id=f"logistic-conv-{i}", family="logistic", num_chains=2,
                data=logistic_data(key, n=n, d=D_MNIST), policy=conv,
                collectors={"trace": api.FullTrace(), "rhat": api.RHat(),
                            "ess": api.BatchMeansESS()}, **common))
    return jobs


def _ess_checks(job, stop_at=None):
    """One job alone through ``api.sample``, with the service's
    TerminationPolicy check at every boundary (the same peeks at the same
    boundaries). Returns (results, committed, the ESS totals read at the
    check boundaries). ``stop_at`` is the ESS target (None: never stop)."""
    from repro_torch import api
    from repro_torch import random as jr
    from repro_torch.serve import build_algorithm

    p = job.policy
    seen = {"chunks": 0, "committed": 0, "totals": []}

    def check(ev):
        seen["chunks"] += 1
        seen["committed"] = ev.committed
        if p.min_ess is None or ev.committed < max(p.min_samples, 1):
            return False
        if seen["chunks"] % p.check_every:
            return False
        ess = np.asarray(ev.peek("ess")["ess"], np.float64)
        total = float(np.nansum(ess)) if np.isfinite(ess).any() else 0.0
        seen["totals"].append(total)
        return stop_at is not None and total >= stop_at

    tr = api.sample(build_algorithm(job), jr.key(job.seed), p.max_samples,
                    num_chains=job.num_chains, chunk_size=SERVICE_CHUNK,
                    collectors=dict(job.collectors), on_chunk=check)
    return tr.results, seen["committed"], seen["totals"]


def _solo_service_job(job):
    """One job alone through ``api.sample``, stopped where the service's
    TerminationPolicy stops it. Returns (results, committed)."""
    results, committed, _ = _ess_checks(job, job.policy.min_ess)
    return results, committed


def _reachable_ess_target(jobs):
    """The mix with its ESS job's target lowered to the ESS total a solo
    probe run reads at the first check boundary, so that the job stops
    there, early: at the paper's widths RWMH from θ = 0 never reaches
    ``max_samples / 3`` (ESS ~31 a chain after 256 samples on an H100),
    and the early stop is what the job exists to exercise."""
    import dataclasses

    out = []
    for job in jobs:
        if job.policy.min_ess is not None:
            _, _, totals = _ess_checks(job)
            if not totals or not totals[0] > 0:
                raise AssertionError(f"ESS probe of {job.job_id} read "
                                     f"{totals} at its check boundaries")
            job = dataclasses.replace(job, policy=dataclasses.replace(
                job.policy, min_ess=totals[0]))
        out.append(job)
    return out


def _sequential(jobs):
    """The jobs one after another through ``api.sample``: ({job_id:
    (results, committed)}, wall s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = {job.job_id: _solo_service_job(job) for job in jobs}
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _serviced(jobs, hold=None):
    """The jobs through one ``Service``: (service, {job_id: JobResult},
    wall s, {job_id: s from the first submit to retirement}). The service
    is put in ``hold["svc"]`` before it runs, for instrumentation."""
    from repro_torch.serve import Service

    svc = Service(slot_budget=SERVICE_SLOTS, chunk_size=SERVICE_CHUNK)
    if hold is not None:
        hold["svc"] = svc
    done_at = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for job in jobs:
        svc.submit(job)

    def on_update(u):
        if getattr(u, "done", False):
            torch.cuda.synchronize()
            done_at[u.job_id] = time.perf_counter() - t0

    res = svc.run(on_update=on_update)
    torch.cuda.synchronize()
    return svc, res, time.perf_counter() - t0, done_at


def _check_service_run(name, svc, res, jobs, solo):
    """Raise unless the run had no fault event, every job retired on
    ``max_samples`` or ``converged``, and every JobResult is bitwise its
    solo run (results and committed count)."""
    if svc.faults:
        raise AssertionError(f"{name}: fault events {svc.faults}")
    reasons = {j.job_id: res[j.job_id].reason for j in jobs}
    if any(r not in SERVICE_REASONS for r in reasons.values()):
        raise AssertionError(f"{name}: retirement reasons {reasons}")
    bad = [j.job_id for j in jobs
           if not (_results_equal(res[j.job_id].results, solo[j.job_id][0])
                   and res[j.job_id].committed == solo[j.job_id][1])]
    if bad:
        raise AssertionError(f"{name}: results differ from solo runs: {bad}")


def _results_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_results_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_results_equal(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if a is None or b is None:
        return a is None and b is None
    return bool(np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True))


def service_path():
    """The sampling service at the paper's widths: the mix of
    :func:`service_mix` through ``repro_torch.serve.Service`` with a slot
    budget of 8 chains (below the mix's 11, so jobs queue and join between
    chunks), beside the same jobs run one after another through
    ``api.sample``.

    First an instrumented service run, the phase's main path: launches
    counted from 0, every group chunk under ``set_sync_debug_mode("warn")``,
    occupancy and re-run lane-steps recorded. Its launches are worked out
    from the engines' counted lane-steps and inits, and a group chunk
    without overflow must wait on the card once. Then, warm, the timed
    comparison without instrumentation: sequential, service, service,
    sequential. Every service run must be bitwise the solo runs, with no
    fault event (a retried chunk would hide a failed launch) and every job
    retired on ``max_samples`` or ``converged``; the ESS job must stop
    early. Both kernels are held against their plain versions on each
    group's final lane at its grown capacities. Returns the instrumented
    run's launches and the largest |δ − δ_plain|."""
    import warnings

    from repro_torch import random as jr
    from repro_torch.serve import GroupEngine
    from repro_torch.serve.faults import group_label
    from repro_torch.serve.scheduler import Scheduler

    jobs = _reachable_ess_target(service_mix())
    conv = next(j for j in jobs if j.policy.min_ess is not None)

    engines, evicted, chunks, occupancy = [], {}, [], {}
    real_engine_for, real_evict = Scheduler._engine_for, Scheduler.evict
    real_chunk = GroupEngine.run_chunk
    current = {}

    def engine_for(self, *a, **kw):
        eng = real_engine_for(self, *a, **kw)
        if all(e is not eng for e in engines):
            engines.append(eng)
        return eng

    def evict(self, job_id):
        eng, lane = real_evict(self, job_id)
        evicted[eng.group_key] = (eng._alg.spec, lane)
        return eng, lane

    def run_chunk(self, cs):
        svc = current["svc"]
        occupancy.setdefault(svc._step_count, svc.scheduler.slots_used)
        r0, s0, lanes = self.reruns, self.lane_steps, len(self._lanes)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = real_chunk(self, cs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        waits = sum("called a synchronizing CUDA operation" in str(w.message)
                    for w in caught)
        chunks.append((self.reruns - r0, waits,
                       self.lane_steps - s0 - cs * lanes))
        return out

    Scheduler._engine_for, Scheduler.evict = engine_for, evict
    GroupEngine.run_chunk = run_chunk
    try:
        _reset_launches()
        svc, res, instr_wall, _ = _serviced(jobs, hold=current)
        launches = _launches()
    finally:
        Scheduler._engine_for, Scheduler.evict = real_engine_for, real_evict
        GroupEngine.run_chunk = real_chunk

    seq_walls, svc_walls, lat = [], [], []
    solo = None
    for side in ("sequential", "service", "service", "sequential"):
        if side == "sequential":
            out, wall = _sequential(jobs)
            if solo is None:
                solo = out
            elif any(not _results_equal(out[k][0], solo[k][0])
                     or out[k][1] != solo[k][1] for k in solo):
                raise AssertionError("sequential solo runs differ between "
                                     "repetitions")
            seq_walls.append(wall)
        else:
            _reset_launches()
            t_svc, t_res, wall, done_at = _serviced(jobs)
            if _launches() != launches:
                raise AssertionError(f"timed service run launched "
                                     f"{_launches()}, the instrumented "
                                     f"{launches}")
            _check_service_run("timed service run", t_svc, t_res, jobs, solo)
            svc_walls.append(wall)
            lat.extend(done_at[j.job_id] for j in jobs)
    _check_service_run("instrumented service run", svc, res, jobs, solo)
    if not res[conv.job_id].committed < SERVICE_SAMPLES:
        raise AssertionError(f"the ESS job ran to {res[conv.job_id].committed}"
                             f" samples; its target {conv.policy.min_ess} "
                             f"should stop it early")

    lane_steps = sum(e.lane_steps for e in engines)
    inits = sum(e.inits for e in engines)
    want = {"bright_glm": 2 * lane_steps + inits, "z_update": lane_steps}
    if launches != want or min(launches.values()) == 0:
        raise AssertionError(f"service launches {launches}; want {want}")
    clean = [w for r, w, _ in chunks if r == 0]
    if not clean or any(w != 1 for w in clean):
        raise AssertionError(f"group chunks without overflow waited "
                             f"{sorted(set(clean))} times (want 1)")
    counted = sum(e.waits for e in engines)
    if counted != sum(e.chunks + e.reruns for e in engines):
        raise AssertionError(f"engines counted {counted} waits")

    errs = []
    for key, (spec, lane) in evicted.items():
        fam = {"logistic": "logistic", "softmax": "softmax",
               "robust": "student_t"}[key[0][0]]
        errs.append(robust_kernels_held(
            spec, lane["data"], lane["stats"], lane["state"], jr.key(36),
            family=fam, label=f"service lane {lane['job_id']}"))
    torch.cuda.empty_cache()

    rerun_steps = sum(x for _, _, x in chunks)
    chain_samples = sum(res[j.job_id].committed * j.num_chains for j in jobs)
    seq_s, svc_s = sum(seq_walls) / 2, sum(svc_walls) / 2
    lat = np.array(lat)
    ess = res[conv.job_id].results["ess"]["ess"]
    groups = [(group_label(e.group_key), e.reruns, e.capacity, e.cand_capacity,
               e.lane_steps, e.chunks) for e in engines]
    log(f"service path [{len(jobs)} jobs (logistic MNIST {N_MNIST}x{D_MNIST}, "
        f"softmax CIFAR-3 {N_CIFAR}x{D_CIFAR}, robust OPV {N_OPV}x{D_OPV}), "
        f"slot budget {SERVICE_SLOTS} of "
        f"{sum(j.num_chains for j in jobs)} chains, {SERVICE_SAMPLES} samples, "
        f"chunk {SERVICE_CHUNK}; {card_line()}]: timed in the order "
        f"sequential, service, service, sequential: service wall "
        f"{[round(w, 3) for w in svc_walls]} s, sequential solo api.sample "
        f"{[round(w, 3) for w in seq_walls]} s (ratio of means "
        f"{svc_s / seq_s:.3f}); committed chain-samples/s service "
        f"{chain_samples / svc_s:.1f}, sequential {chain_samples / seq_s:.1f} "
        f"({chain_samples} chain-samples; re-run share of lane-steps "
        f"{rerun_steps / lane_steps:.3f}); latency submit→retire p50 "
        f"{np.percentile(lat, 50):.3f} s, p95 {np.percentile(lat, 95):.3f} s; "
        f"instrumented run (first, cold) {instr_wall:.3f} s; mean slot "
        f"occupancy {np.mean(list(occupancy.values())) / SERVICE_SLOTS:.3f} "
        f"over {len(occupancy)} steps; ms per lane-step "
        f"{svc_s * 1e3 / lane_steps:.3f} ({lane_steps} lane-steps, "
        f"{rerun_steps} of them re-runs, {inits} inits); host waits a group "
        f"chunk {counted / len(chunks):.3f} (sync debug: "
        f"{sorted(set(w for _, w, _ in chunks))}, chunks without overflow "
        f"{len(clean)} of {len(chunks)}); groups (label, re-runs, capacity, "
        f"cand_capacity, lane-steps, chunks) {groups}; launches {launches}; "
        f"auto-terminated {conv.job_id}: committed "
        f"{res[conv.job_id].committed}, reason {res[conv.job_id].reason}, "
        f"ESS {np.asarray(ess).tolist()} (target {conv.policy.min_ess})")
    return launches, max(errs), jobs, res


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def checkpoint_path(jobs, ref):
    """The service's crash story on the card, on :func:`service_path`'s
    jobs at the paper's widths (``ref``: that phase's uninterrupted,
    solo-exact results). A service checkpoints after every step
    (``checkpoint_every=1``); the save of its third step is killed at
    ``pre_rename`` and the process restarts cold from disk
    (``Service.restore``); after one more step a bit of the newest step's
    largest leaf is flipped, and the next restart must report
    ``checkpoint_fallback`` and load an older step; that service runs to
    the end, its kernel launches counted. Every job's delivered results
    must be bitwise ``ref``. Times, on a copy of the second step's state: a
    blocking save, an async save until ``save`` returns (and until its
    write is joined), and ``Service.restore``. Then
    ``repro_torch.testing.chaos.run_schedule`` on the card for a seed whose
    schedule fires a checkpoint kill and a corruption, and both kernels
    held against their plain versions at its jobs' shapes (N = 64, D = 3),
    on each group's final lane of its fault-free reference run. Returns the
    restored run's launches and the chaos holds' largest |δ − δ_plain|."""
    import random
    import shutil
    import tempfile

    from repro_torch import random as jr
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.serve import Service
    from repro_torch.serve.scheduler import Scheduler
    from repro_torch.testing import chaos

    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="ckpt_", dir=ROOT / "build"))
    live, timed = work / "service", work / "timed"
    kw = dict(chunk_size=SERVICE_CHUNK, checkpoint_every=1)
    seen = {}
    svc = Service(slot_budget=SERVICE_SLOTS, checkpointer=Checkpointer(
        live, keep=3), **kw)
    for job in jobs:
        svc.submit(job)
    for _ in range(2):
        svc.step()
        chaos.deliver(svc, seen)
    saved = sorted(Checkpointer(live).all_steps())

    # Times and bytes of one checkpoint of this state, in another directory.
    svc.checkpointer = Checkpointer(timed, keep=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc.checkpoint(blocking=True)
    blocking_s = time.perf_counter() - t0
    ckpt_bytes = _dir_bytes(timed)
    shutil.rmtree(timed)
    svc.checkpointer = Checkpointer(timed, keep=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc.checkpoint(blocking=False)
    async_return_s = time.perf_counter() - t0
    svc.checkpointer.wait()
    async_total_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    probe = Service.restore(Checkpointer(timed))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    admitted = set(svc.scheduler.suspended).union(
        *(e.job_ids for e in svc.scheduler.engines.values()))
    if set(probe._jobs) != admitted:
        raise AssertionError(f"the timed restore holds {sorted(probe._jobs)}"
                             f", not the admitted {sorted(admitted)}")
    del probe
    shutil.rmtree(timed)
    svc.checkpointer = Checkpointer(live, keep=3)

    # A save killed at pre_rename, then a cold restart from disk.
    def kill(point):
        if point == "pre_rename":
            raise chaos.InjectedKill(point)

    svc.checkpointer._kill_hook = kill
    try:
        svc.step()
    except chaos.InjectedKill:
        killed_at = svc._step_count
    else:
        raise AssertionError("the armed save was not killed")
    del svc
    torch.cuda.empty_cache()
    svc = Service.restore(Checkpointer(live, keep=3), **kw)
    if svc.restored_from_step != saved[-1] or svc.faults:
        raise AssertionError(f"restart after the kill loaded step "
                             f"{svc.restored_from_step} ({svc.faults}); "
                             f"want {saved[-1]}")
    chaos.resubmit(svc, jobs, seen)
    svc.step()
    chaos.deliver(svc, seen)

    # A bit flip in the newest step, then a restart that must fall back.
    damaged = chaos.corrupt_checkpoint(live, "ckpt_bitflip", random.Random(7))
    del svc
    torch.cuda.empty_cache()
    svc = Service.restore(Checkpointer(live, keep=3), **kw)
    fallback = [e for e in svc.faults if e.kind == "checkpoint_fallback"]
    if (not fallback or svc.restored_from_step >= damaged
            or fallback[0].detail["skipped_steps"] != [damaged]):
        raise AssertionError(f"restart after a bit flip in step {damaged}: "
                             f"loaded {svc.restored_from_step}, events "
                             f"{svc.faults}")
    chaos.resubmit(svc, jobs, seen)
    _reset_launches()
    svc.run()
    launches = _launches()
    chaos.deliver(svc, seen)
    if min(launches.values()) == 0:
        raise AssertionError(f"the restored service launched {launches}")
    bad = [j.job_id for j in jobs
           if not (seen[j.job_id].committed == ref[j.job_id].committed
                   and _results_equal(seen[j.job_id].results,
                                      ref[j.job_id].results))]
    if bad or len(seen) != len(jobs):
        raise AssertionError(f"results after the restarts differ from the "
                             f"uninterrupted run: {bad}")
    reasons = sorted({seen[j.job_id].reason for j in jobs})
    log(f"checkpoint path [{len(jobs)} jobs of the service path at the "
        f"paper's widths, checkpoint every step; {card_line()}]: checkpoint "
        f"of step {saved[-1]} {ckpt_bytes} bytes; blocking save "
        f"{blocking_s:.3f} s ({ckpt_bytes / blocking_s / 1e9:.3f} GB/s); "
        f"async save {async_return_s:.3f} s until save returns, "
        f"{async_total_s:.3f} s until its write is joined; Service.restore "
        f"{restore_s:.3f} s; save of step {killed_at} killed at pre_rename, "
        f"restart loaded step {saved[-1]}; bit flip in step {damaged}, "
        f"restart loaded step {svc.restored_from_step} with "
        f"checkpoint_fallback {fallback[0].detail}; restored run launches "
        f"{launches}; all {len(jobs)} jobs bitwise the uninterrupted run "
        f"(reasons {reasons})")

    # The chaos run. Its fault-free reference service runs first, so the
    # first lane each group evicts is a clean final state at the chaos
    # jobs' shapes, on which both kernels are held.
    lanes, real_evict = {}, Scheduler.evict

    def evict(self, job_id):
        eng, lane = real_evict(self, job_id)
        lanes.setdefault(eng.group_key, (eng._alg.spec, lane))
        return eng, lane

    t0 = time.perf_counter()
    Scheduler.evict = evict
    try:
        report = chaos.run_schedule(CHAOS_SEED, directory=work / "chaos",
                                    checkpoint_every=CHAOS_CKPT_EVERY)
    finally:
        Scheduler.evict = real_evict
    chaos_s = time.perf_counter() - t0
    kinds = [f.kind for f in report.fired]
    if not (any(k.startswith("kill_") for k in kinds)
            and any(k in ("ckpt_bitflip", "ckpt_truncate", "ckpt_torn")
                    for k in kinds) and report.fallbacks):
        raise AssertionError(f"chaos seed {CHAOS_SEED} fired {kinds} "
                             f"({report.summary()})")
    log(f"chaos [seed {CHAOS_SEED}, checkpoint every {CHAOS_CKPT_EVERY}, on "
        f"the card]: {report.summary()} in {chaos_s:.1f} s")
    families = {"logistic": "logistic", "softmax": "softmax"}
    if sorted(k[0][0] for k in lanes) != ["logistic", "logistic", "softmax"]:
        raise AssertionError(f"chaos reference lanes of groups {list(lanes)}")
    chaos_err = max(
        robust_kernels_held(spec, lane["data"], lane["stats"], lane["state"],
                            jr.key(37, device=lane["data"].x.device),
                            family=families[key[0][0]],
                            label=f"chaos lane {lane['job_id']}")
        for key, (spec, lane) in lanes.items())
    shutil.rmtree(work)
    torch.cuda.empty_cache()
    return launches, chaos_err


def hmc_path(mnist):
    """FlyMC with HMC at the MNIST width, beside the full-data HMC chain:
    2 chains from θ_MAP, step size adapted in warmup. HMC's gradients go
    through the bright-GLM ``autograd.Function``. Returns its launches."""
    from repro_torch import api
    from repro_torch import random as jr
    from repro_torch.core import diagnostics
    from repro_torch.models.bayes_glm import GLMModel

    model = GLMModel.logistic(mnist)
    theta_map = model.map_estimate(jr.key(40), steps=400)
    tuned = model.map_tuned(theta_map)
    kw = dict(kernel="hmc", step_size=0.005, adapt_target="auto",
              num_warmup=HMC_WARMUP,
              kernel_params=(("n_leapfrog", HMC_LEAPFROG),))
    iters = HMC_WARMUP + HMC_SAMPLES
    alg = api.firefly(tuned, capacity=CAPACITY, cand_capacity=CAPACITY,
                      q_db=0.01, **kw)
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = api.sample(alg, jr.key(41), iters, num_chains=CHAINS,
                    init_position=theta_map)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = _launches()
    want = {"bright_glm": (HMC_LEAPFROG + 3) * tr.steps_run + tr.inits_run,
            "z_update": tr.steps_run}
    if launches != want:
        raise AssertionError(f"HMC path launches {launches}; want {want}")
    theta = tr.theta.cpu().numpy()
    if not np.isfinite(theta).all():
        raise AssertionError("HMC path produced non-finite samples")
    moved = float((np.abs(np.diff(theta, axis=1)).max(-1) > 0).mean())
    if not moved > 0.0:
        raise AssertionError("FlyMC HMC never accepted")
    sites, _ = _syncs(tr.algorithm, theta_map)
    if sites:
        raise AssertionError(f"the FlyMC HMC step waits for the card: {sites}")

    base = api.regular_mcmc(model, **kw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ref = api.sample(base, jr.key(42), iters, num_chains=CHAINS,
                     init_position=theta_map)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    ref_theta = ref.theta.cpu().numpy()
    log(f"HMC path [logistic N={N_MNIST} D={D_MNIST}, {HMC_LEAPFROG} leapfrog "
        f"steps, {CHAINS} chains, {HMC_WARMUP} warmup + {HMC_SAMPLES} "
        f"samples]: split-R̂ flymc "
        f"{diagnostics.split_r_hat(theta[:, HMC_WARMUP:]):.4f}, regular "
        f"{diagnostics.split_r_hat(ref_theta[:, HMC_WARMUP:]):.4f}; accept "
        f"flymc {float(tr.stats.accept_prob[:, HMC_WARMUP:].mean()):.3f} "
        f"(moved {moved:.3f}), regular "
        f"{float(ref.stats.accept_prob[:, HMC_WARMUP:].mean()):.3f}; "
        f"queries/iter flymc "
        f"{float(tr.stats.lik_queries[:, HMC_WARMUP:].double().mean()):.1f}, "
        f"regular {float(ref.stats.lik_queries.double().mean()):.0f}; ms/iter "
        f"flymc {(t1 - t0) * 1e3 / iters:.3f}, regular "
        f"{(t3 - t2) * 1e3 / iters:.3f}; bright "
        f"{float(tr.stats.n_bright.double().mean()):.1f}; host waits a step: "
        f"{sites or 'none'}; launches {launches}")
    return launches


def plain_engines(mnist):
    """The main path's configuration on the plain engines
    (``backend="jnp", z_backend="jnp"``) and in explicit mode, beside the
    kernel engines: ms/iter and queries/iter, a yardstick for the path."""
    from repro_torch import api
    from repro_torch import random as jr
    from repro_torch.models.bayes_glm import GLMModel

    model = GLMModel.logistic(mnist)
    theta_map = model.map_estimate(jr.key(2), steps=200)
    tuned = model.map_tuned(theta_map)
    runs = (("kernels", {}),
            ("plain", {"backend": "jnp", "z_backend": "jnp"}),
            ("explicit", {"backend": "jnp", "z_backend": "jnp",
                          "mode": "explicit"}))
    out = {}
    for name, kw in runs:
        alg = api.firefly(tuned, kernel="rwmh", capacity=CAPACITY,
                          cand_capacity=CAPACITY, q_db=0.01, step_size=0.03,
                          adapt_target="auto", num_warmup=50, **kw)
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr = api.sample(alg, jr.key(50), PLAIN_ITERS, num_chains=CHAINS,
                        init_position=theta_map)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / PLAIN_ITERS
        launches = _launches()
        if name != "kernels" and any(launches.values()):
            raise AssertionError(f"{name} engines launched {launches}")
        if not np.isfinite(tr.theta.cpu().numpy()).all():
            raise AssertionError(f"{name} engines produced bad samples")
        out[name] = ms
        log(f"engines [{name}, logistic N={N_MNIST} D={D_MNIST}, RWMH, "
            f"{CHAINS} chains, {PLAIN_ITERS} iters]: ms/iter {ms:.3f}, "
            f"queries/iter {float(tr.stats.lik_queries.double().mean()):.1f}, "
            f"bright {float(tr.stats.n_bright.double().mean()):.1f}, "
            f"launches {launches}")
    return out


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
    if not torch.equal(hf, y[:, -1]):
        raise AssertionError(f"rglru_scan[{name}]: h_final is not y[:, -1]")
    call = lambda: ops.rglru_scan(la, bx, h0)
    ms = median_ms(call)
    dev_ms = device_ms(call, ("rglru_scan_kernel",))
    queued = queued_ms(call)
    plain = median_ms(lambda: rglru_ref(la, bx, h0), reps=5, warm=1)
    b_ms, b_by = bound(3 * b * s * c * 4 + b * c * 4 * (2 if with_h0 else 1),
                       3.0 * b * s * c)
    log(f"rglru_scan[{name}: B={b} S={s} C={c} log_a≈{log_a:g} h0={with_h0}] "
        f"max|Δ|={err:.3g}, call {ms:.4f} ms (device {dev_ms:.6f} ms, queued "
        f"{queued:.6f} ms), plain {plain:.4f} ms, bound {b_ms:.6f} ms "
        f"({b_by})")
    return {"phase": name, "B": b, "S": s, "C": c, "log_a": log_a,
            "max_abs_err": err, "ms": dev_ms, "queued_ms": queued,
            "call_ms": ms, "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by, "device_kernels": device_kernels(call)}


def lm_kernel_phases(dev):
    """``decode_attention`` at the shapes the serving path gives it, read off
    the published config: MQA heads of the local attention over a full
    window (the RG-LRU scan: :func:`rglru_kernel_phases`)."""
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
    torch.cuda.empty_cache()
    return attn


def rglru_kernel_phases(dev):
    """The RG-LRU scan's forward and backward kernels at the RG-LRU width
    of the published config: forwards at the serving prompt (the model's
    decays; the slowest with h0) and at the training shape; backwards at
    the training shape (both decays) and at the serving prompt's; then
    both at the shape :func:`train_resume_path` gives them (the reduced
    twin's RG-LRU width, RESUME_BATCH × (RESUME_SEQ − 1)). Runs on
    another tree's ``src`` too, to compare trees in one call (SKILL.md).
    Returns (forward phases, backward phases)."""
    from repro_torch.configs import get_config, get_reduced

    r = get_config(ARCH).rnn_dim
    gen = torch.Generator().manual_seed(12)
    s_train = TRAIN_SEQ - 1
    scan = [
        rglru_phase("path", SERVE_BATCH, SERVE_PROMPT, r, -5.0, False, dev,
                    gen),
        rglru_phase("slow-decay", SERVE_BATCH, SERVE_PROMPT, r, -1e-6, True,
                    dev, gen),
        rglru_phase("train", TRAIN_BATCH, s_train, r, -5.0, False, dev, gen),
    ]
    cgen = torch.Generator().manual_seed(15)
    scan_bwd = [
        rglru_grad_phase("backward", TRAIN_BATCH, s_train, r, -5.0, False,
                         dev, cgen),
        rglru_grad_phase("backward-slow-decay", TRAIN_BATCH, s_train, r,
                         -1e-6, True, dev, cgen),
        rglru_grad_phase("backward-prefill-shape", SERVE_BATCH, SERVE_PROMPT,
                         r, -5.0, False, dev, cgen),
    ]
    r_twin, s_twin = get_reduced(ARCH).rnn_dim, RESUME_SEQ - 1
    tgen = torch.Generator().manual_seed(17)
    scan.append(rglru_phase("twin", RESUME_BATCH, s_twin, r_twin, -5.0,
                            False, dev, tgen))
    scan_bwd.append(rglru_grad_phase("twin-backward", RESUME_BATCH, s_twin,
                                     r_twin, -5.0, False, dev, tgen))
    torch.cuda.empty_cache()
    return scan, scan_bwd


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


def fused_ce_grad_phase(t, d, v, dev, gen, name="backward-f32"):
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
    return {"phase": name, "T": t, "D": d, "V": v,
            "max_rel_err": max(errs), "bwd_ms": bwd_ms,
            "bwd_bf16_ms": bwd_bf16_ms}


def rglru_grad_phase(name, b, s, c, log_a, with_h0, dev, gen):
    """``RGLRUScan``'s backward (one launch of ``rglru_scan_bwd_kernel``)
    against autograd through the plain loop: ∂log_a, ∂b (and ∂h0) to rtol
    1e-5 plus 1e-5 of the largest value. ``bwd_ms`` is the backward
    kernel's device time a call (profiler; None on a tree whose trace holds
    no such kernel), ``bwd_device_ms`` the device
    time of every kernel the backward runs (cotangents handed straight to
    it: on a tree whose backward is the forward kernel run reversed, its
    scan and tensor ops), ``bwd_call_ms`` the gradient of the loss Σ ḡ·h +
    Σ ḡ_final·h_final, its own products included (CUDA events)."""
    from repro_torch.kernels.rglru_scan import ops
    from repro_torch.kernels.rglru_scan import ref as plain
    from repro_torch.kernels.rglru_scan.ref import rglru_ref

    fused = hasattr(ops, "rglru_scan_backward")  # absent on older trees

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
    call_ms = median_ms(bwd, reps=10, warm=2)
    ins2 = [a.detach().clone().requires_grad_() for a in ins]  # the scan alone
    y, hf = ops.rglru_scan(ins2[0], ins2[1], ins2[2] if with_h0 else None)
    only = lambda: torch.autograd.grad((y, hf), ins2, (gh, gl),
                                       retain_graph=True)
    kernel_ms = device_ms(only, ("rglru_scan_bwd_kernel",), fallback=False)
    all_ms = device_ms(only, ("",))
    phase = {}
    if fused:
        h = y.detach()
        direct = lambda: ops.rglru_scan_backward(la, h, h0, gh, gl)
        phase["bwd_plain_ms"] = median_ms(
            lambda: plain.rglru_bwd_ref(la, h, h0, gh, gl), reps=5, warm=1)
        phase["device_kernels"] = device_kernels(direct)
    # bytes: log_a, the saved h and ḡ read, ∂log_a and ∂b written
    b_ms, b_by = bound(5 * b * s * c * 4 + b * c * 4 * (3 if with_h0 else 2),
                       6.0 * b * s * c)
    kernel = ("no rglru_scan_bwd_kernel ran" if kernel_ms is None
              else f"backward kernel {kernel_ms:.6f} ms")
    log(f"rglru_scan backward[{name}: B={b} S={s} C={c} log_a≈{log_a:g} "
        f"h0={with_h0}] max|Δ|={err:.3g}, {kernel}, "
        f"all the backward's device work {all_ms:.6f} ms, backward call "
        f"{call_ms:.4f} ms, plain {phase.get('bwd_plain_ms', float('nan')):.4f}"
        f" ms, bound {b_ms:.6f} ms ({b_by})")
    del out, ins, ins2, y, hf
    torch.cuda.empty_cache()
    return {"phase": name, "B": b, "S": s, "C": c, "log_a": log_a,
            "max_abs_err": err, "bwd_ms": kernel_ms, "bwd_device_ms": all_ms,
            "bwd_call_ms": call_ms, "bound_ms": b_ms, "bound_by": b_by,
            **phase}


def train_kernel_phases(dev):
    """fused_ce at the training path's shape (T = 4096 tokens of the
    published width and vocab; bf16 in the path's rounding mode and in the
    float32-products mode, f32, and a ragged T) and FusedCE's backward;
    then both at the shape :func:`train_resume_path` gives them (the
    reduced twin's width and vocab, RESUME_BATCH × (RESUME_SEQ − 1) tokens,
    bf16 logits). RGLRUScan's: :func:`rglru_kernel_phases`. Returns
    (forward phases, backward phases)."""
    from repro_torch.configs import get_config, get_reduced

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
    ce_grads = [fused_ce_grad_phase(CE_TOKENS, d, v, dev, gen)]
    twin = get_reduced(ARCH)
    t = RESUME_BATCH * (RESUME_SEQ - 1)
    d, v = twin.d_model, twin.padded_vocab()
    tgen = torch.Generator(device=dev).manual_seed(16)
    ce.append(fused_ce_phase("twin", t, d, v, torch.bfloat16, dev, tgen,
                             round_logits=True))
    ce_grads.append(fused_ce_grad_phase(t, d, v, dev, tgen,
                                        name="twin-backward"))
    return ce, ce_grads


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
    cops.launch_count = rops.launch_count = rops.bwd_launch_count = 0
    aops.launch_count = wops.launch_count = 0
    model, hist = train_reduced(ARCH, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                                seq=TRAIN_SEQ, log_every=TRAIN_STEPS, seed=0,
                                full=True, n_layers=TRAIN_LAYERS,
                                dtype=torch.bfloat16, device=dev)
    launches = {"fused_ce": cops.launch_count, "rglru_scan": rops.launch_count,
                "rglru_scan_bwd": rops.bwd_launch_count,
                "decode_attention": aops.launch_count,
                "rwkv6_scan": wops.launch_count}
    peak = torch.cuda.max_memory_allocated(dev)
    n_rglru = layer_kinds(model.cfg).count("rglru")
    want = {"fused_ce": TRAIN_STEPS, "rglru_scan": 2 * n_rglru * TRAIN_STEPS,
            "rglru_scan_bwd": n_rglru * TRAIN_STEPS,
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
        f"{launches['rglru_scan'] / TRAIN_STEPS:g} (of which backward "
        f"{launches['rglru_scan_bwd'] / TRAIN_STEPS:g})")
    return launches, model, {"step_ms": step_ms,
                             "tokens_per_s": tokens / step_ms * 1e3,
                             "peak_gib": peak / 2**30}


def train_resume_path(dev, n_full: int):
    """Training-state checkpoints on the card: the reduced recurrentgemma-9b
    twin in bf16 through ``train_reduced``, RESUME_STEPS steps in one run
    against RESUME_STEPS / 2 steps, a save, a fresh call that restores and
    RESUME_STEPS / 2 more. Losses, final parameters, AdamW state and the
    batch generator's state must be bitwise equal (the two runs' final
    checkpoints byte for byte the same). Prints the twin's checkpoint bytes
    and a blocking save's seconds beside the size that the training path's
    state (``n_full`` parameters) would have: f32 parameters and AdamW m
    and v, 12 bytes a parameter, computed and not written. Its kernels are
    held at its shapes in :func:`train_kernel_phases` and
    :func:`rglru_kernel_phases`. Returns the resumed half's launches."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.kernels.fused_ce import ops as cops
    from repro_torch.kernels.rglru_scan import ops as rops
    from repro_torch.launch.train import _train_state, train_reduced
    from repro_torch.models import transformer as T

    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="train_ckpt_", dir=ROOT / "build"))
    half = RESUME_STEPS // 2
    kw = dict(batch=RESUME_BATCH, seq=RESUME_SEQ, log_every=RESUME_STEPS,
              warmup_steps=2, dtype=torch.bfloat16, device=dev,
              ckpt_every=half)
    whole, split = work / "whole", work / "split"
    m1, h1 = train_reduced(ARCH, steps=RESUME_STEPS, ckpt_dir=whole, **kw)
    _, ha = train_reduced(ARCH, steps=half, ckpt_dir=split, **kw)
    cops.launch_count = rops.launch_count = rops.bwd_launch_count = 0
    m2, hb = train_reduced(ARCH, steps=RESUME_STEPS, ckpt_dir=split, **kw)
    launches = {"fused_ce": cops.launch_count,
                "rglru_scan": rops.launch_count,
                "rglru_scan_bwd": rops.bwd_launch_count}
    losses = [h["loss"] for h in h1]
    if losses != [h["loss"] for h in ha + hb] or [h["step"] for h in hb] != \
            list(range(half, RESUME_STEPS)):
        raise AssertionError(f"resumed losses {[h['loss'] for h in ha + hb]}"
                             f" != contiguous {losses}")
    bad = [n for (n, p), (_, q) in zip(m1.named_parameters(),
                                       m2.named_parameters())
           if not torch.equal(p, q)]
    man = Checkpointer(whole).manifest(RESUME_STEPS)
    bad += [m["path"] for m in man["leaves"]
            if (whole / f"step_{RESUME_STEPS:08d}" / m["file"]).read_bytes()
            != (split / f"step_{RESUME_STEPS:08d}" / m["file"]).read_bytes()]
    if bad:
        raise AssertionError(f"resumed training state differs: {bad[:8]}")
    if min(launches.values()) == 0:
        raise AssertionError(f"the resumed run launched {launches}")

    gen = torch.Generator(device=dev)
    state = _train_state(m2, T.init_opt(m2), gen)
    ck = Checkpointer(work / "timed")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save(1, state, blocking=True)
    save_s = time.perf_counter() - t0
    twin_bytes = _dir_bytes(work / "timed")
    n_twin = sum(p.numel() for p in m2.parameters())
    shutil.rmtree(work)
    log(f"train resume [{ARCH} reduced twin, {n_twin} params, bf16 compute, "
        f"f32 master + AdamW; {RESUME_STEPS} steps contiguous vs "
        f"{half} + restore + {half}; {card_line()}]: losses, parameters, "
        f"AdamW state and generator state bitwise equal; losses "
        f"{[round(x, 4) for x in losses]}; resumed half's launches "
        f"{launches}; the twin's checkpoint {twin_bytes} bytes, blocking save "
        f"{save_s:.3f} s; full width, {TRAIN_LAYERS} layers: {n_full} params "
        f"x 12 B (f32 weights, m, v) = {n_full * 12 / 1e9:.1f} GB, not "
        f"written")
    return launches


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
    attn = lm_kernel_phases(dev)
    scan, scan_bwd = rglru_kernel_phases(dev)
    wkv = rwkv_kernel_phases(dev)
    ce, ce_grads = train_kernel_phases(dev)
    launches = main_path(mnist)
    waits = step_syncs(mnist)
    if waits:
        raise AssertionError(f"the FlyMC step waits for the card: {waits}")
    convergence_path()
    gradient_path()
    exactness(mnist)
    hmc_launches = hmc_path(mnist)
    plain_engines(mnist)
    del mnist
    torch.cuda.empty_cache()
    robust_launches, robust_err = robust_path()
    torch.cuda.empty_cache()
    service_launches, service_err, service_jobs, service_res = service_path()
    torch.cuda.empty_cache()
    restored_launches, chaos_err = checkpoint_path(service_jobs, service_res)
    del service_jobs, service_res
    torch.cuda.empty_cache()

    serve_exactness(dev)
    serve_launches = serve_path(dev)
    rwkv_serve_exactness(dev)
    rwkv_launches = rwkv_serve_path(dev)
    torch.cuda.empty_cache()

    train_launches, model, _ = train_path(dev)
    step_breakdown(model, dev)
    descent_check(model, dev)
    n_train = sum(p.numel() for p in model.parameters())
    del model
    torch.cuda.empty_cache()
    resumed_launches = train_resume_path(dev, n_train)
    torch.cuda.empty_cache()

    for p in bright + z + scan + scan_bwd:
        one_kernel_a_call(p, "bright_glm_kernel" if p in bright
                          else "z_candidates_kernel" if p in z
                          else "rglru_scan_kernel" if p in scan
                          else "rglru_scan_bwd_kernel")
        del p["device_kernels"]  # checked; too long for the kernels line
    main_b = next(p for p in bright if p["phase"] == "logistic")
    main_z = next(p for p in z if p["phase"] == "mnist")
    table = {"kernels": [
        {"name": "bright_glm", "route": "cuda",
         "source": "src/repro_torch/csrc/bright_glm.cu",
         "replaces": "src/repro/kernels/bright_glm/kernel.py:173",
         "launches": launches["bright_glm"],
         "launches_robust": robust_launches["bright_glm"],
         "launches_hmc": hmc_launches["bright_glm"],
         "launches_service": service_launches["bright_glm"],
         "launches_restored": restored_launches["bright_glm"],
         "max_abs_err": max([p["max_abs_err"] for p in bright]
                            + [robust_err, service_err, chaos_err]),
         "max_abs_err_robust": robust_err,
         "max_abs_err_service": service_err,
         "max_abs_err_chaos": chaos_err,
         "ms": main_b["ms"], "call_ms": main_b["call_ms"],
         "plain_ms": main_b["plain_ms"],
         "bound_ms": main_b["bound_ms"], "bound_by": main_b["bound_by"],
         "library_ms": None, "phases": bright},
        {"name": "z_update", "route": "cuda",
         "source": "src/repro_torch/csrc/z_update.cu",
         "replaces": "src/repro/kernels/z_update/kernel.py:129",
         "launches": launches["z_update"],
         "launches_robust": robust_launches["z_update"],
         "launches_hmc": hmc_launches["z_update"],
         "launches_service": service_launches["z_update"],
         "launches_restored": restored_launches["z_update"], "max_abs_err": 0.0,
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
         "launches_bwd_train": train_launches["rglru_scan_bwd"],
         "launches_resumed": resumed_launches["rglru_scan"],
         "launches_bwd_resumed": resumed_launches["rglru_scan_bwd"],
         "max_abs_err": max(p["max_abs_err"] for p in scan + scan_bwd),
         "ms": scan[0]["ms"], "call_ms": scan[0]["call_ms"],
         "plain_ms": scan[0]["plain_ms"], "bound_ms": scan[0]["bound_ms"],
         "bound_by": scan[0]["bound_by"], "library_ms": None,
         "bwd_ms": scan_bwd[0]["bwd_ms"],
         "bwd_call_ms": scan_bwd[0]["bwd_call_ms"],
         "bwd_bound_ms": scan_bwd[0]["bound_ms"],
         "bwd_plain_ms": scan_bwd[0]["bwd_plain_ms"],
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
         "launches_resumed": resumed_launches["fused_ce"],
         "max_abs_err": max(p["max_abs_err"] for p in ce),
         "ms": ce[0]["ms"], "call_ms": ce[0]["call_ms"],
         "plain_ms": ce[0]["plain_ms"], "bound_ms": ce[0]["bound_ms"],
         "bound_by": ce[0]["bound_by"], "library_ms": ce[0]["library_ms"],
         "phases": ce + ce_grads},
    ]}
    log(card)  # as nvidia-smi prints it: name, power limit
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
