#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``, at
first use), then runs its paths — the FlyMC chain (RWMH, MALA, HMC and the
paper's robust-regression slice path), the recurrentgemma-9b, rwkv6-7b,
dense decoder (llama3.2-3b, qwen2-7b, stablelm-1.6b, qwen1.5-110b), MoE
(mixtral-8x7b, arctic-480b), encoder-decoder (whisper-tiny) and VLM
(llava-next-mistral-7b) LM serving paths, FlyMC over llama3.2-3b's LM
head, and the
recurrentgemma-9b, SP-mode, rwkv6-7b and sharded training steps, and the
sharded serving of the dense decoders and of the MoE, encoder-decoder and
VLM families — each
with its kernels (six sources;
``rglru_scan.cu`` holds a forward and a backward kernel, ``bright_glm.cu``
a register and a wide softmax kernel):

1. holds each kernel against its plain PyTorch version on the card and
   times it: ``ms`` is the kernels' device time per call (torch.profiler;
   where the trace holds no record of the kernel, back-to-back calls between
   CUDA events), ``call_ms`` and ``plain_ms`` the median of warm calls
   between CUDA events, host overhead included.
   FlyMC, at the paper's widths: ``bright_glm`` for the logistic (MNIST 7v9,
   N=12,214, D=51), softmax (CIFAR-3, N=18,000, D=256, 3 classes) and
   Student-t (OPV, N=1.8M, D=57) families, δ and totals to rtol/atol 1e-5;
   ``z_update`` bitwise at N=12,214 and N=1.8M; both with a lane axis, 8
   lanes (datasets) × 2 chains at the MNIST width in one launch, held
   against the plain version and, bitwise, against one launch a lane (the
   service's ``"vmap"`` lanes); each one device kernel a call (profiler); ``host`` is the host time a call over 100 back-to-back
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
   both sides; then sequential and service, timed.
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
6a. runs the service's ``"vmap"`` lanes (``vmap_service_path``): the mix
   of 5. under ``lane_backend="vmap"``, every result bitwise the ``"map"``
   run's; then a group of 8 logistic MNIST jobs with 2 chains each (seeds
   0–7): solo, an instrumented ``"vmap"`` run (each kernel launched once a
   group step, for all 8 lanes), then map and vmap timed warm, each
   bitwise the solo runs; prints wall seconds, ms a lane-step and committed
   chain-samples/s of both backends, and holds both kernels, lane-stacked,
   on the group's final lanes;
6b. runs data-sharded FlyMC on the one card (``dist_path``): 4 ranks
   (processes, gloo over CUDA tensors) run the reference example's problem
   (``examples/distributed_flymc.py``: logistic, N = 32,768, D = 11, RWMH,
   capacity 256 a shard, q_db 0.01, 300 iterations (the example runs
   1,500); 64 chains from θ_MAP
   at step 0.03), with the
   streamed moments, R̂ and query budget held to the offline trace, the
   all-reduces a step counted (≤ 4 SUM, ≤ 1 MAX, none in the z-phase),
   host waits a step, launches and both kernels held on each shard's final
   state; the posterior held to a single-device chain of the same length
   (mean within 0.35 of the largest sd, sd within 50%); the robust problem
   at the OPV width on 4 ranks (slice, from θ_MAP, 100 iterations: RMSE of
   the posterior mean against θ_true below 0.02, ms/iter, queries/iter);
   ``chain_fleet`` with 4 ranks × 2 chains at the MNIST width, bitwise the
   single-process 8-chain run; and a 1-rank NCCL group running the sharded
   step for 50 iterations;
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
   written);
16. holds ``bright_glm``'s wide softmax kernel (past 16 classes: an LM
   head) against its plain version at the lastlayer run's shape (Kc =
   128,256, D = 3,072, C = 256, one chain) and the reduced twin's (Kc =
   512, D = 128): δ to 1e-4 plus 1e-5 of |δ|, the total to the plain sum
   of the kernel's own δ, one ``bright_glm_wide_kernel`` a call, with its
   bound from bytes and f32 FLOPs; drives the dense decoders through
   ``serve`` (``dense_serve_path``: llama3.2-3b, qwen2-7b and
   stablelm-1.6b at full width and depth, qwen1.5-110b at full width cut
   to 2 layers; bf16, batch 4, a 128-token prompt, 8 greedy tokens; prefill
   ms and decode ms/token; one ``decode_attention`` launch a layer a
   decode step; the kernel held at each config's (G, D, W)); the
   serving contract of 7. for mixtral-8x7b (2 layers, one 7-token prompt,
   so that no MoE pair drops: a decode step and the forward see other
   token counts, so other capacities), whisper-tiny (1,504 frames, 64
   tokens) and llava-next-mistral-7b (576 patches, 640 tokens) at full
   width in float32; then the MoE, encoder-decoder and VLM families
   through ``serve``
   (``family_serve_path``: mixtral-8x7b at full width cut to 20 of 32
   layers with a 6,144-token prompt past its 4,096 window, arctic-480b
   cut to 2 of 35 layers with 128 tokens, whisper-tiny whole over its
   1,504 encoder frames with 64 tokens, llava-next-mistral-7b whole with
   576 patch positions and 64 text tokens; bf16, batch 4, 8 greedy
   tokens; prefill ms, decode ms/token beside the step's byte bound
   (every expert read), peak memory, the prefill's MoE ``drop_frac``;
   ``decode_attention`` launched once a layer a decode step, twice for
   whisper; the kernel held at each new (G, D, W, window), whisper's
   cross-attention over the encoder (t = 10^9) and mixtral's wrapped
   window among them); and FlyMC
   over llama3.2-3b's head (``lastlayer_path``: f32 features of 8 × 128
   tokens from the full-depth backbone, 100 MAP steps, the reference
   example's MALA FlyMC for 20 iterations with ``backend="pallas",
   z_backend="fused"``; ms/iter, queries/iter, mean bright tokens against
   N, three wide launches a step, both kernels held on the final state);
17. trains the SP-mode families through ``train_reduced`` at their
   published widths (``train_sp_path``): llama3.2-3b whole (28 layers,
   remat), mixtral-8x7b cut to 2 of 32 layers (all 8 experts, the
   ``lb_loss`` term), qwen1.5-110b cut to 1 of 80 layers (bf16 AdamW
   moments, the QKV bias), whisper-tiny whole (remat; 1,504 frames) and
   llava-next-mistral-7b cut to 12 of 32 layers (remat; 576 patch rows);
   f32 master weights, bf16 compute, batch 2 × 2048 tokens, 4 steps each:
   one ``fused_ce`` launch a step and no ``decode_attention``,
   ``rglru_scan`` or ``rwkv6_scan`` launch, finite losses and gradient
   norms, qwen1.5-110b's moments stored in bf16; prints step ms (median
   after the first), tokens/s, peak memory beside the training state's
   bytes, losses, gradient norms, mixtral's ``lb_loss`` and
   ``drop_frac``, and llama3.2-3b's step split by CUDA events. Before it,
   with the kernel phases, ``fused_ce`` and ``FusedCE``'s backward (chunks
   of B·c = 512 rows, the SP loss's) are held against their plain versions
   at each new head: T = 4,096 and (D, V) = (3,072, 128,256),
   (4,096, 32,000), (8,192, 152,064) and (384, 51,968);
18. trains rwkv6-7b through ``train_reduced`` (``train_rwkv_path``) at its
   published width cut to 12 of 32 layers (3.158 B params, 50.52 GB of
   f32 weights, gradients and AdamW moments), remat, bf16 compute, batch
   2 × 2048 tokens, 4 steps: finite losses and gradient norms, one
   ``fused_ce`` launch a step, 96 backward launches a step (12 layers × 4
   time chunks × the two kernels, ``rwkv6_scan_bwd_ds_kernel`` and
   ``rwkv6_scan_bwd_chunk_kernel``, 48 each) and 128 forward launches
   (each layer's 4 time chunks run 32/12 times: 12 groups in 4 outer
   checkpoints of 3, see :func:`train_rwkv_path`), no
   ``decode_attention`` or ``rglru_scan`` launch; prints step ms,
   tokens/s, peak memory beside the state, and the step split by CUDA
   events. Before it, with the kernel phases, the WKV
   backward (``rwkv_bwd_phases``: the forward that saves each chunk's
   state bitwise the serving kernel, then ``RWKV6Scan``'s backward, two
   launches and those two device kernels a call, the dS pass then the
   chunk pass, against ``rwkv6_bwd_ref`` and autograd through the plain
   chunked WKV at B=2, H=64, S=512, D=64 with a random state0 and both
   cotangents, the edge decay log w ≡ -1, S=32 and S=1; every gradient
   within 1e-4 relative plus 1e-4 of its largest value; each kernel
   against its own plain piece (``rwkv6_bwd_ds_ref``, and
   ``rwkv6_bwd_chunks_ref`` fed the kernel's dS); two calls bitwise equal;
   each kernel's device ms and their sum, all the backward's device work,
   the call's and the plain backward's ms beside the bound);
19. runs the sharded train step (``sharded_train_path``,
   ``launch.steps.make_sharded_train_step``) of llama3.2-3b at its
   published width cut to 2 of 28 layers, bf16, remat, 2 × 2048 tokens:
   one NCCL rank on mesh (1, 1) bitwise the single-device step; 4 gloo
   ranks over CUDA tensors on (data=2, model=2), their loss and gradient
   norm against the single device's, one ``fused_ce`` launch a step a
   rank (on its vocabulary shard); the state saved after step 1 (logical
   arrays) and restored onto (2, 2), (1, 2) and one device, every leaf
   the same and the resumed steps bitwise; compressed pod gradients on
   (pod=2, data=1, model=2) at 2 layers within 5% of exact; then
   ``fused_ce`` at the vocabulary shard (T = 4,096, D = 3,072, V/2 =
   64,128) against its plain version, the two shards merged against the
   whole head. Prints step ms, peak memory a rank, the collectives a step
   by kind with their bytes, and the save and restore seconds;
20. runs the sharded prefill and decode (``sharded_serve_path``,
   ``launch.steps.make_sharded_prefill`` and ``make_sharded_decode``) of
   llama3.2-3b at its published width, float32 compute, bf16 rings: the
   training layout at 4 of 28 layers (4 prompts of 2,048 tokens into
   2,064 slots, then 8 greedy steps) on one NCCL rank on mesh (1, 1),
   bitwise the single device, and on 4 gloo ranks on (data=2, model=2)
   within 1% of its largest values; the serving-resident layout at all 28
   layers on the same ranks from an empty cache, 4 forced and 2 greedy
   steps, against the single device; one ``decode_attention`` launch a
   layer a step on every rank (the kernel at a rank's ring block and at
   the tp ring against its plain version and ``sdpa``, and the blocks'
   merge against the whole ring on the card, run with the kernel phases:
   ``sharded_attention_phases``). Prints prefill ms, decode ms/token, the
   collectives of a step, peak memory a rank;
21. runs the sharded MoE, encoder-decoder and VLM families
   (``sharded_family_path``, ``FAMILY_SHARDED``) at full width:
   mixtral-8x7b cut to 1 of 32 layers, whisper-tiny whole (1,504 frames,
   752 a model rank), llava-next-mistral-7b cut to 2 of 32 (576 patch
   rows). Training (bf16, remat, 2 × 2048 tokens, 2 steps) on one device,
   mixtral's also on one NCCL rank on (1, 1), bitwise; then one spawn of
   4 gloo ranks on (data=2, model=2) runs each family's training (step 1
   against the single device's objective, each data rank's rows through
   the loss on their own: loss, nll, ``lb_loss`` and ``drop_frac`` of
   every rank, and grad_norm), its fsdp prefill and greedy steps and its
   tp steps from an empty cache (whisper's cross K/V the single device's
   prefill's) against the single device (float32 compute, bf16 rings;
   mixtral served at capacity factor E/k, where no pair drops); one
   ``fused_ce`` launch a train step a rank, ``decode_attention`` once a
   layer a decode step a rank (twice for whisper: its block of the cross
   K/V, merged over ``model``). With the kernel phases
   (``family_shard_kernel_phases``): ``decode_attention`` on a rank's
   block of mixtral's window ring and of whisper's cross K/V, the cross
   blocks' merge against the whole cross cache, and ``fused_ce`` on half
   of mixtral's and whisper's heads. Prints step and token ms, peak memory
   a rank, the collectives a step, launches, the gaps and the tokens
   compared;
22. runs the TP-mode archs' sharded paths (``sharded_tp_path``,
   ``TP_SHARDED``) at full width: recurrentgemma-9b cut to 3 of 38 layers
   and rwkv6-7b to 2 of 32. Training (bf16, remat, 2 × 2048 tokens, 2
   steps) and serving (float32 compute, bf16 rings, batch 4: the fsdp
   prefill of a 2,048-token prompt and 4 greedy steps, then 4 steps of
   the tp layout from the same prefill's cache) on one device and on one
   NCCL rank on (1, 1), bitwise; then one spawn of 4 gloo ranks on
   (data=2, model=2) runs both archs' training (step 1's loss and
   grad_norm against the single device's; rwkv6's grad_norm on a float32
   step, ``TP_F32_GRAD``) and serving against the single device, every
   decided token equal. The scans run at r/mp channels and H/mp heads,
   ``fused_ce`` on V/mp columns, ``decode_attention`` on 8 query heads a
   rank against the whole MQA ring; each at those shapes against its
   plain version with the kernel phases (``tp_shard_kernel_phases``).
   Prints step and token ms, peak memory a rank, the collectives a step,
   launches and the gaps.

Any failure raises (nonzero exit, no result line). The build's ptxas
registers, shared memory and spills are printed per kernel. The last two
lines are the ``{"kernels": [...]}`` table and ``{"ok": true, "device":
{...}}``. Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import shutil
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
# (400 + 1,200 iterations: 1,000 + 2,500, then 600 + 2,000, did not leave
# the smoke room for the sharded train, then serving, paths within its time
# limit on a slow host; 600 + 2,000 read split-R̂ 1.038 and 1.008, 450 +
# 1,500 1.046 and 1.024)
D_CONV, WARMUP_CONV, SAMPLES_CONV = 3, 400, 1200
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
# HMC path at the MNIST width, and the plain-engine yardstick (20 + 50
# iterations: 30 + 75 until the sharded serving path joined the smoke).
HMC_WARMUP, HMC_SAMPLES, HMC_LEAPFROG = 20, 50, 10
PLAIN_ITERS = 100
# The sampling service: job_mix's five kinds at the paper's widths, 8 jobs,
# 8 chain slots (the mix has 11 chains), 128 samples in chunks of 32. The
# timed comparison with the sequential solo runs is one pair (sequential,
# then service) after an instrumented service run that warms both: the
# alternated two pairs did not fit the smoke's time limit on a slow host.
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
# The service's "vmap" lanes: the lane-stacked kernel phases (8 lanes × 2
# chains at the MNIST width) and a group of 8 logistic MNIST jobs, K = 2,
# seeds 0–7, run solo, under "map" and under "vmap" (timed map, then vmap,
# after an instrumented run), 64 samples in chunks of 32.
LANES, LANE_CHAINS, LANE_SAMPLES = 8, 2, 64
# Data-sharded FlyMC on the one card: 4 gloo ranks over CUDA tensors. The
# reference example's problem (examples/distributed_flymc.py: logistic,
# N = 32,768, D = 11, RWMH, capacity 256 a shard, q_db 0.01; the example's
# 1,500 iterations cut to 200 to fit the smoke's time limit on a slow host
# (750 until the sharded train step joined the smoke, 300 until the sharded
# serving path did),
# a quarter of them warmup; 64 chains, the example's one chain
# 64 times over, started at θ_MAP: RWMH in these 11 dimensions reads
# split-R̂ ~1.3 after 1,500 steps (8 chains, CPU), so the posterior held
# against the single-device run's is read from 64 chains on each side; one
# step of 64 chains costs what one of 8 does), a 1-rank NCCL group on it
# for 50
# iterations, the robust problem at the OPV width on 4 ranks (slice, from
# θ_MAP, 100 iterations, burn 25), and a chain fleet of 4 ranks × 2 chains
# at the MNIST width.
DIST_RANKS, DIST_N, DIST_D, DIST_ITERS, DIST_CAP = 4, 32_768, 11, 200, 256
DIST_Q, DIST_CHAINS, NCCL_ITERS = 0.01, 64, 50
# The example's RWMH starts at step 0.1, which its warmup's Robbins–Monro
# adaptation takes more than its 375 steps to shrink at this N: 8 chains
# then read split-R̂ 3.3 on an H100. 0.03, the main path's, is near
# 2.38/√D of the posterior's sd (~0.05).
DIST_STEP = 0.03
DIST_OPV_ITERS, DIST_OPV_BURN, DIST_OPV_CAP = 100, 25, 16_384
FLEET_CHAINS, FLEET_ITERS = 2, 64
# FlyMC over an LM head (models/lastlayer.py): llama3.2-3b at its published
# width and depth, seed-initialised, f32 features of N = 8 × 128 = 1,024
# tokens (the reference example takes 32 × 129 of its reduced twin); MAP by
# 100 Adam steps (the example: 300); then the example's MALA FlyMC (q_db,
# capacity, prior), one chain, 20 iterations. The example's start (θ_MAP,
# where every δ is 0, so no datum is bright) and step (1e-3, near MALA's
# optimum for the twin's 65,536 head parameters) leave a chain at this
# head's 394M parameters with no bright datum and no accepted proposal.
# So the chain starts at θ_MAP + ε0·noise with ε0 chosen for a mean bound
# gap δ of LL_GAP a token (away from the tangency the Böhning gap is
# ¼·Kc·|x|²·ε² over nearly uniform logits), and steps at LL_STEP_OF_EPS·ε0,
# which adds ~1/16 of that gap a step. The wide bright_glm phases: that
# head's shape (Kc = 128,256 classes, D = 3,072, C = the run's bright
# capacity n/4) and the reduced twin's (Kc = 512, D = 128).
LL_ARCH, LL_BATCH, LL_SEQ, LL_PRIOR = "llama3.2-3b", 8, 129, 0.003
LL_MAP_STEPS, LL_ITERS, LL_Q = 100, 20, 0.05
LL_GAP, LL_STEP_OF_EPS = 0.05, 0.25
# The wide kernel's δ against the plain version (the classes summed in
# another order): |Δδ| ≤ atol + rtol·|δ|; the lastlayer chain's δ (~LL_GAP)
# relative to their size.
WIDE_CLOSE = dict(rtol=1e-5, atol=1e-4)
LL_CLOSE = dict(rtol=1e-3, atol=1e-5)
# The dense decoders through launch/serve.py, bf16: batch 4, a 128-token
# prompt, 8 greedy tokens; qwen1.5-110b at full width cut to 2 of its 80
# layers (80 need 222 GB in bf16; whole, it waits for tensor parallelism).
DENSE_ARCHS = (("llama3.2-3b", None), ("qwen2-7b", None),
               ("stablelm-1.6b", None), ("qwen1.5-110b", 2))
DENSE_BATCH, DENSE_PROMPT, DENSE_GEN = 4, 128, 8
# The MoE, encoder-decoder and VLM families through launch/serve.py, bf16,
# batch 4, 8 greedy tokens: (arch, layers or None for all, prompt).
# mixtral-8x7b at full width cut to 20 of its 32 layers (58.1 GB of its
# 93.4 GB), a 6,144-token prompt past its 4,096 window (the ring wraps;
# the prefill's MoE sees 2 sequence chunks of 3,072); arctic-480b at full
# width cut to 2 of its 35 layers (27.2 GB a layer); whisper-tiny whole
# over its 1,504 encoder frames; llava-next-mistral-7b whole, its prompt
# 576 patch positions and 64 text tokens. Whole, mixtral and arctic wait
# for tensor parallelism.
FAMILY_ARCHS = (("mixtral-8x7b", 20, 6144), ("arctic-480b", 2, 128),
                ("whisper-tiny", None, 64),
                ("llava-next-mistral-7b", None, 640))
FAMILY_BATCH, FAMILY_GEN = 4, 8
# Their decode-vs-forward checks in float32 (arch, layers, batch, prompt):
# mixtral at 2 layers (11.6 GB) with one 7-token prompt, so that its
# forward's 8 tokens fit every expert's capacity of 8 (no pair drops in
# the forward, the prefill or the decode step); whisper and llava whole.
FAMILY_EXACT = (("mixtral-8x7b", 2, 1, 7), ("whisper-tiny", None, 2, 64),
                ("llava-next-mistral-7b", None, 2, 640))
# SP-mode training through launch/train.py at published widths, bf16
# compute, f32 master weights, batch 2 × 2048 tokens, 4 steps:
# (arch, layers or None for all, remat). llama3.2-3b whole (57.7 GB of
# training state: it fits only with remat), mixtral-8x7b cut to 2 of 32
# layers (50.6 GB), qwen1.5-110b to 1 of 80 (46.2 GB with its bf16
# moments), whisper-tiny whole, llava-next-mistral-7b to 12 of 32 (46.1 GB).
# arctic-480b (163 GB of state a layer) waits for expert parallelism.
SP_TRAIN = (("llama3.2-3b", None, True), ("mixtral-8x7b", 2, False),
            ("qwen1.5-110b", 1, False), ("whisper-tiny", None, True),
            ("llava-next-mistral-7b", 12, True))
SP_STEPS, SP_BATCH, SP_SEQ = 4, 2, 2049
# rwkv6-7b training at its published width cut to 12 of 32 layers (3.158 B
# params, 50.52 GB of f32 weights, gradients and AdamW moments; 32 layers
# need 120 GB), remat, bf16 compute, batch 2 × 2048 tokens, 4 steps.
RWKV_TRAIN_LAYERS, RWKV_TRAIN_STEPS = 12, 4
# The sharded train step (sharded_train_path): llama3.2-3b at full width
# cut to 2 of 28 layers (0.990 B params, 15.8 GB of f32 weights, gradients
# and moments summed over the ranks), remat, bf16 compute, 2 × 2048 tokens,
# seed 0; warmup 1 so that the steps move the weights. Mesh (1, 1) on one
# NCCL rank; (data=2, model=2) on 4 gloo ranks sharing the card, 2 steps,
# the state saved after step 1; (pod=2, data=1, model=2) at 2 layers, 3
# steps with and without the compressed pod gradients (peak lr 1e-3 and
# warmup 200, the reference test's schedule). (8 layers and 4 steps until
# the sharded serving path joined the smoke; 3 steps, saved after 2,
# until the TP-mode archs' path did.)
SHARDED_ARCH, SHARDED_LAYERS, SHARDED_SEED = "llama3.2-3b", 2, 0
SHARDED_BATCH, SHARDED_SEQ, SHARDED_STEPS, SHARDED_SAVE_AT = 2, 2048, 2, 1
SHARDED_KW = dict(warmup_steps=1)
COMPRESS_LAYERS, COMPRESS_STEPS = 2, 3
COMPRESS_KW = dict(peak_lr=1e-3)  # tests/test_distributed_training.py's
SHARDED_TIMEOUT_S = 900
# The sharded prefill and decode (sharded_serve_path): llama3.2-3b at full
# width, seed 0. The training layout ("fsdp") at 4
# of 28 layers: 4 prompts of 2,048 tokens into a 2,064-slot ring (1,032
# slots a rank on model = 2), then 8 greedy tokens; one NCCL rank on
# (1, 1), then 4 gloo ranks on (data=2, model=2). The serving-resident
# layout ("tp", bf16 weights) at all 28 layers on (2, 2) from an empty
# cache: 4 teacher-forced steps, then 2 greedy ones. Rings in bf16;
# compute in float32 (SERVE_DTYPE), so that the 4-rank runs can be held to
# the single device's at SERVE_TOL of the largest reference value: in bf16
# the ranks' sums in another order drift by ~1 ulp a layer (1.2% of the
# largest logit at 2 layers in a CPU run), as far as a wrong merge would.
# (fsdp at 8 layers, tp 16 + 8 steps until the sharded families' path
# joined the smoke; tp 8 + 4 until the TP-mode archs' path did.)
SERVE_FSDP_LAYERS, SERVE_BATCH = 4, 4
SERVE_PROMPT, SERVE_SEQ, SERVE_GEN = 2048, 2064, 8
SERVE_TP_FORCED, SERVE_TP_GREEDY = 4, 2
SERVE_DTYPE, SERVE_TOL = torch.float32, 1e-2
# The new LM heads of fused_ce on the SP path (d_model, padded vocab come
# from these configs; llava's is mixtral's): T = SP_BATCH × (SP_SEQ − 1).
SP_HEADS = ("llama3.2-3b", "mixtral-8x7b", "qwen1.5-110b", "whisper-tiny")
# The sharded MoE, encoder-decoder and VLM families (sharded_family_path),
# full published widths, seed 0, on one spawn of 4 gloo ranks (data=2,
# model=2): (arch, layers or None for all, serving prompt, ring, greedy
# tokens). mixtral-8x7b cut to 1 of 32 layers (1.41 B expert parameters;
# 27.5 GB of training state over the ranks), its ring its 4,096-slot
# window (2,048 slots a model rank); whisper-tiny whole (1,504 frames, 752 a
# model rank), a 64-token prompt; llava-next-mistral-7b cut to 2 of 32
# layers, 576 patch rows in a 2,048-token prompt. Training as
# sharded_train_path (bf16 compute, f32 master weights, remat, warmup 1):
# SP_BATCH × FAMILY_TRAIN_SEQ tokens, FAMILY_TRAIN_STEPS steps; mixtral at
# its own capacity factor, on one NCCL rank bitwise the single device.
# Serving as sharded_serve_path (float32 compute, bf16 rings, batch
# SERVE_BATCH): fsdp prefill and greedy steps, tp FAMILY_TP_FORCED forced
# then FAMILY_TP_GREEDY greedy steps from an empty cache (whisper's
# ck/cv from the single device's prefill); mixtral served at capacity
# factor FAMILY_NO_DROP_CF = E/k, so that no pair drops and the ranks'
# calls (B/dp rows each) compute what the single device's does.
FAMILY_SHARDED = (("mixtral-8x7b", 1, 2048, 4160, 4),
                  ("whisper-tiny", None, 64, 80, 8),
                  ("llava-next-mistral-7b", 2, 2048, 2064, 4))
FAMILY_TRAIN_SEQ, FAMILY_TRAIN_STEPS = 2048, 2
FAMILY_TP_FORCED, FAMILY_TP_GREEDY = 2, 2
FAMILY_NO_DROP_CF = 4.0
# A (2, 2) run's step 1 against the single device's objective of the same
# weights (each data rank's rows through loss_fn on their own, the MoE
# calls seeing those rows' tokens as the ranks' do): loss, nll and lb_loss
# relative (bf16 compute, the dense path's bound), drop_frac absolute (a
# few of 4,096 pairs: a routing decision within bf16 rounding of a tie may
# go the other way), grad_norm relative.
FAMILY_LOSS_TOL, FAMILY_DROP_TOL, FAMILY_GNORM_TOL = 2e-3, 2e-3, 1e-2
# The TP-mode archs' sharded paths (sharded_tp_path): (arch, layers) at
# the published widths, seed 0: recurrentgemma-9b cut to 3 of 38 layers
# (one rglru, rglru, attn group; 2.61 B parameters, 2.10 B of them in the
# 256,000-row table and head: 41.8 GB of f32 weights, gradients and
# moments, 10.4 GB a rank on (2, 2)) and rwkv6-7b cut to 2 of 32 (0.97 B).
# One spawn of 4 gloo ranks on (data=2, model=2), and one NCCL rank on
# (1, 1) bitwise the single device. Training as sharded_train_path (bf16
# compute, f32 master weights, remat, warmup 1): SHARDED_BATCH ×
# TP_TRAIN_SEQ tokens, TP_TRAIN_STEPS steps, step 1 against the single
# device's within TP_LOSS_TOL (loss) and TP_GNORM_TOL (grad_norm),
# relative. Serving (SERVE_DTYPE compute, bf16 rings, batch SERVE_BATCH):
# the fsdp prefill of a TP_PROMPT-token prompt into a TP_SEQ ring (the
# local-attention window: 2,048 slots, wrapped by the greedy steps), the
# first token from the hidden's last row, TP_GEN greedy steps; then the tp
# layout (bf16 weights, the data axes excluded) TP_GEN greedy steps from
# the same prefill's cache: a TP-mode arch's rank holds the same cache in
# both layouts (its MQA head, its RG-LRU channels, its WKV heads).
TP_SHARDED = (("recurrentgemma-9b", 3), ("rwkv6-7b", 2))
TP_TRAIN_SEQ, TP_TRAIN_STEPS = 2048, 2
TP_PROMPT, TP_SEQ, TP_GEN = 2048, 2064, 4
TP_LOSS_TOL, TP_GNORM_TOL = 2e-3, 1e-2
# rwkv6-7b's bf16 gradient is not a reference at its init: u = 0 leaves
# the first token's WKV output exactly 0, where the group norm's rsqrt(0 +
# 1e-6) multiplies its cotangent by 1e3, and a bf16 rounding anywhere
# upstream moves the gradient by percents (the reduced twin on the CPU:
# grad_norm 1,844.63 in f32, 1,739.74 in bf16 on one device, 2,078.48 in
# bf16 on (2, 2); at full width on an H100 80GB HBM3, 700 W: 56% between
# one device and the 4 ranks). Its grad_norm is held to one device's on a
# float32 step from the same seed instead (loss and grad_norm within
# TP_LOSS_TOL and TP_GNORM_TOL); the bf16 steps' gap is printed.
TP_F32_GRAD = ("rwkv6-7b",)


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


def launch_ms(fn, names, reps: int = 20) -> dict:
    """Device time a launch of the kernels whose names contain each of
    ``names`` (torch.profiler, CUDA activity): their traced time over the
    launches the trace holds, so a trace that lost some records still gives
    the mean of those it kept; None for a name the trace does not hold."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = dict.fromkeys(names, 0.0)
    count = dict.fromkeys(names, 0)
    for ev in prof.key_averages():
        for n in names:
            if n in ev.key:
                us[n] += getattr(ev, "self_device_time_total",
                                 getattr(ev, "self_cuda_time_total", 0.0))
                count[n] += ev.count
    return {n: us[n] / count[n] / 1e3 if count[n] else None for n in names}


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


def device_kernels(fn, reps: int = 10, tries: int = 5, expect: int = 1):
    """The device activities (kernels, copies, memsets) of each of ``reps``
    warm calls of ``fn``, from one profiler trace a call: a list of names a
    call. The profiler now and then records nothing for a call, or fewer
    than the ``expect`` kernels its wrapper launched; such a call is traced
    again, up to ``tries`` times."""
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
            if len(names) >= expect:
                break
            empty += 1
        calls.append(names)
    if empty:
        log(f"  profiler: {empty} traces of one call recorded fewer than "
            f"{expect} kernels")
    return calls


def one_kernel_a_call(phase: dict, kernel: str | tuple) -> None:
    """Raises unless every traced call of the phase ran exactly one device
    kernel, the one named ``kernel``, or, given a tuple of names, exactly
    those kernels in that order."""
    names = (kernel,) if isinstance(kernel, str) else kernel
    bad = [c for c in phase["device_kernels"]
           if len(c) != len(names) or any(n not in k for n, k in zip(names, c))]
    if bad:
        raise AssertionError(f"{phase['phase']}: {len(bad)} of "
                             f"{len(phase['device_kernels'])} calls ran "
                             f"{bad[0]}, not {' then '.join(names)}")


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


def bright_lane_phase(lanes, dev, gen):
    """``bright_glm`` with a lane axis: ``LANES`` logistic datasets at the
    MNIST width, ``LANE_CHAINS`` chains each, C = CAPACITY, one launch. Held
    against the plain version (δ and totals, rtol/atol 1e-5) and, bitwise,
    against one launch a lane."""
    from repro_torch.core.bounds import GLMData
    from repro_torch.kernels.bright_glm import ops
    from repro_torch.kernels.bright_glm.ref import bright_glm_ref

    n_l, k, c = len(lanes), LANE_CHAINS, CAPACITY
    data = GLMData(*(torch.stack(a) for a in zip(*lanes)))
    n, d = data.x.shape[1:]
    xi = (5.0 + torch.rand(n_l, n, generator=gen)).to(dev)
    theta = (0.5 * torch.randn(n_l, k, d, generator=gen) / d**0.5).to(dev)
    arr = torch.stack([torch.stack([torch.randperm(n, generator=gen)
                                    for _ in range(k)]) for _ in range(n_l)])
    idx = arr.to(torch.int32).to(dev)[:, :, :c]  # strided, as the step's
    idx[:, :, -8:] = n
    nb = torch.randint(0, c + 1, (n_l, k), generator=gen).to(dev)
    args = (data.x, data.t, xi, idx, nb, theta)
    delta, total = ops.bright_glm(*args)
    d_ref, t_ref = bright_glm_ref(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(delta, d_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(total, t_ref, rtol=1e-5, atol=1e-5)
    for i in range(n_l):
        d1, t1 = ops.bright_glm(*(a[i] for a in args))
        if not (torch.equal(d1, delta[i]) and torch.equal(t1, total[i])):
            raise AssertionError(f"bright_glm lane {i} differs from its own "
                                 "launch")
    err = float((delta - d_ref).abs().max())
    call = lambda: ops.bright_glm(*args)
    ms = median_ms(call)
    dev_ms = device_ms(call, ("bright_glm",))
    kernels = device_kernels(call)
    per_call = sum(map(len, kernels)) / len(kernels)
    q_ms = queued_ms(call)
    h_ms = host_ms(call)
    plain = median_ms(lambda: bright_glm_ref(*args))
    row_in = 4 + 4 * d + 4 + 4
    lk = n_l * k
    b_ms, b_by = bound(lk * c * row_in + lk * c * 4 + lk * 4 + lk * d * 4,
                       2.0 * lk * c * d)
    log(f"bright_glm[lanes: L={n_l} x K={k}, N={n} D={d} C={c}] one launch, "
        f"bitwise {n_l} single-lane launches; max|δ-δ_plain|={err:.3g} call "
        f"{ms:.4f} ms (host {h_ms:.4f} ms; device {dev_ms} ms, {per_call} "
        f"device kernels a call, queued {q_ms:.6f} ms), plain {plain:.4f} "
        f"ms, bound {b_ms:.6f} ms ({b_by})")
    return {"phase": "logistic-lanes", "L": n_l, "N": n, "D": d, "K": k,
            "C": c, "max_abs_err": err, "ms": dev_ms, "call_ms": ms,
            "kernels_per_call": per_call, "device_kernels": kernels,
            "queued_ms": q_ms, "host_ms": h_ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by}


def z_lane_phase(n_l, dev, gen, sm_clocks):
    """``z_update`` with a lane axis: ``n_l`` lanes of ``LANE_CHAINS``
    chains at the MNIST N, one launch, bitwise the plain version and one
    launch a lane."""
    from repro_torch.kernels.z_update import ops
    from repro_torch.kernels.z_update.ref import z_candidates_ref

    n, k, cap, q_db = N_MNIST, LANE_CHAINS, CAPACITY, 0.01
    arr = torch.stack([torch.stack([torch.randperm(n, generator=gen)
                                    for _ in range(k)]) for _ in range(n_l)])
    arr = arr.to(torch.int32).to(dev)
    num = torch.randint(0, n // 25, (n_l, k), generator=gen).to(dev)
    kw = torch.randint(0, 2**32, (n_l, k, 2), generator=gen).to(dev)
    cand, count = ops.z_candidates(arr, num, kw, q_db, cap)
    c_ref, n_ref = z_candidates_ref(arr, num, kw, q_db, cap)
    torch.cuda.synchronize()
    if not (torch.equal(cand, c_ref) and torch.equal(count, n_ref)):
        raise AssertionError("z_update[lanes] differs from its plain version")
    for i in range(n_l):
        c1, n1 = ops.z_candidates(arr[i], num[i], kw[i], q_db, cap)
        if not (torch.equal(c1, cand[i]) and torch.equal(n1, count[i])):
            raise AssertionError(f"z_update lane {i} differs from its own "
                                 "launch")
    call = lambda: ops.z_candidates(arr, num, kw, q_db, cap)
    ms = median_ms(call)
    dev_ms = device_ms(call, ("z_",))
    kernels = device_kernels(call)
    per_call = sum(map(len, kernels)) / len(kernels)
    q_ms = queued_ms(call)
    h_ms = host_ms(call)
    plain = median_ms(lambda: z_candidates_ref(arr, num, kw, q_db, cap))
    lk = n_l * k
    bytes_moved = lk * n * 4 + lk * cap * 4 + lk * 8 * 3 + lk * 4
    hashed = lk * n - int(num.sum())
    by_bytes = bound(bytes_moved, 0.0)[0]
    by_ops = hash_bound_ms(hashed, sm_clocks)
    b_ms, b_by = ((by_bytes, "bytes") if by_bytes >= by_ops
                  else (by_ops, "operations"))
    log(f"z_update[lanes: L={n_l} x K={k}, N={n} cap={cap} q={q_db}] one "
        f"launch, bitwise the plain version and {n_l} single-lane launches, "
        f"call {ms:.4f} ms (host {h_ms:.4f} ms; device {dev_ms} ms, "
        f"{per_call} device kernels a call, queued {q_ms:.6f} ms), plain "
        f"{plain:.4f} ms, bound {b_ms:.6f} ms ({b_by}; bytes {by_bytes:.6f} "
        f"ms, {hashed} hashes {by_ops:.6f} ms)")
    return {"phase": "mnist-lanes", "L": n_l, "N": n, "K": k, "cap": cap,
            "max_abs_err": 0.0, "ms": dev_ms, "call_ms": ms,
            "kernels_per_call": per_call, "device_kernels": kernels,
            "queued_ms": q_ms, "host_ms": h_ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "bound_bytes_ms": by_bytes,
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
        bright_lane_phase([logistic_data(jr.key(100 + i), n=N_MNIST,
                                         d=D_MNIST) for i in range(LANES)],
                          dev, gen),
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
        z_lane_phase(LANES, dev, gen, sm_clocks),
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


EXACT_RUNS = (  # θ-kernel, its knobs, iterations (RWMH's 150 until the
    # sharded serving path joined the smoke)
    ("rwmh", {"step_size": 0.02}, 100),
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
                        label="robust path", own_total=False, close=None):
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
    and the summation agree. The smoke prints that difference. With
    ``own_total`` the bright buffer's total is held the same way: at a
    MAP-tuned bound the bright data themselves sit at δ ≈ 0 (the sharded
    example's final states). ``close``: δ's tolerance (default 1e-5)."""
    from repro_torch import random as jr
    from repro_torch.core import brightness, flymc
    from repro_torch.core.numerics import key_words_of
    from repro_torch.kernels.bright_glm import ops as bops
    from repro_torch.kernels.bright_glm.ref import (bright_glm_ref,
                                                    total_of_delta)
    from repro_torch.kernels.z_update import ops as zops
    from repro_torch.kernels.z_update.ref import z_candidates_ref

    tight = dict(rtol=1e-5, atol=1e-5)
    close = close or tight
    kw = dict(family=family, **spec.bound.fused_kernel_kwargs())
    theta = fs.sampler.theta
    idx, mask = brightness.bright_buffer(fs.bright, spec.capacity)
    args = (data.x, data.t, data.xi, idx, fs.bright.num, theta)
    delta, total = bops.bright_glm(*args, **kw)
    d_ref, t_ref = bright_glm_ref(*args, **kw)
    torch.testing.assert_close(delta, d_ref, **close)
    torch.testing.assert_close(
        total, total_of_delta(delta, fs.bright.num) if own_total else t_ref,
        **tight)
    gap_bright = float((total - t_ref).abs().max())
    carry = float((fs.sampler.aux - delta).abs()[mask].max()) if bool(
        mask.any()) else 0.0  # a chain may end with no bright datum
    torch.testing.assert_close(fs.sampler.aux[mask], delta[mask], **tight)
    f = flymc.make_joint_logpost(spec, data, stats, idx, fs.bright.num)
    lp, _ = f(theta)
    torch.testing.assert_close(fs.sampler.lp, lp, **tight)
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
    torch.testing.assert_close(total, total_of_delta(delta, nb), **tight)
    errs.append(float((delta - d_ref).abs().max()))
    rel = ((total - t_ref).abs() / t_ref.abs()).tolist()
    drawn = torch.arange(cap, device=nb.device) < nb[:, None]
    smallest = float(d_ref[drawn].min()) if bool(drawn.any()) else math.nan
    log(f"{label} kernels held on the final state: bright_glm at C="
        f"{spec.capacity} (bright {fs.bright.num.tolist()}; its total "
        f"{'held to the plain sum of its own δ, ' if own_total else ''}"
        f"{gap_bright:.3g} from plain) and at the "
        f"candidates' C={cap} ({n_cand.tolist()} drawn, z_update bitwise) "
        f"within {close} of plain, max|δ-δ_plain| {max(errs):.3g}; stored δ "
        f"vs fresh max {carry:.3g}, stored lp {fs.sampler.lp.tolist()} vs "
        f"fresh {lp.tolist()}; the candidates' total {total.tolist()}, "
        f"plain {t_ref.tolist()} (relative {rel}), smallest δ "
        f"{smallest:.3g}")
    return max(errs)


def robust_path():
    """The paper's third experiment (§4.3) at the OPV width: robust
    Student-t regression (ν = 4, σ = 1, Laplace prior), MAP-tuned bounds,
    FlyMC with slice sampling, 2 chains from θ_MAP; then a few iterations
    of the full-data slice chain. Returns the FlyMC run's kernel launches,
    the largest |δ − δ_plain| of ``robust_kernels_held`` and θ_MAP (on the
    host, for ``dist_path``'s sharded run of the same problem)."""
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
    return launches, err, theta_map.cpu()


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


def _serviced(jobs, hold=None, lane_backend="map", slots=SERVICE_SLOTS):
    """The jobs through one ``Service``: (service, {job_id: JobResult},
    wall s, {job_id: s from the first submit to retirement}). The service
    is put in ``hold["svc"]`` before it runs, for instrumentation."""
    from repro_torch.serve import Service

    svc = Service(slot_budget=slots, chunk_size=SERVICE_CHUNK,
                  lane_backend=lane_backend)
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
    comparison without instrumentation: sequential, then service. Every service run must be bitwise the solo runs, with no
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
    for side in ("sequential", "service"):
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
    seq_s, svc_s = (sum(seq_walls) / len(seq_walls),
                    sum(svc_walls) / len(svc_walls))
    lat = np.array(lat)
    ess = res[conv.job_id].results["ess"]["ess"]
    groups = [(group_label(e.group_key), e.reruns, e.capacity, e.cand_capacity,
               e.lane_steps, e.chunks) for e in engines]
    log(f"service path [{len(jobs)} jobs (logistic MNIST {N_MNIST}x{D_MNIST}, "
        f"softmax CIFAR-3 {N_CIFAR}x{D_CIFAR}, robust OPV {N_OPV}x{D_OPV}), "
        f"slot budget {SERVICE_SLOTS} of "
        f"{sum(j.num_chains for j in jobs)} chains, {SERVICE_SAMPLES} samples, "
        f"chunk {SERVICE_CHUNK}; {card_line()}]: timed in the order "
        f"sequential, service: service wall "
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


# ---------------------------------------------------------------------------
# 6b. The service's "vmap" lanes
# ---------------------------------------------------------------------------


def lanes_kernels_held(spec, lanes, key, label):
    """Both kernels held against their plain versions on a group's final
    lanes, stacked as the "vmap" step stacks them: ``bright_glm`` on every
    lane's bright buffer in one lane-stacked launch (δ and totals within
    1e-5 of plain; the stored δ within 1e-5 of the launch's) and
    ``z_update`` on every lane's partition in one launch (bitwise plain).
    Returns the largest |δ − δ_plain|."""
    from repro_torch import random as jr
    from repro_torch.core import brightness
    from repro_torch.core.bounds import GLMData
    from repro_torch.core.numerics import key_words_of
    from repro_torch.kernels.bright_glm import ops as bops
    from repro_torch.kernels.bright_glm.ref import bright_glm_ref
    from repro_torch.kernels.z_update import ops as zops
    from repro_torch.kernels.z_update.ref import z_candidates_ref

    n_l = len(lanes)
    data = GLMData(*(torch.stack(a) for a in zip(*(l["data"] for l in lanes))))
    states = [l["state"] for l in lanes]
    k = states[0].sampler.theta.shape[0]
    bufs = [brightness.bright_buffer(st.bright, spec.capacity)
            for st in states]
    idx = torch.stack([b[0] for b in bufs])
    nb = torch.stack([st.bright.num for st in states])
    theta = torch.stack([st.sampler.theta for st in states])
    args = (data.x, data.t, data.xi, idx, nb, theta)
    kw = dict(family="logistic", **spec.bound.fused_kernel_kwargs())
    delta, total = bops.bright_glm(*args, **kw)
    d_ref, t_ref = bright_glm_ref(*args, **kw)
    close = dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(delta, d_ref, **close)
    torch.testing.assert_close(total, t_ref, **close)
    mask = torch.stack([b[1] for b in bufs])
    aux = torch.stack([st.sampler.aux for st in states])
    torch.testing.assert_close(aux[mask], delta[mask], **close)
    words = key_words_of(jr.split(key, n_l * k)).reshape(n_l, k, 2)
    arr = torch.stack([st.bright.arr for st in states])
    cand, count = zops.z_candidates(arr, nb, words, spec.q_db,
                                    spec.cand_capacity)
    c_ref, n_ref = z_candidates_ref(arr, nb, words, spec.q_db,
                                    spec.cand_capacity)
    if not (torch.equal(cand, c_ref) and torch.equal(count, n_ref)):
        raise AssertionError(f"{label}: lane-stacked z_update differs from "
                             "its plain version")
    err = float((delta - d_ref).abs().max())
    log(f"{label} kernels held on the final lanes: one lane-stacked "
        f"bright_glm (L={n_l}, K={k}, C={spec.capacity}, bright "
        f"{nb.tolist()}) within 1e-5 of plain, max|δ-δ_plain| {err:.3g}; "
        f"one lane-stacked z_update (cap {spec.cand_capacity}, "
        f"{count.tolist()} drawn) bitwise")
    return err


def vmap_group():
    """8 logistic jobs at the MNIST width, K = 2, seeds 0–7, each its own
    dataset: one group key, so one engine of 8 lanes."""
    from repro_torch import random as jr
    from repro_torch.data import logistic_data
    from repro_torch.serve import Job, TerminationPolicy

    n = N_MNIST
    return [Job(job_id=f"mnist2c-{i}", family="logistic",
                num_chains=LANE_CHAINS, seed=i,
                data=logistic_data(jr.key(2000 + i), n=n, d=D_MNIST),
                capacity=n // 4, cand_capacity=n // 4,
                num_warmup=SERVICE_WARMUP,
                policy=TerminationPolicy(max_samples=LANE_SAMPLES))
            for i in range(LANES)]


def _instrumented(jobs, lane_backend, slots):
    """One service run with its engines and evicted lanes recorded and its
    launches counted from 0: (service, results, engines, {group key: (spec,
    [evicted lanes])}, launches)."""
    from repro_torch.serve.scheduler import Scheduler

    engines, evicted = [], {}
    real_engine_for, real_evict = Scheduler._engine_for, Scheduler.evict

    def engine_for(self, *a, **kw):
        eng = real_engine_for(self, *a, **kw)
        if all(e is not eng for e in engines):
            engines.append(eng)
        return eng

    def evict(self, job_id):
        eng, lane = real_evict(self, job_id)
        evicted.setdefault(eng.group_key, (eng._alg.spec, []))[1].append(lane)
        return eng, lane

    Scheduler._engine_for, Scheduler.evict = engine_for, evict
    try:
        _reset_launches()
        svc, res, _, _ = _serviced(jobs, lane_backend=lane_backend,
                                   slots=slots)
        launches = _launches()
    finally:
        Scheduler._engine_for, Scheduler.evict = real_engine_for, real_evict
    return svc, res, engines, evicted, launches


def _check_group_launches(name, engines, launches):
    """RWMH under "vmap": two ``bright_glm`` launches a group step (the
    proposal and the candidates) and one an init, one ``z_update`` a group
    step; a group step advances every lane, so there are fewer group steps
    than lane-steps wherever a group held two lanes or more."""
    steps = sum(e.group_steps for e in engines)
    inits = sum(e.inits for e in engines)
    want = {"bright_glm": 2 * steps + inits, "z_update": steps}
    if launches != want or min(launches.values()) == 0:
        raise AssertionError(f"{name}: launches {launches}, want {want}")
    return steps, sum(e.lane_steps for e in engines), inits


def vmap_service_path(jobs, ref):
    """The service's "vmap" lanes on the card. First :func:`service_path`'s
    mix (``jobs``; ``ref`` its "map" results, bitwise the solo runs) under
    ``lane_backend="vmap"``: every result bitwise ``ref``, launches counted
    against the engines' group steps. Then a group of 8 logistic MNIST
    jobs, K = 2 (:func:`vmap_group`): its solo runs, an instrumented "vmap"
    run (launches once a group step: 8 lanes a launch), then timed warm
    runs in the order map, vmap, each bitwise the solo runs.
    Prints wall s, ms a lane-step and committed chain-samples/s of both
    backends. Both kernels are held on the group's final lanes, stacked.
    Returns the two instrumented runs' launches and the hold's largest
    |δ − δ_plain|."""
    from repro_torch import random as jr

    svc, res, engines, _, mix_launches = _instrumented(jobs, "vmap",
                                                       SERVICE_SLOTS)
    if svc.faults:
        raise AssertionError(f"vmap mix: fault events {svc.faults}")
    bad = [j.job_id for j in jobs
           if not (_results_equal(res[j.job_id].results, ref[j.job_id].results)
                   and res[j.job_id].committed == ref[j.job_id].committed)]
    if bad:
        raise AssertionError(f"vmap mix: results differ from map: {bad}")
    mix_steps = _check_group_launches("vmap mix", engines, mix_launches)

    group = vmap_group()
    solo, solo_wall = _sequential(group)
    slots = LANES * LANE_CHAINS
    svc, res, engines, evicted, launches = _instrumented(group, "vmap", slots)
    _check_service_run("vmap group (instrumented)", svc, res, group, solo)
    steps, lane_steps, inits = _check_group_launches("vmap group", engines,
                                                     launches)
    if len(engines) != 1 or lane_steps != LANES * steps:
        raise AssertionError(f"vmap group: {len(engines)} engines, "
                             f"{lane_steps} lane-steps over {steps} group "
                             f"steps (want one engine of {LANES} lanes)")
    walls = {"map": [], "vmap": []}
    for backend in ("map", "vmap"):
        t_svc, t_res, wall, _ = _serviced(group, lane_backend=backend,
                                          slots=slots)
        _check_service_run(f"{backend} group (timed)", t_svc, t_res, group,
                           solo)
        walls[backend].append(wall)
    ((spec, lanes),) = evicted.values()
    err = lanes_kernels_held(spec, lanes, jr.key(37), "vmap group")
    torch.cuda.empty_cache()

    chain_samples = sum(r.committed * LANE_CHAINS for r in res.values())
    mean = {b: sum(w) / len(w) for b, w in walls.items()}
    log(f"vmap service path [{card_line()}]: the mix under lane_backend="
        f"'vmap' bitwise the 'map' run (group steps, lane-steps, inits "
        f"{mix_steps}, launches {mix_launches}); group of {LANES} logistic "
        f"MNIST {N_MNIST}x{D_MNIST} jobs, K={LANE_CHAINS}, {LANE_SAMPLES} "
        f"samples, chunk {SERVICE_CHUNK}: timed in the order map, vmap: "
        f"wall map {[round(w, 3) for w in walls['map']]} s, vmap "
        f"{[round(w, 3) for w in walls['vmap']]} s (ratio of means vmap/map "
        f"{mean['vmap'] / mean['map']:.3f}); ms a lane-step map "
        f"{mean['map'] * 1e3 / lane_steps:.3f}, vmap "
        f"{mean['vmap'] * 1e3 / lane_steps:.3f} ({lane_steps} lane-steps, "
        f"{steps} group steps); committed chain-samples/s map "
        f"{chain_samples / mean['map']:.1f}, vmap "
        f"{chain_samples / mean['vmap']:.1f}; solo sequential "
        f"{solo_wall:.3f} s; every run bitwise the solo runs; launches "
        f"{launches} ({inits} inits)")
    return mix_launches, launches, err


# ---------------------------------------------------------------------------
# 6c. Data-sharded FlyMC and the chain fleet on 4 ranks
# ---------------------------------------------------------------------------


def _dist_problem():
    """The reference example's problem (examples/distributed_flymc.py):
    logistic, N = 32,768, D = 11, separation 2, MAP-tuned bounds, on the
    current card; and θ_MAP. Every rank builds the same."""
    from repro_torch import random as jr
    from repro_torch.data import logistic_data
    from repro_torch.models.bayes_glm import GLMModel

    data = logistic_data(jr.key(0), n=DIST_N, d=DIST_D, separation=2.0)
    model = GLMModel.logistic(data, prior_scale=1.0, xi=1.5)
    theta_map = model.map_estimate(jr.key(1), steps=400)
    return model.map_tuned(theta_map), theta_map


def _counted_steps(alg, state, key, steps):
    """``steps`` steps from ``state`` with the collectives counted, those
    inside the z-update apart, and the lines where the host waited on the
    card (sync debug mode). Returns (collectives a step, z-phase
    collectives, {site: waits})."""
    import warnings
    from collections import Counter

    from repro_torch import random as jr
    from repro_torch.core import flymc
    from repro_torch.distributed import comm

    z_made = {"sum": 0, "max": 0}
    names = ("_fused_z_update", "_implicit_z_update")
    real = {n: getattr(flymc, n) for n in names}

    def wrap(fn):
        def counted(*a, **k):
            before = dict(comm.counts)
            out = fn(*a, **k)
            for op in z_made:
                z_made[op] += comm.counts[op] - before[op]
            return out
        return counted

    keys = jr.split(key, state.iteration.shape[0])
    for n, fn in real.items():
        setattr(flymc, n, wrap(fn))
    torch.cuda.synchronize()
    comm.reset_counts()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for _ in range(steps):
                    state, _ = alg.step(jr.fold_in(keys, state.iteration),
                                        state)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        made = dict(comm.counts)
    finally:
        for n, fn in real.items():
            setattr(flymc, n, fn)
    sites = Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                    if "called a synchronizing CUDA operation"
                    in str(w.message))
    return {op: v / steps for op, v in made.items()}, z_made, dict(sites)


def _example_chain(alg, theta_map):
    """The example's run, ``DIST_CHAINS`` chains from θ_MAP: a quarter of
    the iterations warmup without output, then the rest streamed (online
    moments, split-R̂, the query budget and, to check the streamed values,
    the full trace). Returns (warm trace, sampling trace)."""
    from repro_torch import api
    from repro_torch import random as jr

    burn = DIST_ITERS // 4
    warm = api.sample(alg, jr.key(2), burn, num_chains=DIST_CHAINS,
                      init_position=theta_map, collectors={})
    tr = api.sample(warm.algorithm, jr.key(3), DIST_ITERS - burn,
                    num_chains=DIST_CHAINS, init_state=warm.final_state,
                    collectors={"moments": api.OnlineMoments(),
                                "rhat": api.RHat(),
                                "queries": api.QueryBudget(),
                                "trace": api.FullTrace()})
    return warm, tr


def _streamed_checks(tr):
    """The example's checks: streamed moments and R̂ against the offline
    trace, the query budget against the summed stats. Returns the numbers
    printed."""
    from repro_torch.core import diagnostics

    off = tr.results["trace"]["theta"].double().cpu().numpy()
    st = tr.results["trace"]["stats"]
    mom = tr.results["moments"]
    np.testing.assert_allclose(np.asarray(mom["mean"]), off.mean(1),
                               atol=1e-3)
    rhat = float(tr.results["rhat"]["r_hat"])
    np.testing.assert_allclose(rhat, diagnostics.split_r_hat(off), rtol=1e-4)
    total_q = int(tr.results["queries"])
    if total_q != int(st.lik_queries.to(torch.int64).sum()):
        raise AssertionError("streamed query budget differs from the trace")
    pooled = off.reshape(-1, off.shape[-1])
    return {"samples": off, "mean": pooled.mean(0), "sd": pooled.std(0),
            "rhat": rhat, "q_iter": total_q / off.shape[0] / off.shape[1],
            "bright_share": float(st.n_bright.double().mean()) / DIST_N}


def _dist_logistic(group):
    """The example on this rank's shard: the chain, its checks, its
    collectives and host waits a step (8 more steps), its launches against
    its steps and inits, and both kernels held on its final state."""
    from repro_torch import random as jr
    from repro_torch.distributed import comm
    from repro_torch.distributed.flymc_dist import dist_algorithm, shard_data

    tuned, theta_map = _dist_problem()
    shard = shard_data(tuned.data, group)
    alg = dist_algorithm(tuned.bound, tuned.log_prior, group, shard,
                         kernel="rwmh", capacity=DIST_CAP,
                         cand_capacity=DIST_CAP, q_db=DIST_Q,
                         step_size=DIST_STEP, adapt_target=0.234)
    _reset_launches()
    torch.cuda.synchronize()
    torch.distributed.barrier(group)
    t0 = time.perf_counter()
    warm, tr = _example_chain(alg, theta_map)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    steps = warm.steps_run + tr.steps_run
    want = {"bright_glm": 2 * steps + warm.inits_run + tr.inits_run,
            "z_update": steps}
    if launches != want:
        raise AssertionError(f"rank {comm.rank(group)}: dist launches "
                             f"{launches}, want {want}")
    out = _streamed_checks(tr)
    per_step, z_made, sites = _counted_steps(tr.algorithm, tr.final_state,
                                             jr.key(5), 8)
    err = robust_kernels_held(tr.algorithm.spec, shard,
                              tr.algorithm.stats, tr.final_state, jr.key(38),
                              family="logistic",
                              label=f"dist rank {comm.rank(group)}",
                              own_total=True)
    out.update(ms_iter=wall * 1e3 / DIST_ITERS, launches=launches,
               steps=steps, per_step=per_step, z_phase=z_made,
               waits_a_step=sum(sites.values()) / 8, sites=sites,
               capacity=tr.algorithm.spec.capacity, max_abs_err=err)
    return out


def _dist_opv(group, theta_map):
    """The robust-regression problem at the OPV width on this rank's shard
    (slice sampling, 2 chains from θ_MAP): ms/iter, queries/iter and the
    posterior-mean RMSE against θ_true."""
    from repro_torch import api
    from repro_torch import random as jr
    from repro_torch.core import samplers
    from repro_torch.data import robust_data
    from repro_torch.distributed import comm
    from repro_torch.distributed.flymc_dist import dist_algorithm, shard_data
    from repro_torch.models.bayes_glm import GLMModel

    data, theta_true = robust_data(jr.key(30), n=N_OPV, d=D_OPV, nu=4.0)
    model = GLMModel.robust(data, nu=4.0, sigma=1.0, prior_scale=1.0)
    theta_map = theta_map.to(data.x.device)
    tuned = model.map_tuned(theta_map)
    bound, prior = tuned.bound, tuned.log_prior
    shard = shard_data(tuned.data, group)
    del data, model, tuned
    torch.cuda.empty_cache()
    alg = dist_algorithm(bound, prior, group, shard,
                         step_size=0.05, kernel="slice",
                         capacity=DIST_OPV_CAP, cand_capacity=DIST_OPV_CAP,
                         q_db=0.01)
    _reset_launches()
    w0 = samplers.waits
    torch.cuda.synchronize()
    torch.distributed.barrier(group)
    t0 = time.perf_counter()
    tr = api.sample(alg, jr.key(32), DIST_OPV_ITERS, num_chains=CHAINS,
                    init_position=theta_map)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    trips = samplers.waits - w0
    want = {"bright_glm": trips + tr.steps_run + tr.inits_run,
            "z_update": tr.steps_run}
    if launches != want:
        raise AssertionError(f"rank {comm.rank(group)}: OPV launches "
                             f"{launches}, want {want}")
    theta = tr.theta.cpu().numpy()
    post = theta[:, DIST_OPV_BURN:].reshape(-1, D_OPV).mean(0)
    rmse = float(np.sqrt(np.mean((post - theta_true.cpu().numpy()) ** 2)))
    st = tr.stats
    return {"ms_iter": wall * 1e3 / DIST_OPV_ITERS, "rmse": rmse,
            "q_iter": float(st.lik_queries[:, DIST_OPV_BURN:].double().mean()),
            "bright": float(st.n_bright[:, DIST_OPV_BURN:].double().mean()),
            "trips_a_step": trips / tr.steps_run, "launches": launches,
            "capacity": tr.algorithm.spec.capacity,
            "finite": bool(np.isfinite(theta).all())}


def _fleet_alg():
    """The fleet's algorithm: RWMH on the kernel engines at the MNIST width
    from θ = 0, untuned bounds."""
    from repro_torch import api
    from repro_torch import random as jr
    from repro_torch.data import logistic_data
    from repro_torch.models.bayes_glm import GLMModel

    model = GLMModel.logistic(logistic_data(jr.key(0), n=N_MNIST, d=D_MNIST))
    return api.firefly(model, kernel="rwmh", capacity=CAPACITY,
                       cand_capacity=CAPACITY, q_db=0.01, step_size=0.03)


def _fleet(group):
    """This rank's rows of a ``DIST_RANKS · FLEET_CHAINS``-chain run through
    ``chain_fleet``, and the collectives its steps made (none)."""
    from repro_torch import api
    from repro_torch import random as jr
    from repro_torch.distributed import comm
    from repro_torch.distributed.flymc_dist import chain_fleet

    alg = chain_fleet(_fleet_alg(), group)
    comm.reset_counts()
    _reset_launches()
    tr = api.sample(alg, jr.key(40), FLEET_ITERS,
                    num_chains=DIST_RANKS * FLEET_CHAINS)
    want = {"bright_glm": 2 * tr.steps_run + tr.inits_run,
            "z_update": tr.steps_run}
    if _launches() != want:
        raise AssertionError(f"fleet rank {comm.rank(group)}: launches "
                             f"{_launches()}, want {want}")
    return {"theta": tr.theta.cpu().numpy(),
            "stats": [a.cpu().numpy() for a in tr.stats],
            "collectives": dict(comm.counts), "launches": _launches(),
            "steps": tr.steps_run, "inits": tr.inits_run}


def _dist_rank(group, theta_map):
    """Everything ``dist_path`` runs on each of its ranks, in one start."""
    out = {"logistic": _dist_logistic(group)}
    torch.cuda.empty_cache()
    out["opv"] = _dist_opv(group, theta_map)
    torch.cuda.empty_cache()
    out["fleet"] = _fleet(group)
    return out


def dist_path(theta_map):
    """Data-sharded FlyMC and the chain fleet on the one card.

    ``DIST_RANKS`` ranks (processes, gloo over CUDA tensors; NCCL refuses
    two ranks on one device), started once through
    ``repro_torch.distributed.launch.run_ranks``, each run: the reference
    example's problem (:func:`_dist_problem`, RWMH, capacity 256 a shard,
    q_db 0.01, ``DIST_ITERS`` iterations; the streamed moments, R̂ and query budget
    checked against the offline trace; all-reduces a step counted by
    ``repro_torch.distributed.comm`` and held to ≤ 4 SUM and ≤ 1 MAX with
    none in the z-phase; host waits a step; launches against steps and
    inits; both kernels held on the shard's final state); the robust
    problem at the OPV width (slice, 2 chains from θ_MAP, ``DIST_OPV_ITERS``
    iterations: RMSE of the posterior mean against θ_true below
    ``ROBUST_RMSE_MAX``, ms/iter, queries/iter); and ``chain_fleet`` with
    ``FLEET_CHAINS`` chains a rank at the MNIST width. Every rank's
    replicated outputs must agree bitwise. Then, in this process: a
    single-device FlyMC chain of the example's length (the sharded chain's
    posterior mean within 0.35 of the largest sd and its sd within 50%,
    ``tests/test_flymc_distributed.py``'s tolerances), the fleet's
    single-process batched run (each rank's rows bitwise), and a 1-rank
    NCCL group running the sharded step for ``NCCL_ITERS`` iterations.
    Returns the launches of rank 0's example chain, of the fleet and of
    the NCCL run, and the holds' largest |δ − δ_plain|."""
    from repro_torch import api
    from repro_torch import random as jr
    from repro_torch.distributed import comm
    from repro_torch.distributed.flymc_dist import dist_algorithm
    from repro_torch.distributed.launch import run_ranks, single_rank

    t0 = time.perf_counter()
    outs = run_ranks(_dist_rank, DIST_RANKS, backend="gloo", device="cuda",
                     args=(theta_map,), timeout_s=900)
    ranks_s = time.perf_counter() - t0
    lg = [o["logistic"] for o in outs]
    for o in lg[1:]:
        if not np.array_equal(o["samples"], lg[0]["samples"]):
            raise AssertionError("dist ranks hold different chains")
    for o in lg:
        if o["per_step"]["sum"] > 4 or o["per_step"]["max"] > 1:
            raise AssertionError(f"dist step collectives {o['per_step']}")
        if any(o["z_phase"].values()):
            raise AssertionError(f"z-phase collectives {o['z_phase']}")
    opv = [o["opv"] for o in outs]
    if not (opv[0]["finite"] and opv[0]["rmse"] < ROBUST_RMSE_MAX):
        raise AssertionError(f"dist OPV posterior-mean RMSE {opv[0]['rmse']}")

    # the single-device chain of the same length
    tuned, map_dist = _dist_problem()
    one = api.firefly(tuned, kernel="rwmh", capacity=DIST_RANKS * DIST_CAP,
                      cand_capacity=DIST_RANKS * DIST_CAP, q_db=DIST_Q,
                      step_size=DIST_STEP, adapt_target=0.234)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, tr = _example_chain(one, map_dist)
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t1) * 1e3 / DIST_ITERS
    ref = _streamed_checks(tr)
    # tests/test_flymc_distributed.py's tolerances, checked after the log
    mean_gap = float(np.abs(lg[0]["mean"] - ref["mean"]).max())
    mean_tol = 3.5 * float(ref["sd"].max()) / 10
    sd_gap = float((np.abs(lg[0]["sd"] - ref["sd"]) / ref["sd"]).max())

    # the fleet against the single-process batched run
    fl = [o["fleet"] for o in outs]
    whole = api.sample(_fleet_alg(), jr.key(40), FLEET_ITERS,
                       num_chains=DIST_RANKS * FLEET_CHAINS)
    for r, o in enumerate(fl):
        rows = slice(r * FLEET_CHAINS, (r + 1) * FLEET_CHAINS)
        same = np.array_equal(o["theta"], whole.theta[rows].cpu().numpy())
        same &= all(np.array_equal(a, b[rows].cpu().numpy())
                    for a, b in zip(o["stats"], whole.stats))
        if not same or any(o["collectives"].values()):
            raise AssertionError(f"fleet rank {r}: bitwise {same}, "
                                 f"collectives {o['collectives']}")

    # a 1-rank NCCL group runs the same sharded step
    with single_rank("nccl", "cuda") as group:
        alg = dist_algorithm(tuned.bound, tuned.log_prior, group, tuned.data,
                             kernel="rwmh", capacity=DIST_CAP,
                             cand_capacity=DIST_CAP, q_db=DIST_Q,
                             step_size=DIST_STEP, adapt_target=0.234)
        comm.reset_counts()
        _reset_launches()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        nc = api.sample(alg, jr.key(2), NCCL_ITERS, init_position=map_dist)
        torch.cuda.synchronize()
        nccl_ms = (time.perf_counter() - t2) * 1e3 / NCCL_ITERS
        nccl_launches, nccl_counts = _launches(), dict(comm.counts)
    if not (bool(torch.isfinite(nc.theta).all())
            and nccl_launches["z_update"] == nc.steps_run
            and nccl_counts["max"] >= nc.steps_run):
        raise AssertionError(f"NCCL run: launches {nccl_launches}, "
                             f"collectives {nccl_counts}")
    err = max(o["max_abs_err"] for o in lg)
    l0, o0 = lg[0], opv[0]
    log(f"dist path [{DIST_RANKS} ranks, gloo over CUDA tensors on one card; "
        f"{card_line()}]: example problem (logistic N={DIST_N} D={DIST_D}, "
        f"RWMH, capacity {DIST_CAP} a shard, grown to {l0['capacity']}, "
        f"q_db {DIST_Q}, {DIST_CHAINS} chains from θ_MAP, {DIST_ITERS} "
        f"iterations): ms/iter {l0['ms_iter']:.3f} "
        f"(single device {one_ms:.3f}); posterior mean {np.round(l0['mean'], 4).tolist()} "
        f"sd {np.round(l0['sd'], 4).tolist()} (single device mean "
        f"{np.round(ref['mean'], 4).tolist()} sd {np.round(ref['sd'], 4).tolist()}); "
        f"split-R̂ {l0['rhat']:.4f} (single device {ref['rhat']:.4f}); "
        f"queries/iter {l0['q_iter']:.1f} ({DIST_N / l0['q_iter']:.0f}x fewer "
        f"than full data; single device {ref['q_iter']:.1f}); bright share "
        f"{l0['bright_share']:.5f}; all-reduces a step {l0['per_step']} "
        f"(z-phase {l0['z_phase']}); host waits a step outside the "
        f"collectives {l0['waits_a_step']:.2f} at {l0['sites']} (sync debug "
        f"mode; gloo waits for the stream inside each all-reduce on a CUDA "
        f"tensor, {sum(l0['per_step'].values()):.0f} a step); launches rank "
        f"0 {l0['launches']} over "
        f"{l0['steps']} steps | OPV robust (N={N_OPV} D={D_OPV}, slice, "
        f"{CHAINS} chains from θ_MAP, {DIST_OPV_ITERS} iterations, burn "
        f"{DIST_OPV_BURN}): ms/iter {o0['ms_iter']:.3f}, queries/iter "
        f"{o0['q_iter']:.1f}, bright {o0['bright']:.1f}, capacity a shard "
        f"{o0['capacity']}, density evaluations a step "
        f"{o0['trips_a_step']:.2f}, posterior-mean RMSE vs θ_true "
        f"{o0['rmse']:.5f}, launches rank 0 {o0['launches']} | fleet "
        f"({DIST_RANKS} ranks x {FLEET_CHAINS} chains, MNIST, {FLEET_ITERS} "
        f"iterations) bitwise the single-process {DIST_RANKS * FLEET_CHAINS}"
        f"-chain run, no collective, launches rank 0 {fl[0]['launches']} | "
        f"NCCL 1 rank: {NCCL_ITERS} iterations, ms/iter {nccl_ms:.3f}, "
        f"all-reduces {nccl_counts} | ranks' wall {ranks_s:.1f} s; "
        f"posterior vs single device: max|Δ mean| {mean_gap:.4f} (limit "
        f"{mean_tol:.4f}), max relative |Δ sd| {sd_gap:.3f} (limit 0.5)")
    if not (mean_gap <= mean_tol and sd_gap <= 0.5):
        raise AssertionError("the sharded chain's posterior differs from the "
                             "single-device chain's")
    return {"dist": l0["launches"], "dist_opv": o0["launches"],
            "fleet": fl[0]["launches"], "nccl": nccl_launches}, err


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


def decode_attention_phase(name, b, h, hk, d, w, t, window, dtype, dev, gen,
                           pos=None):
    """The kernel against its plain version at one shape: a ring of ``w``
    slots after writing positions 0..t (or the given ``pos``: a
    cross-attention's 0..W-1), timed beside the plain version and
    ``scaled_dot_product_attention``."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    q = torch.randn(b, h, d, generator=gen).to(dev)
    k = torch.randn(b, w, hk, d, generator=gen).to(dtype).to(dev)
    v = torch.randn(b, w, hk, d, generator=gen).to(dtype).to(dev)
    pos = _ring_pos(w, t, dev) if pos is None else pos.to(dev)
    args = (q, k, v, pos, t, window)
    before = ops.launch_count
    got = ops.decode_attention(*args)
    if ops.launch_count - before != 1:
        raise AssertionError(f"decode_attention[{name}]: "
                             f"{ops.launch_count - before} launches a call")
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


def decode_exactness(dev, arch: str, batch: int, prompt: int,
                     n_layers: int | None = None) -> None:
    """tests/test_serving.py::test_decode_matches_forward at the published
    width (``n_layers`` cuts the depth), in float32: prefill ``prompt``
    tokens (whisper's frames or llava's patches drawn as ``serve`` draws
    them) + one decode step against the full forward over ``prompt + 1``
    tokens, logits at rtol/atol 2e-3 and the greedy token equal to the
    forward's argmax. An MoE's decode step and forward see other token
    counts, so other capacities: the check needs a forward in which no
    pair drops (the decode step's capacity of 8 holds its tokens), and
    fails otherwise."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import serving as SV
    from repro_torch.models import transformer as T

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    t0 = time.perf_counter()
    model = T.init_model(cfg, 0, dev, torch.float32)
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt + 1),
                         generator=gen, device=dev)
    stub = {}
    if cfg.family == "encdec":
        stub["frames"] = 0.1 * torch.randn(batch, cfg.encoder_seq,
                                           cfg.d_model, generator=gen,
                                           device=dev)
    if cfg.family == "vlm":
        stub["patches"] = 0.1 * torch.randn(batch, cfg.patch_positions,
                                            cfg.d_model, generator=gen,
                                            device=dev)
    seq_len = prompt + 1
    with torch.inference_mode():
        cache, _ = SV.prefill(model, toks[:, :prompt], seq_len,
                              torch.float32, torch.float32, **stub)
        nxt, logits, cache = SV.decode_step(model, cache, toks[:, prompt:],
                                            seq_len, torch.float32)
        del cache
        h, aux = T.forward_hidden(model, toks, torch.float32, aux=True,
                                  **stub)
        ref = (h[:, -1:] @ model.embed.head).float()
    torch.cuda.synchronize()
    if float(aux["drop_frac"]) != 0.0:
        raise AssertionError(f"{arch}: the forward drops MoE pairs")
    err = float((logits - ref).abs().max())
    torch.testing.assert_close(logits, ref, rtol=2e-3, atol=2e-3)
    if not torch.equal(nxt[:, 0], ref[:, 0].argmax(-1)):
        raise AssertionError(f"{arch}: greedy token differs from the "
                             "forward's argmax")
    log(f"serving exactness [{arch} full width, {cfg.n_layers} layers, "
        f"{n_params / 1e9:.3f} B params, float32, batch {batch}]: prefill "
        f"{prompt} + 1 decode step vs forward over {seq_len} tokens: "
        f"max|Δ logits| {err:.3g} (tolerance 2e-3), greedy tokens "
        f"{nxt[:, 0].tolist()} == forward argmax; "
        f"{time.perf_counter() - t0:.1f} s")
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


BWD_KERNELS = ("rwkv6_scan_bwd_ds_kernel", "rwkv6_scan_bwd_chunk_kernel")


def rwkv_grad_phase(name, b, h, s, d, logw, dev, gen):
    """``RWKV6Scan`` at (B, H, S, D) with a random state0 and cotangents on
    y and the final state: the state-saving forward's y and final state
    bitwise the serving kernel's; the backward (two launches,
    ``rwkv6_scan_bwd_ds_kernel`` then ``rwkv6_scan_bwd_chunk_kernel``, and
    those two device kernels a call; two calls bitwise equal) against
    ``rwkv6_bwd_ref`` on the kernel's saved states and against autograd
    through ``rwkv6_chunked_ref``, each gradient within 1e-4 relative plus
    1e-4 of its largest value; each kernel against its own plain piece (the
    dS scratch and dstate0 against ``rwkv6_bwd_ds_ref``, the chunk pass fed
    that scratch against ``rwkv6_bwd_chunks_ref``). ``bwd_ms`` is the two
    kernels' device time a call (``ds_ms`` and ``chunk_ms`` each's, a
    launch's mean over one trace, :func:`launch_ms`),
    ``bwd_device_ms`` the device time of all the backward's work through
    autograd, ``bwd_call_ms`` that backward's time between CUDA events,
    ``bwd_plain_ms`` ``rwkv6_bwd_ref``'s (``ds_plain_ms``,
    ``chunk_plain_ms``: each piece's)."""
    from repro_torch.kernels.rwkv6_scan import ops
    from repro_torch.kernels.rwkv6_scan.ref import (rwkv6_bwd_chunks_ref,
                                                     rwkv6_bwd_ds_ref,
                                                     rwkv6_bwd_ref,
                                                     rwkv6_chunked_ref)

    r, k, v, dy = (torch.randn(b, h, s, d, generator=gen).to(dev)
                   for _ in range(4))
    lw = (-(1e-6 + (1.0 - 1e-6) * torch.rand(b, h, s, d, generator=gen))
          if logw is None else torch.full((b, h, s, d), logw)).to(dev)
    u = torch.randn(h, d, generator=gen).to(dev)
    s0, ds = (torch.randn(b, h, d, d, generator=gen).to(dev)
              for _ in range(2))
    c = min(64, s)
    y0, st0 = ops.rwkv6_scan(r, k, v, lw, u, s0)
    y, st, states = ops._launch(r, k, v, lw, u, s0, c, save_states=True)
    if not (torch.equal(y, y0) and torch.equal(st, st0)):
        raise AssertionError(f"rwkv6_scan[{name}]: the state-saving forward "
                             "differs from the serving kernel")
    ins = [a.clone().requires_grad_() for a in (r, k, v, lw, u, s0)]
    before = (ops.launch_count, ops.bwd_launch_count)
    yg, stg = ops.rwkv6_scan(*ins)
    got = torch.autograd.grad((yg, stg), ins, (dy, ds), retain_graph=True)
    torch.cuda.synchronize()
    if (ops.launch_count - before[0], ops.bwd_launch_count - before[1]) != (
            3, 2):
        raise AssertionError(f"rwkv6_scan[{name}] forward + backward "
                             f"launched {ops.launch_count - before[0]} "
                             "times, want 3 (2 backward)")
    again = torch.autograd.grad((yg, stg), ins, (dy, ds), retain_graph=True)
    if not all(torch.equal(a, a2) for a, a2 in zip(got, again)):
        raise AssertionError(f"rwkv6_scan backward[{name}]: two calls "
                             "differ")
    plain = rwkv6_bwd_ref(r, k, v, lw, u, states, dy, ds, c)
    ref_ins = [a.clone().requires_grad_() for a in (r, k, v, lw, u, s0)]
    yr, sr = rwkv6_chunked_ref(*ref_ins, chunk=c)
    auto = torch.autograd.grad((yr, sr), ref_ins, (dy, ds))
    torch.cuda.synchronize()
    err, err_abs, err_auto = {}, 0.0, 0.0
    for gname, a, p_, w in zip(("dr", "dk", "dv", "dlogw", "du", "dstate0"),
                               got, plain, auto):
        if not torch.isfinite(a).all():
            raise AssertionError(f"rwkv6_scan backward[{name}]: {gname} "
                                 "not finite")
        for ref in (p_, w):
            torch.testing.assert_close(a, ref, rtol=1e-4,
                                       atol=1e-4 * float(ref.abs().max()))
        err[gname] = float((a - p_).abs().max() / p_.abs().max())
        err_abs = max(err_abs, float((a - p_).abs().max()))
        err_auto = max(err_auto, float((a - w).abs().max()))
    del yr, sr, auto, ref_ins, plain, again
    # each kernel against its own plain piece, the chunk pass fed the dS
    # pass's scratch
    grads, ds_all, _ = ops._launch_bwd(r, k, v, lw, u, states, dy, ds, c,
                                       True, return_scratch=True)
    want_ds, want_ds0 = rwkv6_bwd_ds_ref(r, lw, dy, ds, c)
    want_chunk = rwkv6_bwd_chunks_ref(r, k, v, lw, u, states, ds_all, dy, c)
    torch.cuda.synchronize()
    err_pass = {}
    for pname, pairs in (("ds", ((ds_all, want_ds), (grads[5], want_ds0))),
                         ("chunk", tuple(zip(grads[:4], want_chunk)))):
        for a, ref in pairs:
            torch.testing.assert_close(a, ref, rtol=1e-4,
                                       atol=1e-4 * float(ref.abs().max()))
        err_pass[pname] = max(float((a - ref).abs().max()) for a, ref in pairs)
    del grads, want_ds, want_ds0, want_chunk
    only = lambda: torch.autograd.grad((yg, stg), ins, (dy, ds),
                                       retain_graph=True)
    call_ms = median_ms(only, reps=10, warm=2)
    ds_ms, chunk_ms = launch_ms(only, BWD_KERNELS).values()
    kernel_ms = (None if ds_ms is None or chunk_ms is None
                 else ds_ms + chunk_ms)
    all_ms = device_ms(only, ("",))
    direct = lambda: ops.rwkv6_scan_backward(r, k, v, lw, u, states, dy, ds)
    plain_ms = median_ms(
        lambda: rwkv6_bwd_ref(r, k, v, lw, u, states, dy, ds, c), reps=5,
        warm=1)
    ds_plain_ms = median_ms(lambda: rwkv6_bwd_ds_ref(r, lw, dy, ds, c),
                            reps=5, warm=1)
    chunk_plain_ms = median_ms(
        lambda: rwkv6_bwd_chunks_ref(r, k, v, lw, u, states, ds_all, dy, c),
        reps=5, warm=1)
    del ds_all
    n = s // c
    # bytes: r, k, v, logw, dy, the saved states, d_state and u read once;
    # dr, dk, dv, dlogw, du and dstate0 written once. Operations: per chunk
    # the nine products, the five with a strictly triangular factor (A,
    # dA, Aᵀ·dy, dA·kk, dAᵀ·rq) at c(c-1)/2·D FMAs and the four with the
    # state (k2·dS, dy·S₀ᵀ, v·dSᵀ, rqᵀ·dy) at c·D², two flops an FMA
    b_ms, b_by = bound(
        4 * (9 * b * h * s * d + b * h * n * d * d + 2 * b * h * d * d
             + 2 * h * d),
        2.0 * b * h * n * (5 * c * (c - 1) / 2 * d + 4 * c * d * d))
    # each kernel's own work. The dS pass: r, logw, dy, k, v and d_state in;
    # the dS leaving each chunk, dstate0 and du's row partials out; rqᵀ·dy
    # a chunk. The chunk pass: r, k, v, logw, dy, u, states, that dS and the
    # partials in; dr, dk, dv, dlogw and du out; the other eight products.
    ds_bound = bound(4 * (5 * b * h * s * d + b * h * d * d
                          + b * h * n * d * d + b * h * d * d + b * h * d),
                     2.0 * b * h * n * c * d * d)
    chunk_bound = bound(4 * (9 * b * h * s * d + 2 * b * h * n * d * d
                             + h * d + b * h * d + h * d),
                        2.0 * b * h * n * (5 * c * (c - 1) / 2 * d
                                           + 3 * c * d * d))
    kernel = ("no rwkv6_scan_bwd_* kernel ran" if kernel_ms is None
              else f"backward kernels {kernel_ms:.6f} ms (dS pass {ds_ms:.6f}"
                   f", chunk pass {chunk_ms:.6f})")
    log(f"rwkv6_scan backward[{name}: B={b} H={h} S={s} D={d} c={c} "
        f"logw={'U[-1,-1e-6]' if logw is None else logw}] max|Δ|/max vs "
        f"rwkv6_bwd_ref {', '.join(f'{k_} {v_:.3g}' for k_, v_ in err.items())}"
        f"; max|Δ| vs autograd {err_auto:.3g}; max|Δ| vs its plain piece: dS "
        f"pass {err_pass['ds']:.3g}, chunk pass {err_pass['chunk']:.3g}; "
        f"{kernel}, all the backward's device work {all_ms:.6f} ms, backward "
        f"call {call_ms:.4f} ms, plain {plain_ms:.4f} ms (pieces: dS "
        f"{ds_plain_ms:.4f}, chunks {chunk_plain_ms:.4f}), bound "
        f"{b_ms:.6f} ms ({b_by}; dS pass {ds_bound[0]:.6f} {ds_bound[1]}, "
        f"chunk pass {chunk_bound[0]:.6f} {chunk_bound[1]})")
    phase = {"phase": name, "B": b, "H": h, "S": s, "D": d, "c": c,
             "logw": logw, "max_rel_err": err, "max_abs_err": err_abs,
             "max_abs_err_autograd": err_auto,
             "max_abs_err_ds": err_pass["ds"],
             "max_abs_err_chunk": err_pass["chunk"],
             "bwd_ms": kernel_ms, "ds_ms": ds_ms, "chunk_ms": chunk_ms,
             "bwd_device_ms": all_ms,
             "bwd_call_ms": call_ms, "bwd_plain_ms": plain_ms,
             "ds_plain_ms": ds_plain_ms, "chunk_plain_ms": chunk_plain_ms,
             "bound_ms": b_ms, "bound_by": b_by,
             "ds_bound_ms": ds_bound[0], "ds_bound_by": ds_bound[1],
             "chunk_bound_ms": chunk_bound[0],
             "chunk_bound_by": chunk_bound[1],
             "device_kernels": device_kernels(direct, expect=2)}
    del yg, stg, ins, got, states
    torch.cuda.empty_cache()
    return phase


def rwkv_bwd_phases(dev):
    """The WKV backward at the shapes the rwkv6-7b training path gives it:
    the published heads over one 512-step time chunk of the batch-2
    training step (:func:`train_rwkv_path`); the edge decay; S=32 and
    S=1."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import RWKV_TIME_CHUNK

    cfg = get_config(RWKV_ARCH)
    h, d = cfg.n_heads, cfg.resolved_head_dim
    gen = torch.Generator().manual_seed(26)
    b = TRAIN_BATCH
    return [
        rwkv_grad_phase("train", b, h, RWKV_TIME_CHUNK, d, None, dev, gen),
        rwkv_grad_phase("edge-decay", b, h, RWKV_TIME_CHUNK, d, -1.0, dev,
                        gen),
        rwkv_grad_phase("short", b, h, 32, d, None, dev, gen),
        rwkv_grad_phase("single", b, h, 1, d, None, dev, gen),
    ]


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


def fused_ce_grad_phase(t, d, v, dev, gen, name="backward-f32",
                        chunk=None):
    """``FusedCE``'s backward (the reference's chunk VJP, ``chunk`` rows a
    chunk: the TP loss's 256 by default) at the path's shape in float32,
    against autograd through the plain version over 1024-token chunks: dx
    and dw within 1e-4 of their largest value."""
    from repro_torch.kernels.fused_ce import ops
    from repro_torch.kernels.fused_ce.ref import fused_ce_ref

    x = torch.randn(t, d, generator=gen, device=dev)
    w = torch.randn(d, v, generator=gen, device=dev) / d**0.5
    lab = torch.randint(0, v, (t,), generator=gen, device=dev)
    c = torch.rand(t, generator=gen, device=dev) / t
    chunk = chunk or ops.BWD_CHUNK

    def backward_ms(dtype):
        xg = x.to(dtype, copy=True).requires_grad_()
        wg = w.to(dtype, copy=True).requires_grad_()
        loss = (ops.fused_ce(xg, wg, lab, chunk=chunk) * c).sum()
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
        f"{chunk}]: max|Δ dx|, max|Δ dw| = {errs[0]:.3g}, "
        f"{errs[1]:.3g} of their largest value (tolerance 1e-4); backward "
        f"{bwd_ms:.3f} ms in float32 (first call), {bwd_bf16_ms:.3f} ms in "
        f"bfloat16 (second call; host clock)")
    del x, w, wr, dx, dw, dx_ref
    torch.cuda.empty_cache()
    return {"phase": name, "T": t, "D": d, "V": v, "chunk": chunk,
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


def sp_ce_phases(dev):
    """``fused_ce`` (bf16 in the path's rounding mode) and ``FusedCE``'s
    backward (float32; chunks of B·c = 512 rows, the SP loss's) at each new
    LM head of the SP training path (``SP_HEADS``: T = 4,096 tokens of the
    config's d_model and padded vocabulary). Returns (forward phases,
    backward phases)."""
    from repro_torch.configs import get_config

    gen = torch.Generator(device=dev).manual_seed(25)
    t = SP_BATCH * (SP_SEQ - 1)
    chunk = SP_BATCH * min(SP_SEQ - 1, 256)
    ce, grads = [], []
    for arch in SP_HEADS:
        cfg = get_config(arch)
        d, v = cfg.d_model, cfg.padded_vocab()
        ce.append(fused_ce_phase(arch, t, d, v, torch.bfloat16, dev, gen,
                                 round_logits=True))
        grads.append(fused_ce_grad_phase(t, d, v, dev, gen,
                                         name=f"{arch}-backward",
                                         chunk=chunk))
    return ce, grads


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


def step_breakdown(model, dev, remat: bool = False):
    """One more training step at the path's width, split by CUDA events:
    the forward (``loss_fn``, with its ``fused_ce`` launch), the backward
    (``loss.backward()``, with the CE's chunked VJP, and for
    recurrentgemma 2 ``rglru_scan`` launches; with ``remat`` the groups'
    forwards again) and the optimizer (global norm, clip and AdamW over
    every parameter), as ``make_train_step`` runs them."""
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
    loss, _ = T.loss_fn(model, batch, torch.bfloat16, remat=remat)
    ev[1].record()
    loss.backward()
    ev[2].record()
    grads = {n: p.grad for n, p in params.items()}
    gnorm = T.global_grad_norm(grads, model.specs, model.par)
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
    log(f"train step breakdown [{model.cfg.name} full width, "
        f"{model.cfg.n_layers} layers, bf16, remat {remat}, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ - 1}; CUDA events]: "
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


def train_sp_path(dev):
    """The SP-mode families through ``train_reduced`` at their published
    widths (``SP_TRAIN``), bf16 compute, f32 master weights, batch
    SP_BATCH × (SP_SEQ − 1), SP_STEPS steps each: one ``fused_ce`` launch a
    step and no other kernel's, finite losses and gradient norms, moments
    stored in the config's ``opt_dtype`` (bf16 for qwen1.5-110b). Prints
    per model the step ms (median after the first), tokens/s, peak memory
    beside the training state (weights, gradients, m and v), losses,
    gradient norms, and mixtral's ``lb_loss`` and ``drop_frac``; then
    llama3.2-3b's step split by :func:`step_breakdown`. Returns ({arch:
    fused_ce launches}, {arch: numbers})."""
    from repro_torch.kernels.decode_attention import ops as aops
    from repro_torch.kernels.fused_ce import ops as cops
    from repro_torch.kernels.rglru_scan import ops as rops
    from repro_torch.kernels.rwkv6_scan import ops as wops
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.train import train_reduced

    launches, numbers = {}, {}
    init_opt = train_mod.T.init_opt
    for arch, n_layers, remat in SP_TRAIN:
        made = []

        def recorded(model):  # the AdamW state train_reduced makes
            made.append(init_opt(model))
            return made[-1]

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        cops.launch_count = rops.launch_count = rops.bwd_launch_count = 0
        aops.launch_count = wops.launch_count = 0
        train_mod.T.init_opt = recorded
        try:
            model, hist = train_reduced(
                arch, steps=SP_STEPS, batch=SP_BATCH, seq=SP_SEQ,
                log_every=SP_STEPS, seed=0, full=True, n_layers=n_layers,
                dtype=torch.bfloat16, device=dev, remat=remat)
        finally:
            train_mod.T.init_opt = init_opt
        got = {"fused_ce": cops.launch_count,
               "decode_attention": aops.launch_count,
               "rglru_scan": rops.launch_count,
               "rwkv6_scan": wops.launch_count}
        want = {"fused_ce": SP_STEPS, "decode_attention": 0, "rglru_scan": 0,
                "rwkv6_scan": 0}
        if got != want:
            raise AssertionError(f"{arch} training launches {got}, want "
                                 f"{want}")
        if not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
                   for h in hist):
            raise AssertionError(f"{arch} training not finite: {hist}")
        cfg = model.cfg
        opt_dtype = getattr(torch, cfg.opt_dtype)
        (opt,) = made
        bad = [n for n, t in list(opt.m.items()) + list(opt.v.items())
               if t.dtype != opt_dtype]
        if bad or int(opt.step) != SP_STEPS:
            raise AssertionError(f"{arch}: AdamW state step {int(opt.step)}, "
                                 f"moments not {opt_dtype}: {bad[:4]}")
        del opt, made
        peak = torch.cuda.max_memory_allocated(dev)
        n_params = sum(p.numel() for p in model.parameters())
        state = n_params * (4 + 4 + 2 * torch.finfo(opt_dtype).bits // 8)
        step_ms = statistics.median(h["seconds"] for h in hist[1:]) * 1e3
        tokens = SP_BATCH * (SP_SEQ - 1)
        moe = (f", lb_loss {[round(h['lb_loss'], 5) for h in hist]}, "
               f"drop_frac {[round(h['drop_frac'], 6) for h in hist]}"
               if cfg.moe is not None else "")
        log(f"train sp [{arch} full width, {cfg.n_layers} of "
            f"{train_mod.get_config(arch).n_layers} layers, "
            f"{n_params / 1e9:.3f} B params, remat {remat}, bf16 compute, f32 "
            f"master, {cfg.opt_dtype} AdamW moments, batch {SP_BATCH} x "
            f"{SP_SEQ - 1} tokens, {SP_STEPS} steps; {card_line()}]: step ms "
            f"{[round(h['seconds'] * 1e3, 3) for h in hist]}, median after "
            f"the first {step_ms:.3f} ms, {tokens / step_ms * 1e3:.1f} "
            f"tokens/s, peak memory {peak / 2**30:.2f} GiB "
            f"({peak / 1e9:.2f} GB; training state {state / 1e9:.2f} GB); "
            f"loss {[round(h['loss'], 4) for h in hist]}, grad norm "
            f"{[round(h['grad_norm'], 4) for h in hist]}{moe}")
        launches[arch] = got["fused_ce"]
        numbers[arch] = {"step_ms": step_ms, "peak_gb": peak / 1e9,
                         "state_gb": state / 1e9,
                         "tokens_per_s": tokens / step_ms * 1e3}
        if arch == "llama3.2-3b":
            numbers[arch]["breakdown"] = step_breakdown(model, dev, remat)
        del model, hist
        torch.cuda.empty_cache()
    return launches, numbers


def train_rwkv_path(dev):
    """rwkv6-7b through ``train_reduced`` at its published width cut to
    RWKV_TRAIN_LAYERS layers, remat, bf16 compute, f32 master weights and
    AdamW moments, batch TRAIN_BATCH × (TRAIN_SEQ − 1), RWKV_TRAIN_STEPS
    steps. A step makes one ``fused_ce`` launch, one WKV backward a layer
    and 512-token time chunk (two launches: the dS pass and the chunk
    pass), and the forward launches of the group
    forwards that remat runs: 12 one-layer groups nest in 4 outer
    checkpoints of 3 (:func:`~repro_torch.models.transformer._inner_groups`),
    so each group's forward runs once in the forward, once in its outer
    checkpoint's recompute and, but for an outer checkpoint's last group,
    once more in its own (``tests/test_torch_train_sp_steps.py::
    test_remat_runs_each_group_forward_again``): 2·12 + 8 = 32 group
    forwards, 128 WKV forwards over 4 time chunks. Prints step ms (median
    after the first), tokens/s, peak memory beside the training state and
    the step split by :func:`step_breakdown`. Returns (launches, numbers)."""
    from repro_torch.kernels.decode_attention import ops as aops
    from repro_torch.kernels.fused_ce import ops as cops
    from repro_torch.kernels.rglru_scan import ops as rops
    from repro_torch.kernels.rwkv6_scan import ops as wops
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.train import train_reduced
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import RWKV_TIME_CHUNK

    steps, n_layers = RWKV_TRAIN_STEPS, RWKV_TRAIN_LAYERS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cops.launch_count = rops.launch_count = rops.bwd_launch_count = 0
    aops.launch_count = wops.launch_count = wops.bwd_launch_count = 0
    wops.bwd_ds_launch_count = wops.bwd_chunk_launch_count = 0
    model, hist = train_reduced(RWKV_ARCH, steps=steps, batch=TRAIN_BATCH,
                                seq=TRAIN_SEQ, log_every=steps, seed=0,
                                full=True, n_layers=n_layers,
                                dtype=torch.bfloat16, device=dev, remat=True)
    chunks = (TRAIN_SEQ - 1) // RWKV_TIME_CHUNK
    n_groups = n_layers // len(model.cfg.block_pattern)
    inner = T._inner_groups(n_groups)
    group_fwds = 2 * n_groups + (n_groups - n_groups // inner
                                 if inner > 1 else 0)
    bwd = wops.bwd_launch_count
    launches = {"fused_ce": cops.launch_count,
                "rwkv6_scan": wops.launch_count - bwd, "rwkv6_scan_bwd": bwd,
                "rwkv6_scan_bwd_ds": wops.bwd_ds_launch_count,
                "rwkv6_scan_bwd_chunk": wops.bwd_chunk_launch_count,
                "decode_attention": aops.launch_count,
                "rglru_scan": rops.launch_count}
    want = {"fused_ce": steps, "rwkv6_scan": group_fwds * chunks * steps,
            "rwkv6_scan_bwd": 2 * n_layers * chunks * steps,
            "rwkv6_scan_bwd_ds": n_layers * chunks * steps,
            "rwkv6_scan_bwd_chunk": n_layers * chunks * steps,
            "decode_attention": 0, "rglru_scan": 0}
    if launches != want:
        raise AssertionError(f"rwkv6 training launches {launches}, want "
                             f"{want}")
    if not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in hist):
        raise AssertionError(f"rwkv6 training not finite: {hist}")
    peak = torch.cuda.max_memory_allocated(dev)
    n_params = sum(p.numel() for p in model.parameters())
    state = n_params * 16
    step_ms = statistics.median(h["seconds"] for h in hist[1:]) * 1e3
    tokens = TRAIN_BATCH * (TRAIN_SEQ - 1)
    log(f"train rwkv [{RWKV_ARCH} full width, {n_layers} of "
        f"{train_mod.get_config(RWKV_ARCH).n_layers} layers, "
        f"{n_params / 1e9:.3f} B params, remat, bf16 compute, f32 master + "
        f"AdamW, batch {TRAIN_BATCH} x {TRAIN_SEQ - 1} tokens, {steps} "
        f"steps; {card_line()}]: step ms "
        f"{[round(h['seconds'] * 1e3, 3) for h in hist]}, median after the "
        f"first {step_ms:.3f} ms, {tokens / step_ms * 1e3:.1f} tokens/s, "
        f"peak memory {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB; training "
        f"state {state / 1e9:.2f} GB); loss "
        f"{[round(h['loss'], 4) for h in hist]}, grad norm "
        f"{[round(h['grad_norm'], 4) for h in hist]}; launches a step: "
        f"fused_ce {launches['fused_ce'] / steps:g}, rwkv6_scan forward "
        f"{launches['rwkv6_scan'] / steps:g} ({group_fwds} group forwards x "
        f"{chunks} time chunks), backward "
        f"{launches['rwkv6_scan_bwd'] / steps:g} (dS pass "
        f"{launches['rwkv6_scan_bwd_ds'] / steps:g}, chunk pass "
        f"{launches['rwkv6_scan_bwd_chunk'] / steps:g})")
    numbers = {"step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
               "peak_gb": peak / 1e9, "state_gb": state / 1e9,
               "breakdown": step_breakdown(model, dev, remat=True)}
    del model, hist
    torch.cuda.empty_cache()
    return launches, numbers


# ---------------------------------------------------------------------------
# 16. The LM head (FlyMC over models/lastlayer.py) and the dense decoders
# ---------------------------------------------------------------------------


def wide_bright_phase(name, n, d, kc, c, dev):
    """The wide softmax ``bright_glm`` kernel (past 16 classes) against its
    plain version at (N, D, Kc, C), one chain: θ at scale 0.003 (the
    lastlayer prior's), ξ the logits of a θ 0.001 away (a MAP-tuned bound
    near its tangency), 5 padded slots. δ to ``WIDE_CLOSE``; the total to
    the plain sum of the kernel's own δ (log(expm1 δ) near δ ≈ 0). One
    device kernel a call, ``bright_glm_wide_kernel``."""
    from repro_torch.kernels.bright_glm import ops
    from repro_torch.kernels.bright_glm.ref import (bright_glm_ref,
                                                    total_of_delta)

    g = torch.Generator(device=dev).manual_seed(kc + c)
    x = torch.randn(n, d, generator=g, device=dev)
    t = torch.randint(0, kc, (n,), generator=g, device=dev)
    theta = 0.003 * torch.randn(1, kc, d, generator=g, device=dev)
    xi = x @ (theta[0] + 0.001 * torch.randn(kc, d, generator=g,
                                             device=dev)).t()
    idx = torch.randperm(n, generator=g, device=dev)[:c].to(torch.int32)
    idx = idx[None]
    nb = torch.full((1,), c - 5, dtype=torch.int64, device=dev)
    args = (x, t, xi, idx, nb, theta)
    call = lambda: ops.bright_glm(*args, family="softmax")
    before = ops.wide_launch_count
    delta, total = call()
    torch.cuda.synchronize()
    if ops.wide_launch_count - before != 1:
        raise AssertionError(f"wide bright_glm[{name}]: not one wide launch")
    d_ref, t_ref = bright_glm_ref(*args, family="softmax")
    torch.testing.assert_close(delta, d_ref, **WIDE_CLOSE)
    own = total_of_delta(delta, nb)
    torch.testing.assert_close(total, own, rtol=1e-5, atol=1e-5)
    err = float((delta - d_ref).abs().max())
    ms = median_ms(call, reps=10, warm=2)
    dev_ms = device_ms(call, ("bright_glm",), reps=10)
    kernels = device_kernels(call, reps=5)
    per_call = sum(map(len, kernels)) / len(kernels)
    q_ms = queued_ms(call, reps=20)
    plain = median_ms(lambda: bright_glm_ref(*args, family="softmax"),
                      reps=3, warm=1)
    b_ms, b_by = bound(kc * d * 4 + c * (4 + 4 * d + 8 + 4 * kc) + c * 4 + 4,
                       2.0 * c * kc * d)
    log(f"bright_glm wide[{name}: N={n} D={d} Kc={kc} C={c}] "
        f"max|δ-δ_plain|={err:.3g} (|δ| ≤ {float(d_ref.abs().max()):.4g}), "
        f"total {float(total[0]):.7g}, plain sum of its δ "
        f"{float(own[0]):.7g}, plain total {float(t_ref[0]):.7g}; call "
        f"{ms:.4f} ms (device {dev_ms} ms, {per_call} device kernels a call, "
        f"queued {q_ms:.4f} ms; {2 * c * kc * d / dev_ms / 1e9:.2f} TFLOP/s), "
        f"plain {plain:.1f} ms, bound {b_ms:.6f} ms ({b_by})")
    one_kernel_a_call({"phase": f"wide-{name}", "device_kernels": kernels},
                      "bright_glm_wide_kernel")
    del x, xi, theta, delta, d_ref
    torch.cuda.empty_cache()
    return {"phase": name, "N": n, "D": d, "Kc": kc, "C": c,
            "max_abs_err": err, "ms": dev_ms, "call_ms": ms,
            "kernels_per_call": per_call, "queued_ms": q_ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by}


def wide_kernel_phases(dev):
    """The wide ``bright_glm`` kernel at the lastlayer run's shape and at
    the reduced twin's."""
    from repro_torch.configs import get_config, get_reduced

    n = LL_BATCH * (LL_SEQ - 1)
    cap = max(64, n // 4)  # the example's bright capacity
    full, twin = get_config(LL_ARCH), get_reduced(LL_ARCH)
    return [
        wide_bright_phase("lm-head", n, full.d_model, full.padded_vocab(),
                          cap, dev),
        wide_bright_phase("twin", n, twin.d_model, twin.padded_vocab(), cap,
                          dev),
    ]


class _StatsTrace:
    """A collector of the per-iteration StepStats alone: the default trace
    would also keep every θ sample, 1.58 GB each at the LM head."""

    def init(self, num_samples, position, stats):
        from repro_torch.core.flymc import StepStats

        return StepStats(*(a.new_zeros((a.shape[0], num_samples))
                           for a in stats)), [0]

    def update(self, carry, position, stats):
        bufs, n = carry
        for b, a in zip(bufs, stats):
            b[:, n[0]] = a
        n[0] += 1
        return carry

    def finalize(self, carry):
        return carry[0]


def lastlayer_path(dev):
    """FlyMC over llama3.2-3b's head at full width and depth: the
    backbone's f32 features of ``LL_BATCH × LL_SEQ`` random tokens
    (``lastlayer_glm``), the backbone freed, ``map_estimate`` and
    ``map_tuned``, then ``api.firefly(kernel="mala", backend="pallas",
    z_backend="fused")`` with the reference example's q_db and capacity
    for ``LL_ITERS`` iterations from θ_MAP moved off the tangency, at a
    step sized to the head (see ``LL_GAP``). Prints ms/iter, queries/iter,
    the mean bright count against N, the accept rate and both kernels'
    launches; checks the launches against the steps and inits (every
    ``bright_glm`` launch the wide kernel's, three a step), that some datum
    was bright, some proposal accepted and θ moved, finite θ, and both
    kernels against their plain versions on the final state (δ to
    ``LL_CLOSE``, the bright total to the plain total). Returns (launches,
    max|δ − δ_plain|)."""
    from repro_torch import api
    from repro_torch import random as jr
    from repro_torch.configs import get_config
    from repro_torch.kernels.bright_glm import ops as bops
    from repro_torch.models import transformer as T
    from repro_torch.models.lastlayer import lastlayer_glm

    cfg = get_config(LL_ARCH)
    t0 = time.perf_counter()
    lm = T.init_model(cfg, 0, dev, torch.float32)
    n_params = sum(p.numel() for p in lm.parameters())
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (LL_BATCH, LL_SEQ),
                           generator=gen, device=dev)
    model = lastlayer_glm(lm, tokens, prior_scale=LL_PRIOR)
    del lm
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t_feat = time.perf_counter() - t0
    n, d = model.data.x.shape
    if not bool(torch.isfinite(model.data.x).all()):
        raise AssertionError("lastlayer: non-finite backbone features")
    t0 = time.perf_counter()
    theta_map = model.map_estimate(jr.key(2), steps=LL_MAP_STEPS, lr=0.05)
    tuned = model.map_tuned(theta_map)
    del model
    torch.cuda.synchronize()
    t_map = time.perf_counter() - t0
    x2 = float(tuned.data.x.square().sum(1).mean())
    eps0 = math.sqrt(4 * LL_GAP / (tuned.theta_shape[0] * x2))
    theta0 = theta_map + eps0 * jr.normal(jr.key(5), theta_map.shape)
    cap = max(64, n // 4)
    alg = api.firefly(tuned, kernel="mala", capacity=cap, cand_capacity=cap,
                      q_db=LL_Q, step_size=LL_STEP_OF_EPS * eps0,
                      adapt_target="auto", backend="pallas", z_backend="fused")
    _reset_launches()
    wide0 = bops.wide_launch_count
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = api.sample(alg, jr.key(3), LL_ITERS, init_position=theta0,
                    collectors={"stats": _StatsTrace()})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    wide = bops.wide_launch_count - wide0
    # MALA: the θ-update, the candidates and the gradient's refresh after
    # the z-move, each one launch a step
    want = {"bright_glm": 3 * tr.steps_run + tr.inits_run,
            "z_update": tr.steps_run}
    if launches != want or wide != launches["bright_glm"]:
        raise AssertionError(f"lastlayer launches {launches} (wide {wide}); "
                             f"expected {want}, all wide")
    fs = tr.final_state
    if not (bool(torch.isfinite(fs.sampler.theta).all())
            and bool(torch.isfinite(fs.sampler.lp).all())):
        raise AssertionError("lastlayer: non-finite θ or log density")
    st = tr.results["stats"]
    q = float(st.lik_queries.double().mean())
    bright = float(st.n_bright.double().mean())
    acc = float(st.accept_prob.double().mean())
    moved = float((fs.sampler.theta[0] != theta0).double().mean())
    if not (bright > 0 and acc > 0 and moved > 0):
        raise AssertionError(f"lastlayer: the chain did no FlyMC work: mean "
                             f"bright {bright}, accept {acc}, moved {moved}")
    peak = torch.cuda.max_memory_allocated(dev)
    err = robust_kernels_held(tr.algorithm.spec, tuned.data, tuned.stats, fs,
                              jr.key(4), family="softmax",
                              label="lastlayer path", close=LL_CLOSE)
    log(f"lastlayer path [{LL_ARCH} full width, {n_params / 1e9:.3f} B "
        f"params, f32 features of {LL_BATCH}×{LL_SEQ - 1} = {n} tokens, "
        f"head θ {tuple(tuned.theta_shape)}; MALA, one chain, {LL_ITERS} "
        f"iterations from θ_MAP + {eps0:.3g}·noise (mean |x|² {x2:.1f}) at "
        f"step {LL_STEP_OF_EPS * eps0:.3g}]: features {t_feat:.1f} s, MAP ({LL_MAP_STEPS} Adam "
        f"steps) + tuning {t_map:.1f} s; {wall * 1e3 / LL_ITERS:.1f} ms/iter "
        f"({tr.steps_run} steps incl. re-runs, {tr.inits_run} inits, "
        f"capacity {tr.algorithm.spec.capacity}); queries/iter {q:.1f} vs "
        f"N = {n}; mean bright tokens {bright:.1f} of {n}; accept "
        f"{acc:.3f}, share of θ moved {moved:.3g}; launches {launches} (wide "
        f"{wide}); peak memory {peak / 2**30:.2f} GiB")
    del tr, tuned, theta_map, theta0, alg, fs
    torch.cuda.empty_cache()
    return {**launches, "bright_glm_wide": wide}, err


def dense_serve_path(dev):
    """The dense decoders through ``launch.serve.serve`` at their published
    widths in bf16 (qwen1.5-110b cut to 2 layers): prefill and greedy
    decode; one ``decode_attention`` launch a layer a decode step; the
    kernel held against its plain version at each config's (G, D, W).
    Returns ({arch: launches}, decode_attention phases)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as aops
    from repro_torch.launch.serve import serve

    launches, phases = {}, []
    gen = torch.Generator().manual_seed(23)
    seq = DENSE_PROMPT + DENSE_GEN
    steps = DENSE_GEN - 1
    for arch, n_layers in DENSE_ARCHS:
        cfg = get_config(arch)
        layers = n_layers or cfg.n_layers
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        aops.launch_count = 0
        ids, stats = serve(arch, batch=DENSE_BATCH, prompt_len=DENSE_PROMPT,
                           gen=DENSE_GEN, seed=0, full=True,
                           dtype=torch.bfloat16, device=dev,
                           n_layers=n_layers)
        wall = time.perf_counter() - t0
        launches[arch] = aops.launch_count
        if aops.launch_count != layers * steps:
            raise AssertionError(f"{arch}: {aops.launch_count} decode_attention"
                                 f" launches, want {layers * steps}")
        if ids.shape != (DENSE_BATCH, DENSE_GEN) or not bool(
                ((ids >= 0) & (ids < cfg.vocab_size)).all()):
            raise AssertionError(f"{arch}: bad generated ids")
        peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.empty_cache()
        g = cfg.n_heads // cfg.n_kv_heads
        ph = decode_attention_phase(
            arch, DENSE_BATCH, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, seq, seq - 2, None, torch.bfloat16, dev,
            gen)
        phases.append(ph)
        log(f"dense serve [{arch}, {layers} of {cfg.n_layers} layers, "
            f"d_model {cfg.d_model}, G = {g}, D = {cfg.resolved_head_dim}, "
            f"bf16, batch {DENSE_BATCH}, prompt {DENSE_PROMPT}, {DENSE_GEN} "
            f"greedy tokens]: prefill {stats['prefill_s'] * 1e3:.3f} ms, "
            f"decode {stats['decode_s'] * 1e3 / steps:.3f} ms/token, "
            f"{stats['tok_per_s']:.1f} tok/s, peak memory "
            f"{peak / 2**30:.2f} GiB, {wall:.1f} s with the init; "
            f"decode_attention {launches[arch] // steps} launches a step; "
            f"first tokens {ids[0].tolist()}")
    return launches, phases


def decode_read_bytes(cfg, layers: int, batch: int, ring: int,
                      itemsize: int = 2) -> int:
    """Bytes one decode step must read at least: every weight of the
    decoder's blocks (an MoE's every expert, as the capacity dispatch runs
    all E of them), the final norm and the head, ``batch`` rows of the
    embedding table, and each layer's ring (``ring`` valid slots of K and
    V) and cross-attention K/V (whisper's encoder runs in prefill only)."""
    import dataclasses

    from repro_torch.models import transformer as T

    meta = T.LM(dataclasses.replace(cfg, n_layers=layers), "meta",
                torch.bfloat16)
    weights = sum(p.numel() for m in (meta.blocks, meta.final_norm)
                  for p in m.parameters())
    weights += meta.embed.head.numel() + batch * cfg.d_model
    kv = 2 * batch * cfg.n_kv_heads * cfg.resolved_head_dim
    cross = cfg.encoder_seq if cfg.family == "encdec" else 0
    return (weights + layers * kv * (ring + cross)) * itemsize


def family_serve_path(dev):
    """The MoE, encoder-decoder and VLM families through
    ``launch.serve.serve`` at their published widths in bf16
    (``FAMILY_ARCHS``: mixtral-8x7b cut to 20 layers, arctic-480b to 2):
    prefill and greedy decode; ``decode_attention`` launched once a layer
    a decode step, twice for whisper (its cross-attention); the ids in
    range. Prints prefill ms, decode ms/token beside the step's byte bound,
    tok/s, peak memory and the prefill's MoE ``drop_frac`` (the mean over
    layers), then holds the kernel against its plain version at each new
    (G, D, W, window): mixtral's wrapped, windowed ring, arctic's G = 7,
    whisper's self-attention and its cross-attention over the 1,504
    encoder positions (t = 10^9), llava's ring. Returns ({arch:
    launches}, decode_attention phases)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as aops
    from repro_torch.launch.serve import serve
    from repro_torch.models.serving import CROSS_T

    launches, phases = {}, []
    gen = torch.Generator().manual_seed(24)
    steps = FAMILY_GEN - 1
    bf16 = torch.bfloat16
    for arch, n_layers, prompt in FAMILY_ARCHS:
        cfg = get_config(arch)
        layers = n_layers or cfg.n_layers
        cross = cfg.family == "encdec"
        seq = prompt + FAMILY_GEN
        ring = min(cfg.swa_window or seq, seq)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        aops.launch_count = 0
        ids, stats = serve(arch, batch=FAMILY_BATCH, prompt_len=prompt,
                           gen=FAMILY_GEN, seed=0, full=True, dtype=bf16,
                           device=dev, n_layers=n_layers)
        wall = time.perf_counter() - t0
        launches[arch] = aops.launch_count
        want = (1 + cross) * layers * steps
        if aops.launch_count != want:
            raise AssertionError(f"{arch}: {aops.launch_count} decode_attention"
                                 f" launches, want {want}")
        if ids.shape != (FAMILY_BATCH, FAMILY_GEN) or not bool(
                ((ids >= 0) & (ids < cfg.vocab_size)).all()):
            raise AssertionError(f"{arch}: bad generated ids")
        peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.empty_cache()
        read = decode_read_bytes(cfg, layers, FAMILY_BATCH, ring)
        tok_ms = stats["decode_s"] * 1e3 / steps
        drop = (f", prefill MoE drop_frac {stats['drop_frac']:.6f}"
                if "drop_frac" in stats else "")
        log(f"family serve [{arch}, {layers} of {cfg.n_layers} layers, "
            f"d_model {cfg.d_model}, G = {cfg.n_heads // cfg.n_kv_heads}, "
            f"D = {cfg.resolved_head_dim}, bf16, batch {FAMILY_BATCH}, "
            f"prompt {prompt}, {FAMILY_GEN} greedy tokens]: prefill "
            f"{stats['prefill_s'] * 1e3:.3f} ms, decode {tok_ms:.3f} "
            f"ms/token (bound {read / HBM_BYTES_PER_S * 1e3:.3f} ms: "
            f"{read / 1e9:.3f} GB a step), {stats['tok_per_s']:.1f} tok/s, "
            f"peak memory {peak / 2**30:.2f} GiB{drop}, {wall:.1f} s with "
            f"the init; decode_attention {launches[arch] // steps} launches "
            f"a step; first tokens {ids[0].tolist()}")
        h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        t = seq - 2
        phases.append(decode_attention_phase(
            f"{arch}{'-wrapped' if cfg.swa_window else ''}", FAMILY_BATCH, h,
            hk, d, ring, t, cfg.swa_window, bf16, dev, gen))
        if cross:
            w = cfg.encoder_seq
            phases.append(decode_attention_phase(
                f"{arch}-cross", FAMILY_BATCH, h, hk, d, w, CROSS_T, None,
                bf16, dev, gen, pos=torch.arange(w, dtype=torch.int32)))
    return launches, phases


# ---------------------------------------------------------------------------
# The sharded train step (torch.distributed ranks on the one card)
# ---------------------------------------------------------------------------


def _sharded_cfg(layers: int):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(SHARDED_ARCH), n_layers=layers)


def _sharded_batch(cfg):
    """The global batch: SHARDED_BATCH × SHARDED_SEQ token ids and labels
    from a seeded CPU generator, as numpy (the ranks take them so)."""
    gen = torch.Generator().manual_seed(SHARDED_SEED)
    shape = (SHARDED_BATCH, SHARDED_SEQ)
    return {k: torch.randint(0, cfg.vocab_size, shape, generator=gen).numpy()
            for k in ("tokens", "labels")}


def _leaf_digest(t, spec, par):
    """A position-weighted sum of the bits of the logical tensor that
    ``t`` is this rank's shard of (int64, wrapping; replicas counted
    once): the same for one logical tensor however it is sharded, and
    another for any other tensor with all but vanishing probability. One
    SUM all-reduce a leaf on a mesh."""
    from repro_torch.distributed import comm
    from repro_torch.distributed.par import shard_index

    ints = {4: torch.int32, 2: torch.int16}[t.element_size()]
    bits = t.detach().contiguous().view(ints).to(torch.int64)
    idx = torch.zeros((), dtype=torch.int64, device=t.device)
    stride = 1
    sharded = par is not None and par.mesh is not None
    starts = [s.start or 0 for s in shard_index(spec, par)] if sharded else [
        0] * t.dim()
    for dim in reversed(range(t.dim())):
        ar = torch.arange(t.shape[dim], device=t.device) + starts[dim]
        idx = idx + (ar * stride).view([-1] + [1] * (t.dim() - 1 - dim))
        stride *= spec.shape[dim]
    part = (bits * (idx % 1000003 + 1)).sum().view(1)
    if par is None or par.mesh is None:
        return int(part)
    if spec.sync and par.mesh.index(spec.sync):
        part = torch.zeros_like(part)  # a replica: counted on one rank
    return int(comm.all_reduce_sum(part, par.mesh.group(par.mesh.axis_names)))


def _state_digests(model, opt):
    """{name: (weight, m, v) digests} of a model's and its AdamW state's
    logical tensors (collective on a mesh)."""
    par = model.par if model.par.mesh is not None else None
    return {n: tuple(_leaf_digest(t, model.specs[n], par)
                     for t in (p, opt.m[n], opt.v[n]))
            for n, p in model.named_parameters()}


def _timed_steps(step, model, opt, batch, steps, err=None):
    """``steps`` steps: per step the metrics (host floats), the host ms
    (ending in a synchronize), the collectives by kind and the
    ``fused_ce`` launches."""
    from repro_torch.distributed import comm
    from repro_torch.kernels.fused_ce import ops as cops

    out = []
    for _ in range(steps):
        comm.reset_counts()
        ce0 = cops.launch_count
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(model, opt, batch) if err is None else step(model, opt,
                                                              batch, err)
        m = {k: float(v) for k, v in m.items()}
        torch.cuda.synchronize()
        out.append({**m, "ms": (time.perf_counter() - t0) * 1e3,
                    "collectives": comm.tally(),
                    "fused_ce": cops.launch_count - ce0})
    return out


def _sharded_rank(group, job):
    """One rank of the (2, 2) run: SHARDED_STEPS steps from the seed,
    the state saved after SHARDED_SAVE_AT; a model of another seed
    restored from that save and stepped to the end; then the save
    restored onto (1, 2) by ranks 0 and 1, and (4 ranks on (pod=2, data=1,
    model=2)) COMPRESS_LAYERS layers exact and with compress_axes=("pod",).
    Returns host values: each run's steps, digests, peak memory."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch.mesh import make_mesh, make_par
    from repro_torch.launch.steps import make_sharded_train_step
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import AdamWState
    from repro_torch.optim.compression import init_error_state

    dev = torch.device(job["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    shape = ShapeConfig("sharded", SHARDED_SEQ, SHARDED_BATCH, "train")
    batch = {k: torch.as_tensor(v, device=dev) for k, v in job["batch"].items()}
    cfg = _sharded_cfg(SHARDED_LAYERS)
    mesh = make_mesh((2, 2), ("data", "model"))
    step, specs, build = make_sharded_train_step(
        cfg, mesh, shape, torch.bfloat16, remat=True, **SHARDED_KW)
    shardings = {"params": specs, "opt": AdamWState(None, specs, specs)}
    out = {"rank": mesh.rank}
    start = time.perf_counter()

    def stage(what):  # rank 0's progress, for a run cut by its time limit
        if mesh.rank == 0:
            log(f"  sharded rank 0: {what} at {time.perf_counter() - start:.1f} s")

    torch.cuda.reset_peak_memory_stats(dev)
    model, opt = build(SHARDED_SEED, dev)
    stage("built")
    ck = Checkpointer(job["ckpt"])
    first = _timed_steps(step, model, opt, batch, SHARDED_SAVE_AT)
    out["saved"] = _state_digests(model, opt)
    t0 = time.perf_counter()
    ck.save(SHARDED_SAVE_AT, {"params": dict(model.named_parameters()),
                              "opt": opt}, shardings=shardings, mesh=mesh,
            blocking=True)
    out["save_s"] = time.perf_counter() - t0
    stage(f"steps 1-{SHARDED_SAVE_AT} ({[round(s['ms'], 1) for s in first]} "
          f"ms) and the save ({out['save_s']:.1f} s)")
    rest = _timed_steps(step, model, opt, batch,
                        SHARDED_STEPS - SHARDED_SAVE_AT)
    out.update(steps=first + rest, final=_state_digests(model, opt),
               peak=torch.cuda.max_memory_allocated(dev))
    del model, opt
    torch.cuda.empty_cache()

    # (c) a model of another seed, restored from the save, to the end
    model, opt = build(SHARDED_SEED + 1, dev)
    t0 = time.perf_counter()
    restored, _ = ck.restore({"params": dict(model.named_parameters()),
                              "opt": opt}, step=SHARDED_SAVE_AT,
                             shardings=shardings, mesh=mesh, verify=False)
    out["restore_s"] = time.perf_counter() - t0
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(restored["params"][n])
    opt = restored["opt"]
    del restored
    out["restored"] = _state_digests(model, opt)
    out["resumed"] = _timed_steps(step, model, opt, batch,
                                  SHARDED_STEPS - SHARDED_SAVE_AT)
    out["resumed_final"] = _state_digests(model, opt)
    del model, opt
    torch.cuda.empty_cache()
    stage(f"steps {SHARDED_SAVE_AT + 1}-{SHARDED_STEPS} "
          f"({[round(s['ms'], 1) for s in rest]} ms), the (2, 2) restore "
          f"({out['restore_s']:.1f} s) and its steps")

    # (c) the save onto (1, 2): ranks 0 and 1
    half = make_mesh((1, 2), ("data", "model"))
    if half.rank is not None:
        m2 = T.LM(cfg, dev, torch.float32, make_par(half))
        o2 = T.init_opt(m2)
        shard2 = {"params": m2.specs, "opt": AdamWState(None, m2.specs,
                                                        m2.specs)}
        restored, _ = ck.restore({"params": dict(m2.named_parameters()),
                                  "opt": o2}, step=SHARDED_SAVE_AT,
                                 shardings=shard2, mesh=half, verify=False)
        with torch.no_grad():
            for n, p in m2.named_parameters():
                p.copy_(restored["params"][n])
        out["half"] = _state_digests(m2, restored["opt"])
        del m2, o2, restored
        torch.cuda.empty_cache()
    stage("the (1, 2) restore")

    # (d) the pod axis: exact, then compressed
    pod = make_mesh((2, 1, 2), ("pod", "data", "model"))
    small = _sharded_cfg(COMPRESS_LAYERS)
    for comp in ((), ("pod",)):
        step, _, build = make_sharded_train_step(
            small, pod, shape, torch.bfloat16, remat=True,
            compress_axes=comp, **COMPRESS_KW)
        model, opt = build(SHARDED_SEED, dev)
        err = (init_error_state(dict(model.named_parameters()))
               if comp else None)
        run = _timed_steps(step, model, opt, batch, COMPRESS_STEPS, err)
        out["pod" if not comp else "pod_compressed"] = run
        del model, opt, err
        torch.cuda.empty_cache()
        stage(f"pod mesh, compress_axes={comp}: losses "
              f"{[s['loss'] for s in run]}, ms {[round(s['ms'], 1) for s in run]}")
    return out


def fused_ce_shard_phase(dev, cfg=None, t=None, name="vocab-shard"):
    """``fused_ce`` at a vocabulary shard, the sharded step's call: by
    default T = SHARDED_BATCH × SHARDED_SEQ rows (mesh (1, 2)'s), D = 3,072,
    V/2 = 64,128 columns of llama3.2-3b's head (else ``cfg``'s head halved,
    ``t`` rows), bf16 in the path's rounding mode.
    Both shards against their plain version (labels shifted into each
    block; a label of the other block gives a target of exactly 0), and
    the two shards' merged (lse, target), M + log Σ exp(lse_r − M) and
    Σ target_r, against the kernel over the whole head to 1e-4 (float32
    sums grouped another way). Times shard 0 as :func:`fused_ce_phase`
    does; the library yardstick is ``F.cross_entropy(x @ w_shard)``."""
    import torch.nn.functional as F

    from repro_torch.kernels.fused_ce import ops
    from repro_torch.kernels.fused_ce.ref import fused_ce_ref

    cfg = cfg or _sharded_cfg(1)
    t = t or SHARDED_BATCH * SHARDED_SEQ
    d, v = cfg.d_model, cfg.padded_vocab()
    vb = v // 2
    gen = torch.Generator(device=dev).manual_seed(28)
    x = torch.randn(t, d, generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn(d, v, generator=gen, device=dev)
         / d**0.5).to(torch.bfloat16)
    lab = torch.randint(0, v, (t,), generator=gen, device=dev)
    edge = [0, vb - 1, vb, v - 1]
    lab[:len(edge)] = torch.tensor(edge, device=dev)
    parts, err, flipped = [], 0.0, 0.0
    for r in range(2):
        ws = w[:, r * vb:(r + 1) * vb].contiguous()
        ls = lab - r * vb
        lse, tgt = ops.lse_and_target(x, ws, ls, True)
        lse_ref, tgt_ref = fused_ce_ref(x, ws, ls, True)
        torch.cuda.synchronize()
        out = (ls < 0) | (ls >= vb)
        if not (bool(out.any()) and bool((tgt[out] == 0).all())
                and bool(torch.isfinite(lse).all())):
            raise AssertionError("fused_ce shard: a label of the other "
                                 "block gave a target other than 0")
        flipped = max(flipped, _check_rounded(f"shard {r}", lse, lse_ref),
                      _check_rounded(f"shard {r}", tgt, tgt_ref))
        err = max(err, float((lse - lse_ref).abs().max()),
                  float((tgt - tgt_ref).abs().max()))
        parts.append((lse, tgt))
        if r == 0:
            w0, l0 = ws, ls
        else:
            del ws
    m = torch.maximum(parts[0][0], parts[1][0])
    lse = m + torch.log(torch.exp(parts[0][0] - m) + torch.exp(parts[1][0] - m))
    tgt = parts[0][1] + parts[1][1]
    lse_w, tgt_w = ops.lse_and_target(x, w, lab, True)
    merge_err = max(float((lse - lse_w).abs().max()),
                    float((tgt - tgt_w).abs().max()))
    if merge_err > 1e-4:
        raise AssertionError(f"fused_ce shards' merge vs the whole head: "
                             f"max|Δ| {merge_err:.3g}")
    del w, parts, lse_w, tgt_w
    call = lambda: ops.lse_and_target(x, w0, l0, True)
    dev_ms = device_ms(call, ("ce_wgmma_kernel", "ce_merge_kernel"), reps=3)
    ms = median_ms(call, reps=3, warm=1)
    plain = median_ms(lambda: fused_ce_ref(x, w0, l0, True), reps=3, warm=1)
    lib_lab = lab % vb
    lib_ms = median_ms(lambda: F.cross_entropy(x @ w0, lib_lab,
                                               reduction="none"),
                       reps=5, warm=1)
    b_ms, b_by = bound(t * d * 2 + d * vb * 2 + t * 8 + t * 8,
                       2.0 * t * d * vb, BF16_FLOP_PER_S)
    log(f"fused_ce[{name}: T={t} D={d} V/2={vb} bf16, bf16 logits] max|Δ| vs "
        f"plain {err:.3g} ({flipped:.2g} of the tokens beyond 1e-4), merged "
        f"shards vs the whole head max|Δ| {merge_err:.3g}; call {ms:.4f} ms "
        f"(device {dev_ms:.6f} ms, {2.0 * t * d * vb / dev_ms / 1e9:.1f} "
        f"TFLOP/s), plain {plain:.4f} ms, library (x@w + cross_entropy) "
        f"{lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}); {card_line()}")
    del x, w0
    torch.cuda.empty_cache()
    return {"phase": name, "T": t, "D": d, "V": vb,
            "dtype": "bfloat16", "round_logits": True,
            "max_abs_err": max(err, merge_err), "merge_max_abs_err": merge_err,
            "ms": dev_ms, "call_ms": ms, "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}


def sharded_train_path(dev):
    """The sharded train step (``launch.steps.make_sharded_train_step``)
    of llama3.2-3b at full width cut to SHARDED_LAYERS layers, bf16
    compute, f32 master weights and moments, remat, SHARDED_BATCH ×
    SHARDED_SEQ tokens, seed SHARDED_SEED:

    (a) the single-device step, then one NCCL rank on mesh (1, 1), 2
        steps each: loss and grad_norm bitwise, and every weight and
        moment by :func:`_leaf_digest`;
    (b) 4 gloo ranks over CUDA tensors on the card, mesh (data=2,
        model=2), SHARDED_STEPS steps: step 1's loss within 2e-3 of (a)'s
        and its grad_norm within 1e-2; finite losses; the ranks agree;
        one ``fused_ce`` launch a step a rank; step ms, peak memory a
        rank, the collectives a step by kind with their bytes;
    (c) (b)'s state saved after step SHARDED_SAVE_AT (logical arrays, rank
        0 writes) and restored onto (2, 2), (1, 2) and one device: every
        logical leaf's digest equal to the saved state's, and the (2, 2)
        restore's last steps bitwise (b)'s (metrics and final state);
    (d) mesh (pod=2, data=1, model=2) at COMPRESS_LAYERS layers,
        COMPRESS_STEPS steps exact and with compress_axes=("pod",): both
        descend, and the compressed losses are within 5% of the exact
        ones and within a tenth of the exact run's descent;
    (e) :func:`fused_ce_shard_phase`.

    Returns (fused_ce launches by run, the kernel phase)."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.distributed.launch import run_ranks, single_rank
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_sharded_train_step
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import AdamWState

    card = card_line()
    cfg = _sharded_cfg(SHARDED_LAYERS)
    batch_np = _sharded_batch(cfg)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch_np.items()}
    shape = ShapeConfig("sharded", SHARDED_SEQ, SHARDED_BATCH, "train")
    launches = {}

    # (a) one device, then one NCCL rank on (1, 1)
    torch.cuda.empty_cache()
    model = T.init_model(cfg, SHARDED_SEED, dev)
    model.requires_grad_(True)
    opt = T.init_opt(model)
    step = T.make_train_step(cfg, torch.bfloat16, remat=True, **SHARDED_KW)
    single = _timed_steps(step, model, opt, batch, 2)
    want = _state_digests(model, opt)
    n_params = sum(p.numel() for p in model.parameters())
    del model, opt
    torch.cuda.empty_cache()
    with single_rank("nccl" if dev.type == "cuda" else "gloo", dev.type):
        mesh = make_mesh((1, 1), ("data", "model"))
        step, _, build = make_sharded_train_step(
            cfg, mesh, shape, torch.bfloat16, remat=True, **SHARDED_KW)
        model, opt = build(SHARDED_SEED, dev)
        one = _timed_steps(step, model, opt, batch, 2)
        same = _state_digests(model, opt) == want
        del model, opt
    torch.cuda.empty_cache()
    keys = ("loss", "grad_norm")
    if not same or any(a[k] != b[k] for a, b in zip(single, one)
                       for k in keys):
        raise AssertionError(f"(a) mesh (1, 1) is not bitwise the single-"
                             f"device step: weights equal {same}, "
                             f"{[(a['loss'], b['loss'], a['grad_norm'], b['grad_norm']) for a, b in zip(single, one)]}")
    launches["sharded_one_rank"] = sum(s["fused_ce"] for s in one)

    # (b), (c), (d) on 4 ranks
    ckpt = ROOT / "build" / "sharded_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        outs = run_ranks(_sharded_rank, 4, backend="gloo", device=dev.type,
                         args=(dict(batch=batch_np, ckpt=str(ckpt),
                                    device=dev.type),),
                         timeout_s=SHARDED_TIMEOUT_S)
        ranks_s = time.perf_counter() - t0
        # (c) the save onto one device
        model = T.LM(cfg, dev)
        opt = T.init_opt(model)
        t1 = time.perf_counter()
        restored, _ = Checkpointer(ckpt).restore(
            {"params": dict(model.named_parameters()), "opt": opt},
            step=SHARDED_SAVE_AT, verify=False)
        one_restore_s = time.perf_counter() - t1
        ckpt_gb = _dir_bytes(ckpt / f"step_{SHARDED_SAVE_AT:08d}") / 1e9
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(restored["params"][n])
        whole = _state_digests(model, restored["opt"])
        del model, opt, restored
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()

    r0 = outs[0]
    for o in outs[1:]:
        for k in ("steps", "resumed", "pod", "pod_compressed"):
            if [s["loss"] for s in o[k]] != [s["loss"] for s in r0[k]]:
                raise AssertionError(f"(b) the ranks' {k} losses differ")
    steps_b = r0["steps"]
    losses = [s["loss"] for s in steps_b]
    gap = abs(steps_b[0]["loss"] / single[0]["loss"] - 1)
    ggap = abs(steps_b[0]["grad_norm"] / single[0]["grad_norm"] - 1)
    ce_a_step = {s["fused_ce"] for o in outs for s in o["steps"]}
    if not (np.all(np.isfinite(losses)) and gap <= 2e-3 and ggap <= 1e-2
            and ce_a_step == {1}):
        raise AssertionError(f"(b): losses {losses}, step-1 gap to (a) "
                             f"{gap:.3g} (limit 2e-3), grad_norm gap "
                             f"{ggap:.3g} (limit 1e-2), fused_ce a step "
                             f"{ce_a_step}")
    bad = [n for n in r0["saved"] if not (
        r0["restored"][n] == r0["saved"][n] == whole[n]
        and outs[0]["half"][n] == r0["saved"][n])]
    resumed_same = (
        [(s["loss"], s["grad_norm"]) for s in r0["resumed"]]
        == [(s["loss"], s["grad_norm"]) for s in steps_b[SHARDED_SAVE_AT:]]
        and r0["resumed_final"] == r0["final"])
    if bad or not resumed_same:
        raise AssertionError(f"(c): leaves not restored bitwise {bad[:4]}; "
                             f"resumed steps bitwise {resumed_same}")
    exact = [s["loss"] for s in r0["pod"]]
    comp = [s["loss"] for s in r0["pod_compressed"]]
    comp_gap = max(abs(c / e - 1) for c, e in zip(comp, exact))
    # the exact run's descent, and the largest gap as a share of it: a
    # compressed run whose pod gradient is lost stays near its first loss
    # (share ~1) while 5% of the loss can exceed the whole descent
    drop = exact[0] - exact[-1]
    drop_share = max(abs(c - e) for c, e in zip(comp, exact)) / drop
    if not (np.all(np.isfinite(exact + comp)) and comp_gap <= 0.05
            and comp[-1] < comp[0] and drop > 0 and drop_share <= 0.1):
        raise AssertionError(f"(d): compressed {comp} vs exact {exact}: "
                             f"gap {comp_gap:.3g} (limit 0.05), "
                             f"{drop_share:.3g} of the exact descent "
                             f"{drop:.6g} (limit 0.1)")
    launches["sharded_rank0"] = sum(s["fused_ce"] for s in steps_b)
    launches["sharded_resumed_rank0"] = sum(s["fused_ce"]
                                            for s in r0["resumed"])

    step_ms = statistics.median(s["ms"] for s in steps_b[1:])
    coll = steps_b[-1]["collectives"]
    tokens = SHARDED_BATCH * SHARDED_SEQ
    state_gb = n_params * 16 / 1e9
    log(f"sharded train [{SHARDED_ARCH} full width, {SHARDED_LAYERS} of "
        f"{get_config(SHARDED_ARCH).n_layers} layers, {n_params / 1e9:.3f} B "
        f"params, remat, bf16 compute, f32 master and moments, batch "
        f"{SHARDED_BATCH} x {SHARDED_SEQ} tokens, seed {SHARDED_SEED}; "
        f"{card}]: (a) one device and 1 NCCL rank on (1, 1) bitwise over 2 "
        f"steps: loss {[round(s['loss'], 6) for s in single]}, grad_norm "
        f"{[round(s['grad_norm'], 6) for s in single]}, step ms one device "
        f"{[round(s['ms'], 3) for s in single]}, NCCL "
        f"{[round(s['ms'], 3) for s in one]} | (b) 4 gloo ranks over CUDA "
        f"tensors on one card, mesh (data=2, model=2), {SHARDED_STEPS} steps: "
        f"loss {[round(x, 6) for x in losses]} (step 1 vs (a): {gap:.3g}), "
        f"grad_norm {[round(s['grad_norm'], 6) for s in steps_b]} (step 1 vs "
        f"(a): {ggap:.3g}), step ms {[round(s['ms'], 1) for s in steps_b]} "
        f"(median of steps 2-{SHARDED_STEPS}: {step_ms:.1f} ms, "
        f"{tokens / step_ms * 1e3:.1f} tokens/s), peak memory a rank "
        f"{[round(o['peak'] / 1e9, 2) for o in outs]} GB (training state "
        f"{state_gb:.2f} GB summed over the ranks), collectives a step rank 0 "
        f"{coll}, fused_ce launches a step a rank {sorted(ce_a_step)} | (c) "
        f"saved after step {SHARDED_SAVE_AT} ({ckpt_gb:.2f} GB, "
        f"{r0['save_s']:.1f} s), restored onto (2, 2) in "
        f"{max(o['restore_s'] for o in outs):.1f} s, onto (1, 2) and one "
        f"device ({one_restore_s:.1f} s): every leaf's digest equal; steps "
        f"{SHARDED_SAVE_AT + 1}-{SHARDED_STEPS} resumed bitwise | (d) mesh "
        f"(pod=2, data=1, model=2), {COMPRESS_LAYERS} layers, "
        f"{COMPRESS_STEPS} steps: exact {[round(x, 5) for x in exact]}, "
        f"compressed {[round(x, 5) for x in comp]} (max gap {comp_gap:.3g}; "
        f"exact descent {drop:.6f}, the gap {drop_share:.3g} of it), "
        f"step ms exact {[round(s['ms'], 1) for s in r0['pod']]}, compressed "
        f"{[round(s['ms'], 1) for s in r0['pod_compressed']]}, collectives "
        f"a compressed step {r0['pod_compressed'][-1]['collectives']} | "
        f"ranks' wall {ranks_s:.1f} s")
    phase = fused_ce_shard_phase(dev)
    return launches, phase


def _rel_gap(got, want) -> float:
    """max|got − want| over max|want| (float32)."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _clear_rows(logits, tol: float):
    """The rows of (B, 1, V) logits whose top-2 gap clears ``tol`` of the
    largest |logit|: there the greedy token is decided beyond the
    tolerance."""
    top = logits.float().topk(2, dim=-1).values[:, 0]
    return (top[:, 0] - top[:, 1]) > tol * float(logits.abs().max())


def _serve_tokens(cfg):
    """The prompts (SERVE_BATCH, SERVE_PROMPT) and the tp run's forced
    tokens (SERVE_BATCH, SERVE_TP_FORCED), from a seeded CPU generator."""
    gen = torch.Generator().manual_seed(SHARDED_SEED + 29)
    ids = torch.randint(0, cfg.vocab_size,
                        (SERVE_BATCH, SERVE_PROMPT + SERVE_TP_FORCED),
                        generator=gen)
    return ids[:, :SERVE_PROMPT], ids[:, SERVE_PROMPT:]


def _timed(fn):
    """(fn(), its host ms, ending in a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _decode_run(step, model, cache, feed, greedy: int = 0):
    """One decode step a token of ``feed`` (each (B, 1) on the device),
    then ``greedy`` steps each fed the last one's token: per step the
    logits and next tokens as ``step(model, cache, token)`` returns them,
    the host ms, the decode-attention launches and the collectives by
    kind."""
    from repro_torch.distributed import comm
    from repro_torch.kernels.decode_attention import ops as aops

    out = {"logits": [], "tokens": [], "ms": [], "launches": [],
           "collectives": []}
    feed = list(feed)
    for i in range(len(feed) + greedy):
        tok = feed[i] if i < len(feed) else out["tokens"][-1]
        comm.reset_counts()
        before = aops.launch_count
        (nxt, logits, cache), ms = _timed(lambda: step(model, cache, tok))
        out["launches"].append(aops.launch_count - before)
        out["collectives"].append(comm.tally())
        out["ms"].append(ms)
        out["logits"].append(logits)
        out["tokens"].append(nxt)
    return out, cache


def _one_device_serve(cfg, dev, prompt=None, forced=(), greedy=None,
                      param_dtype=torch.float32, seq=None, gen=None,
                      frontend=None, cross=None):
    """The single device: ``cfg``'s model of SHARDED_SEED (weights in
    ``param_dtype``, SERVE_DTYPE compute, bf16 ring of ``seq`` positions,
    by default SERVE_SEQ). With ``prompt`` (and ``frontend``: whisper's
    frames or llava's patches): its prefill, the first token (the argmax
    of the last row's logits) and ``gen`` (SERVE_GEN) steps from it,
    greedy; else ``forced``'s steps from an empty cache (whisper's
    ``ck``/``cv`` from ``cross``, a (ck, cv) a layer), then ``greedy``
    more."""
    from repro_torch.models import serving as SV
    from repro_torch.models import transformer as T

    dt, bf = SERVE_DTYPE, torch.bfloat16
    seq, gen = seq or SERVE_SEQ, gen or SERVE_GEN
    torch.cuda.reset_peak_memory_stats(dev)
    model = T.init_model(cfg, SHARDED_SEED, dev, param_dtype)
    step = lambda m, c, t: SV.decode_step(m, c, t, seq, dt)
    out = {}
    if prompt is not None:
        (cache, h), out["prefill_ms"] = _timed(
            lambda: SV.prefill(model, prompt, seq, dt, bf,
                               **(frontend or {})))
        out["hidden"] = h
        out["tok0"] = SV.vocab_parallel_argmax(
            (h[:, -1:] @ model.embed.head.to(dt)).float())
        if cfg.family == "encdec":
            out["cross"] = [(c["ck"].cpu(), c["cv"].cpu())
                            for c in cache["layers"]]
        forced, greedy = [out["tok0"]], gen - 1
    else:
        cache = SV.init_cache(cfg, forced[0].shape[0], seq, bf, dev)
        for c, (ck, cv) in zip(cache["layers"], cross or ()):
            c["ck"].copy_(ck)
            c["cv"].copy_(cv)
    run, cache = _decode_run(step, model, cache, forced, greedy)
    del model
    return out | run | {"cache": cache["layers"],
                        "peak": torch.cuda.max_memory_allocated(dev),
                        "ring_local": tuple(cache["layers"][0]["k"].shape)}


def _sharded_serve(job, dev, ref=None):
    """The port's sharded serving on mesh ``job["mesh"]`` (every rank calls
    it), of ``job["cfg"]`` (default llama3.2-3b at ``job["layers"]``
    layers) with a ring of ``job["seq"]`` (default SERVE_SEQ) positions.
    fsdp: the prefill of ``job["prompt"]`` (with ``job["frontend"]``'s
    frames or patches), the first token from the gathered hidden's last
    row, then a step for each token of ``job["feed"]``; tp:
    ``job["feed"]``'s steps from an empty cache (whisper's ``ck``/``cv``
    the rank's shards of ``job["cross"]``, a logical (ck, cv) a layer).
    Returns the logical hidden, first token, logits
    and tokens a step and final cache, with the times, launches,
    collectives and peak memory; with ``ref`` (the single device's run of
    the same weights) the gaps to it on mesh rank 0 instead of the
    tensors."""
    from repro_torch.distributed import par as P
    from repro_torch.launch.mesh import make_mesh, make_par
    from repro_torch.launch.steps import (make_sharded_decode,
                                          make_sharded_prefill)
    from repro_torch.models import serving as SV
    from repro_torch.models.config import ShapeConfig

    dt = SERVE_DTYPE
    cfg = job.get("cfg") or _sharded_cfg(job["layers"])
    seq = job.get("seq", SERVE_SEQ)
    mesh = make_mesh(*job["mesh"])
    par = make_par(mesh)
    step, specs, build = make_sharded_decode(
        cfg, mesh, ShapeConfig("decode", seq, SERVE_BATCH, "decode"),
        dt, job["layout"])
    torch.cuda.reset_peak_memory_stats(dev)
    (model, cache), build_ms = _timed(lambda: build(SHARDED_SEED, dev))
    out = {"rank": mesh.rank, "build_ms": build_ms}
    for c, sp, (ck, cv) in zip(cache["layers"], specs["cache"]["layers"],
                               job.get("cross") or ()):
        c["ck"].copy_(P.local_slice(ck, sp["ck"], par))
        c["cv"].copy_(P.local_slice(cv, sp["cv"], par))
    if job["layout"] == "fsdp":
        pstep, pspecs, _ = make_sharded_prefill(
            cfg, mesh, ShapeConfig("prefill", seq, SERVE_BATCH, "prefill"),
            dt)
        prompt = torch.as_tensor(job["prompt"], device=dev)
        front = {k: torch.as_tensor(v, device=dev)
                 for k, v in (job.get("frontend") or {}).items()}
        (cache, h), out["prefill_ms"] = _timed(
            lambda: pstep(model, prompt, **front))
        del front
        out["hidden"] = P.gather_logical(h, pspecs["out"], par)
        head = P.gather_param(model.embed.head, model.embed.specs["head"], dt,
                              par)
        out["tok0"] = SV.vocab_parallel_argmax(
            (out["hidden"][:, -1:] @ head).float(), par)
        del h, head
    run, cache = _decode_run(step, model, cache,
                             [torch.as_tensor(t, device=dev)
                              for t in job["feed"]])
    out.update(run, peak=torch.cuda.max_memory_allocated(dev),
               ring_local=tuple(cache["layers"][0]["k"].shape))
    out["logits"] = [P.gather_logical(x, specs["out"], par)
                     for x in run["logits"]]
    out["tokens"] = [P.gather_logical(x, specs["tokens"], par)
                     for x in run["tokens"]]
    layers = list(zip(cache["layers"], specs["cache"]["layers"]))
    out["cache"] = [{n: P.gather_logical(c[n], s[n], par) for n in c}
                    for c, s in (layers if ref is None else _ends(layers))]
    del model, cache
    torch.cuda.empty_cache()
    if ref is None:
        return out
    tensors = ("hidden", "tok0", "logits", "tokens", "cache")
    gaps = _serve_gaps(out, ref) if mesh.rank == 0 else {}
    return {k: v for k, v in out.items() if k not in tensors} | gaps


def _ends(layers: list) -> list:
    """The first and the last layer: the rings a 4-rank run gathers for
    its check (every layer's through gloo would move 1.9 GB at 28)."""
    return [layers[0], layers[-1]]


def _serve_gaps(got, ref) -> dict:
    """A sharded run's gaps to the single device's, as SERVE_TOL reads
    them: the hidden, each step's logits and the first and last layers'
    final K/V as max|Δ| over the reference's max; the ring positions and
    the first token equal; the greedy tokens of the rows whose reference
    top-2 gap clears SERVE_TOL (rows compared, rows equal)."""
    clear = [_clear_rows(b, SERVE_TOL) for b in ref["logits"]]
    gaps = {"logits": max(_rel_gap(a, b) for a, b in zip(got["logits"],
                                                         ref["logits"])),
            "tokens_compared": sum(int(c.sum()) for c in clear),
            "tokens_equal": sum(
                int((a.view(-1)[c] == b.view(-1)[c]).sum())
                for a, b, c in zip(got["tokens"], ref["tokens"], clear)),
            "kv": max(_rel_gap(g[n], w[n]) for g, w in zip(got["cache"],
                                                           ref["cache"])
                      for n in g if n != "pos"),
            "pos_equal": all(torch.equal(g["pos"], w["pos"])
                             for g, w in zip(got["cache"], ref["cache"]))}
    if "hidden" in ref:
        gaps["hidden"] = _rel_gap(got["hidden"], ref["hidden"])
        gaps["tok0_equal"] = bool(torch.equal(got["tok0"], ref["tok0"]))
    return gaps


def _serve_rank(group, job):
    """One of the 4 gloo ranks: the fsdp run, then the tp run, each
    against the single device's run that the parent saved to
    ``job["ref"]`` (read by rank 0 alone)."""
    import torch.distributed as dist

    dev = torch.device(job["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    ref = (torch.load(job["ref"], map_location=dev, weights_only=False)
           if dist.get_rank() == 0 else {"fsdp": None, "tp": None})
    out = {}
    for name in ("fsdp", "tp"):
        out[name] = _sharded_serve(job[name], dev, ref[name] or {})
        ref[name] = None
        torch.cuda.empty_cache()
    return out


def sharded_attention_phases(dev):
    """The decode-attention kernel at the sharded serving path's shapes
    (llama3.2-3b: H = 24, Hk = 8, D = 128, bf16 rings, SERVE_BATCH / 2 rows
    a data rank): a model rank's block of the fsdp ring (the second 1,032
    of 2,064 slots, part-empty at the last step's position) and the tp
    layout's whole ring (H = 12, Hk = 4 a rank), each timed beside the
    plain version and ``sdpa``; then the merge on the card: the kernel on
    both blocks of one ring, merged (``ops.merge_stacked``, the ranks'
    formula), against ``decode_attention_ref`` over the whole ring at the
    last step's position and at one where the second block is empty."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    cfg = get_config(SHARDED_ARCH)
    b, h, hk = SERVE_BATCH // 2, cfg.n_heads, cfg.n_kv_heads
    d = cfg.resolved_head_dim
    w, w_loc = SERVE_SEQ, SERVE_SEQ // 2
    t = SERVE_PROMPT + SERVE_GEN - 1
    gen = torch.Generator().manual_seed(29)
    bf = torch.bfloat16
    phases = [decode_attention_phase(
        "sharded-fsdp-block", b, h, hk, d, w_loc, t, None, bf, dev, gen,
        pos=_ring_pos(w, t, dev)[w_loc:]),
        decode_attention_phase("sharded-tp", b, h // 2, hk // 2, d, w, t,
                               None, bf, dev, gen)]
    merge_err = 0.0
    for t_ in (t, w_loc // 2):
        q = torch.randn(b, h, d, generator=gen).to(dev)
        k = torch.randn(b, w, hk, d, generator=gen).to(bf).to(dev)
        v = torch.randn(b, w, hk, d, generator=gen).to(bf).to(dev)
        pos = _ring_pos(w, t_, dev)
        parts = [ops.decode_attention(q, k[:, s].contiguous(),
                                      v[:, s].contiguous(),
                                      pos[s].contiguous(), t_)
                 for s in (slice(0, w_loc), slice(w_loc, w))]
        merged = ops.merge_stacked(*(torch.stack(x) for x in zip(*parts)))
        want = decode_attention_ref(q, k, v, pos, t_)[0]
        torch.cuda.synchronize()
        err = float((merged - want).abs().max())
        if not err <= 1e-5:
            raise AssertionError(f"decode_attention merged over 2 blocks at "
                                 f"t={t_}: max|Δ| {err:.3g} vs the whole "
                                 "ring (limit 1e-5)")
        merge_err = max(merge_err, err)
    log(f"decode_attention[sharded merge: B={b} H={h} Hk={hk} D={d}, 2 "
        f"blocks of {w_loc} slots, t={t} and t={w_loc // 2} (second block "
        f"empty)]: merged vs the whole ring max|Δ| {merge_err:.3g}; "
        f"{card_line()}")
    for p in phases:
        p["merge_max_abs_err"] = merge_err
    return phases


def _serve_line(name, r, layers, card) -> str:
    steps = r["ms"]
    pre = (f"prefill {r['prefill_ms']:.3f} ms, " if "prefill_ms" in r
           else "")
    return (f"{name} [{layers} layers; {card}]: {pre}decode "
            f"{statistics.median(steps):.3f} ms/token (median of "
            f"{len(steps)}; steps {[round(x, 3) for x in steps]}), "
            f"decode_attention launches a step {sorted(set(r['launches']))}, "
            f"peak memory {r['peak'] / 1e9:.3f} GB, ring a rank "
            f"{r['ring_local']}, collectives of the last step "
            f"{r['collectives'][-1]}")


def sharded_serve_path(dev):
    """The sharded prefill and decode (``launch.steps.make_sharded_prefill``
    and ``make_sharded_decode``) of llama3.2-3b at full width, SERVE_DTYPE
    compute, bf16 rings:

    (a) fsdp at SERVE_FSDP_LAYERS layers on the single device, then on one
        NCCL rank on mesh (1, 1): the prefill's hidden, the first token,
        SERVE_GEN greedy steps' logits and tokens and the final cache, bit
        for bit;
    (b) fsdp on 4 gloo ranks over CUDA tensors on the card, (data=2,
        model=2), each step fed (a)'s token: the hidden, each step's logits
        and the first and last layers' final K/V within SERVE_TOL of (a)'s
        largest value, their ring positions and the first token equal, the
        greedy tokens equal where (a)'s top-2 gap clears SERVE_TOL;
    (c) tp at all 28 layers (bf16 weights) on the same ranks from an empty
        cache: SERVE_TP_FORCED teacher-forced steps, then SERVE_TP_GREEDY
        steps fed the single device's greedy tokens, against the single
        device's run of the same weights, as (b).

    Every decode step launches the decode-attention kernel once a layer on
    every rank. Prints prefill ms, decode ms/token, the collectives of a
    decode step by kind and bytes, peak memory a rank and the launches a
    step. Returns the launches by run. The kernel at these shapes:
    :func:`sharded_attention_phases`, with the kernel phases."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.launch import run_ranks, single_rank
    from repro_torch.models.serving import serve_kv_heads

    card = card_line()
    axes = ("data", "model")
    cfg_fsdp = _sharded_cfg(SERVE_FSDP_LAYERS)
    n_all = get_config(SHARDED_ARCH).n_layers
    prompt, forced = _serve_tokens(cfg_fsdp)

    # (a) one device, then one NCCL rank on (1, 1)
    torch.cuda.empty_cache()
    one = _one_device_serve(cfg_fsdp, dev, prompt=prompt.to(dev))
    fsdp_job = dict(layers=SERVE_FSDP_LAYERS, layout="fsdp",
                    prompt=prompt.numpy(),
                    feed=[t.cpu().numpy()
                          for t in [one["tok0"]] + one["tokens"][:-1]])
    with single_rank("nccl" if dev.type == "cuda" else "gloo", dev.type):
        nccl = _sharded_serve(dict(fsdp_job, mesh=((1, 1), axes)), dev)
    same = (torch.equal(nccl["hidden"], one["hidden"])
            and torch.equal(nccl["tok0"], one["tok0"])
            and all(torch.equal(a, b) for k in ("logits", "tokens")
                    for a, b in zip(nccl[k], one[k]))
            and all(torch.equal(g[n], w[n])
                    for g, w in zip(nccl["cache"], one["cache"]) for n in g))
    if not same or set(nccl["launches"]) != {SERVE_FSDP_LAYERS}:
        raise AssertionError(f"(a) mesh (1, 1): bitwise the single device "
                             f"{same}; decode_attention launches a step "
                             f"{nccl['launches']} (want {SERVE_FSDP_LAYERS})")
    launches = {"sharded_serve_one_device": sum(one["launches"]),
                "sharded_serve_nccl": sum(nccl["launches"])}
    log(_serve_line("sharded serve (a) one device, f32 weights", one,
                    SERVE_FSDP_LAYERS, card))
    log(_serve_line("sharded serve (a) 1 NCCL rank, mesh (1, 1), fsdp: "
                    "bitwise the single device", nccl, SERVE_FSDP_LAYERS,
                    card))
    refs = {"fsdp": {k: one[k] for k in ("hidden", "tok0", "logits",
                                         "tokens")}}
    refs["fsdp"]["cache"] = _ends(one["cache"])
    del one, nccl
    torch.cuda.empty_cache()

    # (c)'s single device: every layer, bf16 weights, from an empty cache
    tp_one = _one_device_serve(
        _sharded_cfg(n_all), dev,
        forced=[forced[:, i:i + 1].to(dev) for i in range(SERVE_TP_FORCED)],
        greedy=SERVE_TP_GREEDY, param_dtype=torch.bfloat16)
    log(_serve_line("sharded serve (c) one device, bf16 weights", tp_one,
                    n_all, card))
    tp_feed = ([forced[:, i:i + 1].numpy() for i in range(SERVE_TP_FORCED)]
               + [t.cpu().numpy() for t in
                  tp_one["tokens"][SERVE_TP_FORCED - 1:-1]])
    refs["tp"] = {k: tp_one[k] for k in ("logits", "tokens")}
    refs["tp"]["cache"] = _ends(tp_one["cache"])
    launches["sharded_serve_tp_one_device"] = sum(tp_one["launches"])
    del tp_one
    ref_path = ROOT / "build" / "sharded_serve_ref.pt"
    ref_path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(refs, ref_path)
    del refs
    torch.cuda.empty_cache()

    # (b), (c) on 4 gloo ranks
    job = dict(device=dev.type, ref=str(ref_path),
               fsdp=dict(fsdp_job, mesh=((2, 2), axes)),
               tp=dict(layers=n_all, layout="tp", mesh=((2, 2), axes),
                       feed=tp_feed))
    t0 = time.perf_counter()
    try:
        outs = run_ranks(_serve_rank, 4, backend="gloo", device=dev.type,
                         args=(job,), timeout_s=SHARDED_TIMEOUT_S)
    finally:
        ref_path.unlink(missing_ok=True)
    ranks_s = time.perf_counter() - t0
    r0 = next(o for o in outs if o["fsdp"]["rank"] == 0)
    hd = cfg_fsdp.resolved_head_dim
    want_ring = {"fsdp": (SERVE_BATCH // 2, SERVE_SEQ // 2,
                          cfg_fsdp.n_kv_heads, hd),
                 "tp": (SERVE_BATCH // 2, SERVE_SEQ,
                        serve_kv_heads(cfg_fsdp, 2), hd)}
    for name, layers, label in (("fsdp", SERVE_FSDP_LAYERS, "(b)"),
                                ("tp", n_all, "(c)")):
        g = r0[name]
        per_step = {x for o in outs for x in o[name]["launches"]}
        rings = {o[name]["ring_local"] for o in outs}
        gaps = {k: g[k] for k in ("hidden", "logits", "kv", "pos_equal",
                                  "tok0_equal", "tokens_compared",
                                  "tokens_equal") if k in g}
        ok = (all(gaps[k] <= SERVE_TOL for k in ("hidden", "logits", "kv")
                  if k in gaps)
              and gaps["pos_equal"] and gaps.get("tok0_equal", True)
              and 0 < gaps["tokens_compared"] == gaps["tokens_equal"]
              and per_step == {layers} and rings == {want_ring[name]})
        if not ok:
            raise AssertionError(
                f"{label} {name} on 4 gloo ranks against the single device: "
                f"{gaps} (limit {SERVE_TOL}), launches a step {per_step} "
                f"(want {layers}), rings a rank {rings}")
        launches[f"sharded_serve_{name}_ranks"] = sum(
            sum(o[name]["launches"]) for o in outs)
        log(_serve_line(f"sharded serve {label} 4 gloo ranks on one card, "
                        f"mesh (data=2, model=2), {name}, rank 0", g, layers,
                        card)
            + f" | against the single device: {gaps} (limit {SERVE_TOL} "
            f"of the largest value); peak memory a rank "
            f"{[round(o[name]['peak'] / 1e9, 3) for o in outs]} GB; "
            f"decode ms/token a rank "
            f"{[round(statistics.median(o[name]['ms']), 3) for o in outs]}")
    log(f"sharded serve: ranks' wall {ranks_s:.1f} s")
    return launches


def _family_cfg(arch: str, layers, no_drop: bool = False):
    """``arch``'s published config cut to ``layers`` (None: all); with
    ``no_drop`` an MoE's capacity factor FAMILY_NO_DROP_CF."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if no_drop and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=FAMILY_NO_DROP_CF))
    return cfg


def _family_inputs(cfg, b: int, s: int, seed: int, labels: bool) -> dict:
    """Token ids (b, s) (and labels), and whisper's frames (b, S_enc, d) or
    llava's patches (b, P, d) at 0.1·N(0, 1), from a seeded CPU
    generator, as numpy (the ranks take them so)."""
    gen = torch.Generator().manual_seed(seed)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                   generator=gen).numpy()}
    if labels:
        out["labels"] = torch.randint(0, cfg.vocab_size, (b, s),
                                      generator=gen).numpy()
    rows = {"encdec": ("frames", cfg.encoder_seq),
            "vlm": ("patches", cfg.patch_positions)}.get(cfg.family)
    if rows:
        out[rows[0]] = (0.1 * torch.randn(b, rows[1], cfg.d_model,
                                          generator=gen)).numpy()
    return out


def _family_rank(group, job):
    """One of the 4 gloo ranks: for each family, FAMILY_TRAIN_STEPS
    sharded train steps on (2, 2) from the seed, then the fsdp and tp
    serving runs against the single device's (the parent's, saved to
    ``job["ref"]``, read by rank 0 alone). Returns host values."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_sharded_train_step
    from repro_torch.models.config import ShapeConfig

    dev = torch.device(job["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    refs = (torch.load(job["ref"], map_location="cpu", weights_only=False)
            if dist.get_rank() == 0 else {})
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {}
    for fam in job["families"]:
        arch, res = fam["arch"], {}
        t0 = time.perf_counter()
        cfg = _family_cfg(arch, fam["layers"])
        shape = ShapeConfig("family", FAMILY_TRAIN_SEQ, SP_BATCH, "train")
        step, _, build = make_sharded_train_step(
            cfg, mesh, shape, torch.bfloat16, remat=True, **SHARDED_KW)
        torch.cuda.reset_peak_memory_stats(dev)
        model, opt = build(SHARDED_SEED, dev)
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in fam["batch"].items()}
        res["train"] = _timed_steps(step, model, opt, batch,
                                    FAMILY_TRAIN_STEPS)
        res["train_peak"] = torch.cuda.max_memory_allocated(dev)
        del model, opt, batch, step, build
        torch.cuda.empty_cache()
        res["train_s"] = time.perf_counter() - t0
        ref = refs.pop(arch, None)
        for name in ("fsdp", "tp"):
            t0 = time.perf_counter()
            res[name] = _sharded_serve(fam[name], dev,
                                       _to(ref[name], dev) if ref else {})
            res[name + "_s"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
        if mesh.rank == 0:
            log(f"  family rank 0: {arch} done ({res['train_s']:.1f} s "
                f"training, {res['fsdp_s']:.1f} s fsdp, {res['tp_s']:.1f} s "
                "tp)")
        out[arch] = res
    return out


def _to(tree, dev):
    """``tree`` (dicts, lists, tuples of tensors) moved to ``dev``."""
    if torch.is_tensor(tree):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree


def family_shard_kernel_phases(dev):
    """The kernels at the sharded families' new shapes, run with the
    kernel phases: ``decode_attention`` on model rank 0's block of
    mixtral's window ring (B = SERVE_BATCH / 2 rows a data rank, H = 32,
    Hk = 8, D = 128, 2,048 of 4,096 slots, window 4,096, at the fsdp
    run's last step) and on a model rank's block of whisper's cross K/V
    (H = Hk = 6, D = 64, 752 of 1,504 positions, t = 10^9), each beside
    its plain version and ``sdpa``; the cross blocks' merge on the card
    against the kernel over the whole cross cache; ``fused_ce`` at a
    (2, 2) rank's call (T = FAMILY_TRAIN_SEQ rows: one row of the data
    rank, gathered over ``model``) on half of mixtral's and of whisper's
    heads, (D, V/2) = (4,096, 16,000) and (384, 25,984)."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.models.serving import CROSS_T

    gen = torch.Generator().manual_seed(30)
    bf = torch.bfloat16
    mix = _family_cfg("mixtral-8x7b", 1)
    whi = _family_cfg("whisper-tiny", None)
    _, _, prompt, seq, gen_n = FAMILY_SHARDED[0]
    w = min(mix.swa_window, seq)
    t = prompt + gen_n - 1
    b = SERVE_BATCH // 2
    attn = [decode_attention_phase(
        "sharded-mixtral-window-block", b, mix.n_heads, mix.n_kv_heads,
        mix.resolved_head_dim, w // 2, t, mix.swa_window, bf, dev, gen,
        pos=_ring_pos(w, t, dev)[:w // 2])]
    loc = whi.encoder_seq // 2
    attn.append(decode_attention_phase(
        "sharded-whisper-cross-block", b, whi.n_heads, whi.n_kv_heads,
        whi.resolved_head_dim, loc, CROSS_T, None, bf, dev, gen,
        pos=torch.arange(loc, dtype=torch.int32)))
    h, hk, d = whi.n_heads, whi.n_kv_heads, whi.resolved_head_dim
    q = torch.randn(b, h, d, generator=gen).to(dev)
    k = torch.randn(b, 2 * loc, hk, d, generator=gen).to(bf).to(dev)
    v = torch.randn(b, 2 * loc, hk, d, generator=gen).to(bf).to(dev)
    pos = torch.arange(loc, dtype=torch.int32, device=dev)
    parts = [ops.decode_attention(q, k[:, i:i + loc].contiguous(),
                                  v[:, i:i + loc].contiguous(), pos, CROSS_T)
             for i in (0, loc)]
    merged = ops.merge_stacked(*(torch.stack(x) for x in zip(*parts)))
    whole = ops.decode_attention(q, k, v, torch.arange(
        2 * loc, dtype=torch.int32, device=dev), CROSS_T)[0]
    torch.cuda.synchronize()
    merge_err = float((merged - whole).abs().max())
    if not merge_err <= 1e-6:
        raise AssertionError(f"decode_attention: whisper's cross blocks "
                             f"merged vs the whole cross cache max|Δ| "
                             f"{merge_err:.3g} (limit 1e-6)")
    log(f"decode_attention[cross merge: B={b} H={h} Hk={hk} D={d}, 2 blocks "
        f"of {loc} positions]: merged vs the kernel over the whole cross "
        f"cache max|Δ| {merge_err:.3g}; {card_line()}")
    for p in attn:
        p["merge_max_abs_err"] = merge_err
    ce = [fused_ce_shard_phase(dev, c, FAMILY_TRAIN_SEQ, f"vocab-shard-{n}")
          for n, c in (("mixtral", mix), ("whisper", whi))]
    return attn, ce


def _data_rank_objective(model, batch, dp: int):
    """The (2, 2) train step's objective on one device at ``model``'s
    weights: each of the ``dp`` data ranks' rows through ``loss_fn`` on
    their own (bf16, remat), so that an MoE call sees the tokens the
    ranks' calls see. Returns (each data rank's metrics, the gradient norm
    of the mean of their losses); the weights are left as they were."""
    from repro_torch.models import transformer as T

    rows = batch["tokens"].shape[0] // dp
    params = dict(model.named_parameters())
    per = []
    with torch.enable_grad():
        for d in range(dp):
            part = {k: v[d * rows:(d + 1) * rows] for k, v in batch.items()}
            loss, m = T.loss_fn(model, part, torch.bfloat16, remat=True)
            (loss / dp).backward()
            per.append({k: float(v.detach()) for k, v in m.items()})
    gnorm = float(T.global_grad_norm({n: p.grad for n, p in params.items()},
                                     model.specs, model.par))
    for p in params.values():
        p.grad = None
    return per, gnorm


def _train_line(name, steps, card) -> str:
    return (f"{name} [{card}]: loss {[round(s['loss'], 6) for s in steps]}, "
            f"nll {[round(s['nll'], 6) for s in steps]}, lb_loss "
            f"{[round(s['lb_loss'], 6) for s in steps]}, drop_frac "
            f"{[round(s['drop_frac'], 6) for s in steps]}, grad_norm "
            f"{[round(s['grad_norm'], 6) for s in steps]}, step ms "
            f"{[round(s['ms'], 1) for s in steps]}, fused_ce a step "
            f"{sorted({s['fused_ce'] for s in steps})}, collectives of the "
            f"last step {steps[-1]['collectives']}")


def sharded_family_path(dev):
    """The sharded MoE, encoder-decoder and VLM families
    (``launch.steps.make_sharded_train_step``, ``make_sharded_prefill``,
    ``make_sharded_decode``) at full width (``FAMILY_SHARDED``):

    (a) training, on the single device FAMILY_TRAIN_STEPS steps of each
        family; mixtral's also on one NCCL rank on mesh (1, 1), loss,
        lb_loss, drop_frac and grad_norm bitwise and every weight and
        moment by :func:`_leaf_digest`;
    (b) serving on the single device: the fsdp prefill and greedy steps
        (f32 weights), and the tp steps from an empty cache (bf16
        weights; whisper's ``ck``/``cv`` the fsdp prefill's);
    (c) one spawn of 4 gloo ranks over CUDA tensors on (data=2, model=2):
        per family FAMILY_TRAIN_STEPS train steps (step 1's loss within
        FAMILY_LOSS_TOL and grad_norm within FAMILY_GNORM_TOL of (a)'s:
        whisper and llava the same objective; mixtral's drops and its
        ``lb_loss`` of each data rank's rows differ from one device's;
        one ``fused_ce`` launch a step a rank, on its vocabulary shard);
        then the fsdp and tp serving runs against (b): the hidden, each
        step's logits and the first and last layers' K/V (whisper's
        ``ck``/``cv`` too) within SERVE_TOL of (b)'s largest value, ring
        positions and the first token equal, every decided token equal;
        ``decode_attention`` launched once a layer a decode step on every
        rank, twice for whisper (its cross block, merged over ``model``).

    Prints step and token ms, peak memory a rank, the collectives a step
    by kind and bytes, kernel launches a step a rank, the gaps and the
    tokens compared. Returns the launches by run ({"decode_attention":
    ..., "fused_ce": ...})."""
    from repro_torch.distributed.launch import run_ranks, single_rank
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_sharded_train_step
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.serving import serve_kv_heads

    card = card_line()
    axes = ("data", "model")
    attn_launches, ce_launches = {}, {}
    single, objective, refs, families = {}, {}, {}, []
    for arch, layers, prompt, seq, gen_n in FAMILY_SHARDED:
        cfg = _family_cfg(arch, layers)
        batch_np = _family_inputs(cfg, SP_BATCH, FAMILY_TRAIN_SEQ,
                                  SHARDED_SEED, labels=True)
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in batch_np.items()}
        # (a) one device, and mixtral on one NCCL rank on (1, 1)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        model = T.init_model(cfg, SHARDED_SEED, dev)
        model.requires_grad_(True)
        objective[arch] = _data_rank_objective(model, batch, 2)
        opt = T.init_opt(model)
        step = T.make_train_step(cfg, torch.bfloat16, remat=True,
                                 **SHARDED_KW)
        single[arch] = _timed_steps(step, model, opt, batch,
                                    FAMILY_TRAIN_STEPS)
        peak = torch.cuda.max_memory_allocated(dev)
        n_params = sum(p.numel() for p in model.parameters())
        want = _state_digests(model, opt) if cfg.moe is not None else None
        del model, opt, step
        torch.cuda.empty_cache()
        log(_train_line(f"sharded family train (a) {arch}, "
                        f"{cfg.n_layers} layers ({n_params / 1e9:.3f} B "
                        f"params), one device, peak {peak / 1e9:.2f} GB",
                        single[arch], card))
        if want is not None:
            with single_rank("nccl" if dev.type == "cuda" else "gloo",
                             dev.type):
                mesh = make_mesh((1, 1), axes)
                shape = ShapeConfig("family", FAMILY_TRAIN_SEQ, SP_BATCH,
                                    "train")
                step, _, build = make_sharded_train_step(
                    cfg, mesh, shape, torch.bfloat16, remat=True,
                    **SHARDED_KW)
                model, opt = build(SHARDED_SEED, dev)
                one = _timed_steps(step, model, opt, batch,
                                   FAMILY_TRAIN_STEPS)
                same = _state_digests(model, opt) == want
                del model, opt, step, build
            torch.cuda.empty_cache()
            keys = ("loss", "nll", "lb_loss", "drop_frac", "grad_norm")
            if not same or any(a[k] != b[k] for a, b in
                               zip(single[arch], one) for k in keys):
                pairs = [(a["loss"], b["loss"])
                         for a, b in zip(single[arch], one)]
                raise AssertionError(
                    f"(a) {arch} on one NCCL rank is not bitwise the single "
                    f"device: weights equal {same}; losses {pairs}")
            ce_launches[f"sharded_family_{arch}_nccl"] = sum(
                s["fused_ce"] for s in one)
            log(_train_line(f"sharded family train (a) {arch}, 1 NCCL rank "
                            "on (1, 1): bitwise the single device", one,
                            card))
        del batch
        # (b) serving on one device
        scfg = _family_cfg(arch, layers, no_drop=True)
        inputs = _family_inputs(scfg, SERVE_BATCH, prompt + FAMILY_TP_FORCED,
                                SHARDED_SEED + 30, labels=False)
        tokens = inputs.pop("tokens")
        front = {k: torch.as_tensor(v, device=dev) for k, v in inputs.items()}
        one = _one_device_serve(scfg, dev,
                                prompt=torch.as_tensor(tokens[:, :prompt],
                                                       device=dev),
                                seq=seq, gen=gen_n, frontend=front)
        del front
        log(_serve_line(f"sharded family serve (b) {arch} one device, f32 "
                        "weights", one, scfg.n_layers, card))
        cross = one.pop("cross", None)
        forced = torch.as_tensor(tokens[:, prompt:])
        tp_one = _one_device_serve(
            scfg, dev, forced=[forced[:, i:i + 1].to(dev)
                               for i in range(FAMILY_TP_FORCED)],
            greedy=FAMILY_TP_GREEDY, param_dtype=torch.bfloat16, seq=seq,
            cross=cross)
        log(_serve_line(f"sharded family serve (b) {arch} one device, bf16 "
                        "weights, tp reference", tp_one, scfg.n_layers, card))
        attn_launches[f"sharded_family_{arch}_one_device"] = sum(
            one["launches"]) + sum(tp_one["launches"])
        refs[arch] = {
            "fsdp": _to({k: one[k] for k in ("hidden", "tok0", "logits",
                                             "tokens")}
                        | {"cache": _ends(one["cache"])}, "cpu"),
            "tp": _to({k: tp_one[k] for k in ("logits", "tokens")}
                      | {"cache": _ends(tp_one["cache"])}, "cpu")}
        base = dict(cfg=scfg, seq=seq, mesh=((2, 2), axes))
        families.append(dict(
            arch=arch, layers=layers, batch=batch_np,
            fsdp=dict(base, layout="fsdp", prompt=tokens[:, :prompt],
                      frontend=inputs,
                      feed=[t.cpu().numpy() for t in
                            [one["tok0"]] + one["tokens"][:-1]]),
            tp=dict(base, layout="tp",
                    cross=[(ck.float(), cv.float()) for ck, cv in cross]
                    if cross else None,
                    feed=[forced[:, i:i + 1].numpy()
                          for i in range(FAMILY_TP_FORCED)]
                    + [t.cpu().numpy() for t in
                       tp_one["tokens"][FAMILY_TP_FORCED - 1:-1]])))
        del one, tp_one, cross
        torch.cuda.empty_cache()

    ref_path = ROOT / "build" / "sharded_family_ref.pt"
    ref_path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(refs, ref_path)
    del refs
    t0 = time.perf_counter()
    try:
        outs = run_ranks(_family_rank, 4, backend="gloo", device=dev.type,
                         args=(dict(device=dev.type, ref=str(ref_path),
                                    families=families),),
                         timeout_s=SHARDED_TIMEOUT_S)
    finally:
        ref_path.unlink(missing_ok=True)
    ranks_s = time.perf_counter() - t0
    r0 = next(o for o in outs if o[FAMILY_SHARDED[0][0]]["fsdp"]["rank"] == 0)
    for fam in families:
        arch = fam["arch"]
        cfg = fam["fsdp"]["cfg"]
        g = r0[arch]
        # (c) training
        steps = g["train"]
        for o in outs:
            if [(s["nll"], s["grad_norm"]) for s in o[arch]["train"]] != [
                    (s["nll"], s["grad_norm"]) for s in steps]:
                raise AssertionError(f"(c) {arch}: the ranks' nll or "
                                     "grad_norm differ")
        per, gnorm = objective[arch]
        nll = sum(m["nll"] for m in per) / len(per)
        rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
        gaps = {"nll": rel(steps[0]["nll"], nll),
                "grad_norm": rel(steps[0]["grad_norm"], gnorm),
                "loss": 0.0, "lb_loss": 0.0, "drop_frac": 0.0}
        for o in outs:  # each rank against its data rank's rows
            m, want = o[arch]["train"][0], per[o[arch]["fsdp"]["rank"] // 2]
            lb = want["lb_loss"]
            gaps["loss"] = max(gaps["loss"], rel(
                m["loss"], nll + T.LB_COEF * lb if cfg.moe else nll))
            gaps["lb_loss"] = max(gaps["lb_loss"], rel(m["lb_loss"], lb)
                                  if lb else abs(m["lb_loss"]))
            gaps["drop_frac"] = max(gaps["drop_frac"],
                                    abs(m["drop_frac"] - want["drop_frac"]))
        limits = {"loss": FAMILY_LOSS_TOL, "nll": FAMILY_LOSS_TOL,
                  "lb_loss": FAMILY_LOSS_TOL, "drop_frac": FAMILY_DROP_TOL,
                  "grad_norm": FAMILY_GNORM_TOL}
        ce_a_step = {s["fused_ce"] for o in outs for s in o[arch]["train"]}
        finite = all(np.isfinite([s["loss"], s["grad_norm"]]).all()
                     for o in outs for s in o[arch]["train"])
        if not (finite and ce_a_step == {1}
                and all(gaps[k] <= limits[k] for k in limits)):
            raise AssertionError(
                f"(c) {arch} training on 4 gloo ranks: step 1 against the "
                f"single device's objective {gaps} (limits {limits}), "
                f"fused_ce a step {ce_a_step}, finite {finite}")
        ce_launches[f"sharded_family_{arch}_rank0"] = sum(
            s["fused_ce"] for s in steps)
        log(_train_line(
            f"sharded family train (c) {arch}, 4 gloo ranks on one card, "
            f"mesh (data=2, model=2), rank 0 (step 1 against the single "
            f"device's objective, each data rank's rows on their own: "
            f"{ {k: float(f'{v:.3g}') for k, v in gaps.items()} }, drop_frac "
            f"of the data ranks there {[m['drop_frac'] for m in per]}); "
            f"peak memory a rank "
            f"{[round(o[arch]['train_peak'] / 1e9, 2) for o in outs]} GB",
            steps, card))
        # (c) serving
        per_layer = 2 if cfg.family == "encdec" else 1
        hd = cfg.resolved_head_dim
        w = min(cfg.swa_window or fam["fsdp"]["seq"], fam["fsdp"]["seq"])
        want_ring = {"fsdp": (SERVE_BATCH // 2, w // 2, cfg.n_kv_heads, hd),
                     "tp": (SERVE_BATCH // 2, w, serve_kv_heads(cfg, 2),
                            hd)}
        for name in ("fsdp", "tp"):
            r = g[name]
            per_step = {x for o in outs for x in o[arch][name]["launches"]}
            rings = {o[arch][name]["ring_local"] for o in outs}
            gaps = {k: r[k] for k in ("hidden", "logits", "kv", "pos_equal",
                                      "tok0_equal", "tokens_compared",
                                      "tokens_equal") if k in r}
            ok = (all(gaps[k] <= SERVE_TOL for k in ("hidden", "logits", "kv")
                      if k in gaps)
                  and gaps["pos_equal"] and gaps.get("tok0_equal", True)
                  and 0 < gaps["tokens_compared"] == gaps["tokens_equal"]
                  and per_step == {per_layer * cfg.n_layers}
                  and rings == {want_ring[name]})
            if not ok:
                raise AssertionError(
                    f"(c) {arch} {name} on 4 gloo ranks against the single "
                    f"device: {gaps} (limit {SERVE_TOL}), launches a step "
                    f"{per_step} (want {per_layer * cfg.n_layers}), rings a "
                    f"rank {rings}")
            attn_launches[f"sharded_family_{arch}_{name}_ranks"] = sum(
                sum(o[arch][name]["launches"]) for o in outs)
            log(_serve_line(
                f"sharded family serve (c) {arch} 4 gloo ranks on one card, "
                f"mesh (data=2, model=2), {name}, rank 0", r, cfg.n_layers,
                card) + f" | against the single device: {gaps} (limit "
                f"{SERVE_TOL} of the largest value); peak memory a rank "
                f"{[round(o[arch][name]['peak'] / 1e9, 3) for o in outs]} GB")
    log(f"sharded family: ranks' wall {ranks_s:.1f} s")
    return {"decode_attention": attn_launches, "fused_ce": ce_launches}


def _tp_cfg(arch: str, layers: int):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), n_layers=layers)


def _kernel_counts() -> dict:
    """Every LM kernel wrapper's launch count (a snapshot)."""
    from repro_torch.kernels.decode_attention import ops as aops
    from repro_torch.kernels.fused_ce import ops as cops
    from repro_torch.kernels.rglru_scan import ops as gops
    from repro_torch.kernels.rwkv6_scan import ops as wops

    return {"rglru_scan": gops.launch_count,
            "rglru_scan_bwd": gops.bwd_launch_count,
            "rwkv6_scan": wops.launch_count,
            "rwkv6_scan_bwd_ds": wops.bwd_ds_launch_count,
            "rwkv6_scan_bwd_chunk": wops.bwd_chunk_launch_count,
            "fused_ce": cops.launch_count,
            "decode_attention": aops.launch_count}


def _counted(fn):
    """(fn(), the kernel launches it made, by wrapper)."""
    before = _kernel_counts()
    out = fn()
    after = _kernel_counts()
    return out, {k: after[k] - before[k] for k in after}


def _tp_serve_run(cfg, dev, prompt, mesh=None, feed=None):
    """The TP-mode serving run of ``cfg``'s model of SHARDED_SEED, on one
    device (``mesh`` None) or as this rank of ``mesh`` (shape, axes): the
    fsdp prefill of ``prompt`` (SERVE_BATCH, TP_PROMPT) into a TP_SEQ
    ring (f32 weights), the first token from the hidden's last row,
    TP_GEN − 1 more greedy steps; then, from a copy of the prefill's
    cache, the same TP_GEN steps with the tp layout's bf16 weights. With
    ``feed`` ({layout: the TP_GEN global (B, 1) tokens}, a single device's
    run's) each step is fed its token instead of the last step's. Returns
    per layout the logical hidden (fsdp), first token, logits and tokens a
    step, the logical final cache, times, kernel launches and collectives
    a step, peak memory and this rank's cache shapes."""
    from repro_torch.distributed import par as P
    from repro_torch.launch.mesh import make_mesh, make_par
    from repro_torch.launch.steps import (make_sharded_decode,
                                          make_sharded_prefill)
    from repro_torch.models import serving as SV
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ShapeConfig

    dt, bf = SERVE_DTYPE, torch.bfloat16
    out = {}
    if mesh is None:
        par = P.Par()
        gather = lambda t, spec: t
        models = {"fsdp": lambda: T.init_model(cfg, SHARDED_SEED, dev),
                  "tp": lambda: T.init_model(cfg, SHARDED_SEED, dev, bf)}
        step = lambda m, c, t: SV.decode_step(m, c, t, TP_SEQ, dt)
        steps = {"fsdp": step, "tp": step}
        prefill = lambda m, p: SV.prefill(m, p, TP_SEQ, dt, bf)
        specs = {"fsdp": None, "tp": None}
        pspec = None
    else:
        mesh = make_mesh(*mesh)
        par = make_par(mesh)
        gather = lambda t, spec: P.gather_logical(t, spec, par)
        steps, models, specs = {}, {}, {}
        for layout in ("fsdp", "tp"):
            st, sp, build = make_sharded_decode(
                cfg, mesh, ShapeConfig("decode", TP_SEQ, SERVE_BATCH,
                                       "decode"), dt, layout)
            steps[layout], specs[layout] = st, sp
            models[layout] = (lambda b: lambda: b(SHARDED_SEED, dev)[0])(
                build)
        pstep, pspecs, _ = make_sharded_prefill(
            cfg, mesh, ShapeConfig("prefill", TP_SEQ, SERVE_BATCH,
                                   "prefill"), dt)
        prefill = pstep
        pspec = pspecs["out"]
    torch.cuda.reset_peak_memory_stats(dev)
    model = models["fsdp"]()
    prompt = torch.as_tensor(prompt, device=dev)
    ((cache, h), out["prefill_ms"]), out["prefill_launches"] = _counted(
        lambda: _timed(lambda: prefill(model, prompt)))
    out["hidden"] = gather(h, pspec) if pspec is not None else h
    head = P.gather_param(model.embed.head, model.embed.specs["head"], dt,
                          par)
    rows = h[:, -1:]  # the TP-mode hidden is whole over `model`
    tok0 = SV.vocab_parallel_argmax((rows @ head).float(), par)
    out["tok0"] = (gather(tok0, specs["fsdp"]["tokens"])
                   if mesh is not None else tok0)
    del h, head, rows
    saved = [{n: v.clone() for n, v in c.items()} for c in cache["layers"]]
    t_saved = cache["t"]
    out["shapes"] = [{n: tuple(v.shape) for n, v in c.items()}
                     for c in cache["layers"]]
    for layout in ("fsdp", "tp"):
        if layout == "tp":
            del model
            torch.cuda.empty_cache()
            model = models["tp"]()
            cache = {"t": t_saved, "layers": saved}
        forced = ([out["tok0"]] if feed is None
                  else [t.to(dev) for t in feed[layout]])
        (run, cache), launches = _counted(
            lambda: _decode_run(steps[layout], model, cache, forced,
                                TP_GEN - len(forced)))
        sp = specs[layout]
        res = {"ms": run["ms"], "collectives": run["collectives"],
               "launches": run["launches"], "kernel_launches": launches}
        if mesh is None:
            res.update(logits=run["logits"], tokens=run["tokens"],
                       cache=cache["layers"])
        else:
            res.update(
                logits=[gather(x, sp["out"]) for x in run["logits"]],
                tokens=[gather(x, sp["tokens"]) for x in run["tokens"]],
                cache=[{n: gather(c[n], s[n]) for n in c}
                       for c, s in zip(cache["layers"],
                                       sp["cache"]["layers"])])
        out[layout] = res
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    del model, cache, saved
    torch.cuda.empty_cache()
    return out


def _tp_serve_gaps(got, ref) -> dict:
    """A sharded TP-mode serving run's gaps to the single device's: the
    hidden, and per layout each step's logits and the final cache's
    float leaves (K/V, states, histories, shifts) as max|Δ| over the
    reference's max; ring positions and the first token equal; the greedy
    tokens of the rows whose reference top-2 gap clears SERVE_TOL (rows
    compared, rows equal)."""
    gaps = {"hidden": _rel_gap(got["hidden"].cpu(), ref["hidden"]),
            "tok0_equal": bool(torch.equal(got["tok0"].cpu(),
                                           ref["tok0"].cpu()))}
    for layout in ("fsdp", "tp"):
        g, r = got[layout], ref[layout]
        clear = [_clear_rows(b, SERVE_TOL) for b in r["logits"]]
        gaps[layout] = {
            "logits": max(_rel_gap(a.cpu(), b.cpu())
                          for a, b in zip(g["logits"], r["logits"])),
            "cache": max(_rel_gap(a[n].cpu(), b[n].cpu())
                         for a, b in zip(g["cache"], r["cache"])
                         for n in a if n != "pos"),
            "pos_equal": all(torch.equal(a["pos"].cpu(), b["pos"].cpu())
                             for a, b in zip(g["cache"], r["cache"])
                             if "pos" in a),
            "tokens_compared": sum(int(c.sum()) for c in clear),
            "tokens_equal": sum(
                int((a.view(-1).cpu()[c.cpu()]
                     == b.view(-1).cpu()[c.cpu()]).sum())
                for a, b, c in zip(g["tokens"], r["tokens"], clear))}
    return gaps


def _tp_bitwise(got, ref) -> bool:
    """Whether two TP-mode serving runs are the same bits: hidden, first
    token, and per layout every step's logits and tokens and the final
    cache."""
    same = lambda a, b: torch.equal(a.cpu(), b.cpu())
    return (same(got["hidden"], ref["hidden"])
            and same(got["tok0"], ref["tok0"])
            and all(same(a, b) for layout in ("fsdp", "tp")
                    for k in ("logits", "tokens")
                    for a, b in zip(got[layout][k], ref[layout][k]))
            and all(same(a[n], b[n]) for layout in ("fsdp", "tp")
                    for a, b in zip(got[layout]["cache"],
                                    ref[layout]["cache"]) for n in a))


def _tp_rank(group, job):
    """One of the 4 gloo ranks on (data=2, model=2): per TP-mode arch,
    TP_TRAIN_STEPS sharded train steps from the seed (the kernels'
    launches counted), then :func:`_tp_serve_run`, whose gaps to the
    single device's run (the parent's, saved to ``job["ref"]``) rank 0
    computes. Returns host values."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_sharded_train_step
    from repro_torch.models.config import ShapeConfig

    dev = torch.device(job["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    refs = (torch.load(job["ref"], map_location="cpu", weights_only=False)
            if dist.get_rank() == 0 else {})
    axes = ("data", "model")
    mesh = make_mesh((2, 2), axes)
    out = {"rank": mesh.rank}
    for arch, layers in TP_SHARDED:
        cfg, res = _tp_cfg(arch, layers), {}
        t0 = time.perf_counter()
        shape = ShapeConfig("tp", TP_TRAIN_SEQ, SHARDED_BATCH, "train")
        step, _, build = make_sharded_train_step(
            cfg, mesh, shape, torch.bfloat16, remat=True, **SHARDED_KW)
        torch.cuda.reset_peak_memory_stats(dev)
        model, opt = build(SHARDED_SEED, dev)
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in job["batch"][arch].items()}
        res["train"], res["train_launches"] = _counted(
            lambda: _timed_steps(step, model, opt, batch, TP_TRAIN_STEPS))
        res["train_peak"] = torch.cuda.max_memory_allocated(dev)
        del model, opt, step, build
        torch.cuda.empty_cache()
        if arch in TP_F32_GRAD:
            step, _, build = make_sharded_train_step(
                cfg, mesh, shape, torch.float32, remat=True, **SHARDED_KW)
            model, opt = build(SHARDED_SEED, dev)
            res["train_f32"] = _timed_steps(step, model, opt, batch, 1)[0]
            del model, opt, step, build
            torch.cuda.empty_cache()
        del batch
        res["train_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        run = _tp_serve_run(cfg, dev, job["prompt"][arch], ((2, 2), axes),
                            job["feed"][arch])
        res["serve_s"] = time.perf_counter() - t0
        ref = refs.pop(arch, None)
        if ref is not None:
            res["gaps"] = _tp_serve_gaps(run, ref)
        res["serve"] = {k: run[k] for k in ("prefill_ms", "prefill_launches",
                                            "peak", "shapes")}
        for layout in ("fsdp", "tp"):
            res["serve"][layout] = {k: run[layout][k] for k in (
                "ms", "collectives", "launches", "kernel_launches")}
        del run, ref
        torch.cuda.empty_cache()
        if mesh.rank == 0:
            log(f"  tp rank 0: {arch} done ({res['train_s']:.1f} s training, "
                f"{res['serve_s']:.1f} s serving)")
        out[arch] = res
    return out


def tp_shard_kernel_phases(dev):
    """The four kernels at the shapes a (2, 2) rank of the TP-mode archs'
    sharded paths gives them, each against its plain version: the RG-LRU
    scan forward and backward at r/mp = 2,048 channels (a data rank's
    training row, B = 1 × S = TP_TRAIN_SEQ, and the prefill's B =
    SERVE_BATCH / 2 × TP_PROMPT); the WKV6 forward and the two-pass
    backward at H/mp = 32 heads over one 512-step time chunk of a data
    rank's row; ``fused_ce`` on a model rank's vocabulary block, V/mp =
    128,000 (recurrentgemma) and 32,768 (rwkv6), at a data rank's
    TP_TRAIN_SEQ rows; ``decode_attention`` on recurrentgemma's 8 query
    heads a model rank against its whole MQA ring (Hk = 1, W = 2,048, D =
    256, window 2,048) at the last greedy step. Returns (rglru forwards,
    rglru backwards, WKV forwards, WKV backwards, fused_ce, attention)."""
    from repro_torch.models.layers import RWKV_TIME_CHUNK

    g_cfg = _tp_cfg("recurrentgemma-9b", 3)
    w_cfg = _tp_cfg("rwkv6-7b", 2)
    r_loc = g_cfg.rnn_dim // 2
    h_loc, d = w_cfg.n_heads // 2, w_cfg.resolved_head_dim
    gen = torch.Generator().manual_seed(31)
    scan = [rglru_phase("sharded-tp-train-rank", SHARDED_BATCH // 2,
                        TP_TRAIN_SEQ, r_loc, -5.0, False, dev, gen),
            rglru_phase("sharded-tp-prefill-rank", SERVE_BATCH // 2,
                        TP_PROMPT, r_loc, -5.0, False, dev, gen)]
    scan_bwd = [rglru_grad_phase("sharded-tp-backward-rank",
                                 SHARDED_BATCH // 2, TP_TRAIN_SEQ, r_loc,
                                 -5.0, False, dev, gen)]
    wkv = [rwkv_phase("sharded-tp-rank", SHARDED_BATCH // 2, h_loc,
                      RWKV_TIME_CHUNK, d, None, dev, gen)]
    wkv_bwd = [rwkv_grad_phase("sharded-tp-rank", SHARDED_BATCH // 2, h_loc,
                               RWKV_TIME_CHUNK, d, None, dev, gen)]
    ce = [fused_ce_shard_phase(dev, c, TP_TRAIN_SEQ, f"vocab-shard-{n}")
          for n, c in (("recurrentgemma", g_cfg), ("rwkv6", w_cfg))]
    w = min(g_cfg.local_attn_window, TP_SEQ)
    attn = [decode_attention_phase(
        "sharded-tp-mqa", SERVE_BATCH // 2, g_cfg.n_heads // 2,
        g_cfg.n_kv_heads, g_cfg.resolved_head_dim, w,
        TP_PROMPT + TP_GEN - 1, g_cfg.local_attn_window, torch.bfloat16,
        dev, gen)]
    torch.cuda.empty_cache()
    return scan, scan_bwd, wkv, wkv_bwd, ce, attn


def sharded_tp_path(dev):
    """The TP-mode archs' sharded training, prefill and decode
    (``launch.steps.make_sharded_train_step``, ``make_sharded_prefill``,
    ``make_sharded_decode`` in both layouts) at full width (TP_SHARDED):

    (a) per arch on the single device: TP_TRAIN_STEPS training steps,
        then on one NCCL rank on mesh (1, 1) the same steps (metrics
        bitwise, every weight and moment by :func:`_leaf_digest`), and
        the serving run (:func:`_tp_serve_run`) on the single device and
        on the NCCL rank, bit for bit;
    (b) one spawn of 4 gloo ranks over CUDA tensors on (data=2, model=2):
        per arch the training steps (step 1's loss within TP_LOSS_TOL and
        grad_norm within TP_GNORM_TOL of (a)'s; the scans' forward and
        backward kernels and ``fused_ce`` launched on every rank; the
        RG-LRU scan at r/mp channels, the WKV at H/mp heads, ``fused_ce``
        on the rank's vocabulary block), then the serving run against
        (a)'s: the hidden, each step's logits and the final cache within
        SERVE_TOL of (a)'s largest value, ring positions and the first
        token equal, every decided token equal; ``decode_attention``
        launched once a step an attention layer on every rank, in both
        layouts.

    Prints step and token ms, peak memory a rank, the collectives by kind
    and bytes, launches, gaps and the tokens compared. Returns the
    launches by kernel and run."""
    from repro_torch.distributed.launch import run_ranks, single_rank
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_sharded_train_step
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ShapeConfig, layer_kinds

    card = card_line()
    axes = ("data", "model")
    launches = {}
    single, refs, batches, prompts, feeds = {}, {}, {}, {}, {}
    single_f32 = {}
    for arch, layers in TP_SHARDED:
        cfg = _tp_cfg(arch, layers)
        gen = torch.Generator().manual_seed(SHARDED_SEED + 31)
        batches[arch] = {k: torch.randint(
            0, cfg.vocab_size, (SHARDED_BATCH, TP_TRAIN_SEQ),
            generator=gen).numpy() for k in ("tokens", "labels")}
        prompts[arch] = torch.randint(0, cfg.vocab_size,
                                      (SERVE_BATCH, TP_PROMPT),
                                      generator=gen).numpy()
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in batches[arch].items()}
        # (a) one device, then one NCCL rank on (1, 1)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        model = T.init_model(cfg, SHARDED_SEED, dev)
        model.requires_grad_(True)
        opt = T.init_opt(model)
        step = T.make_train_step(cfg, torch.bfloat16, remat=True,
                                 **SHARDED_KW)
        single[arch], launches[f"sharded_tp_{arch}_one_device_train"] = (
            _counted(lambda: _timed_steps(step, model, opt, batch,
                                          TP_TRAIN_STEPS)))
        peak = torch.cuda.max_memory_allocated(dev)
        n_params = sum(p.numel() for p in model.parameters())
        want = _state_digests(model, opt)
        del model, opt, step
        torch.cuda.empty_cache()
        if arch in TP_F32_GRAD:
            model = T.init_model(cfg, SHARDED_SEED, dev)
            model.requires_grad_(True)
            step = T.make_train_step(cfg, torch.float32, remat=True,
                                     **SHARDED_KW)
            single_f32[arch] = _timed_steps(step, model, T.init_opt(model),
                                            batch, 1)[0]
            del model, step
            torch.cuda.empty_cache()
        log(_train_line(f"sharded tp train (a) {arch}, {layers} layers "
                        f"({n_params / 1e9:.3f} B params), one device, peak "
                        f"{peak / 1e9:.2f} GB", single[arch], card))
        one_serve = _tp_serve_run(cfg, dev, prompts[arch])
        with single_rank("nccl" if dev.type == "cuda" else "gloo", dev.type):
            mesh = make_mesh((1, 1), axes)
            shape = ShapeConfig("tp", TP_TRAIN_SEQ, SHARDED_BATCH, "train")
            step, _, build = make_sharded_train_step(
                cfg, mesh, shape, torch.bfloat16, remat=True, **SHARDED_KW)
            model, opt = build(SHARDED_SEED, dev)
            one = _timed_steps(step, model, opt, batch, TP_TRAIN_STEPS)
            same = _state_digests(model, opt) == want
            del model, opt, step, build
            torch.cuda.empty_cache()
            nccl_serve = _tp_serve_run(cfg, dev, prompts[arch],
                                       ((1, 1), axes))
        keys = ("loss", "nll", "grad_norm")
        if not same or any(a[k] != b[k] for a, b in zip(single[arch], one)
                           for k in keys):
            raise AssertionError(
                f"(a) {arch} training on one NCCL rank is not bitwise the "
                f"single device: weights equal {same}; losses "
                f"{[(a['loss'], b['loss']) for a, b in zip(single[arch], one)]}")
        if not _tp_bitwise(nccl_serve, one_serve):
            raise AssertionError(f"(a) {arch} serving on one NCCL rank is not "
                                 "bitwise the single device")
        log(_train_line(f"sharded tp train (a) {arch}, 1 NCCL rank on (1, 1): "
                        "bitwise the single device", one, card))
        for layout in ("fsdp", "tp"):
            r = one_serve[layout]
            log(f"sharded tp serve (a) {arch} {layout}, one device "
                f"[{layers} layers; {card}]: prefill "
                f"{one_serve['prefill_ms']:.3f} ms, decode "
                f"{statistics.median(r['ms']):.3f} ms/token (steps "
                f"{[round(x, 3) for x in r['ms']]}), kernel launches "
                f"{r['kernel_launches']}; 1 NCCL rank on (1, 1) bitwise")
        launches[f"sharded_tp_{arch}_one_device_prefill"] = one_serve[
            "prefill_launches"]
        for layout in ("fsdp", "tp"):
            launches[f"sharded_tp_{arch}_one_device_{layout}"] = one_serve[
                layout]["kernel_launches"]
        feeds[arch] = {layout: [one_serve["tok0"].cpu()] + [
            t.cpu() for t in one_serve[layout]["tokens"][:-1]]
            for layout in ("fsdp", "tp")}
        refs[arch] = _to({k: one_serve[k] for k in ("hidden", "tok0")}
                         | {layout: {k: one_serve[layout][k] for k in
                                     ("logits", "tokens", "cache")}
                            for layout in ("fsdp", "tp")}, "cpu")
        del one_serve, nccl_serve, batch
        torch.cuda.empty_cache()

    ref_path = ROOT / "build" / "sharded_tp_ref.pt"
    ref_path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(refs, ref_path)
    del refs
    t0 = time.perf_counter()
    try:
        outs = run_ranks(_tp_rank, 4, backend="gloo", device=dev.type,
                         args=(dict(device=dev.type, ref=str(ref_path),
                                    batch=batches, prompt=prompts,
                                    feed=feeds),),
                         timeout_s=SHARDED_TIMEOUT_S)
    finally:
        ref_path.unlink(missing_ok=True)
    ranks_s = time.perf_counter() - t0
    r0 = next(o for o in outs if o["rank"] == 0)
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    for arch, layers in TP_SHARDED:
        cfg = _tp_cfg(arch, layers)
        g = r0[arch]
        steps = g["train"]
        for o in outs:
            if [(s["nll"], s["grad_norm"]) for s in o[arch]["train"]] != [
                    (s["nll"], s["grad_norm"]) for s in steps]:
                raise AssertionError(f"(b) {arch}: the ranks' nll or "
                                     "grad_norm differ")
        want = single[arch][0]
        gaps = {"loss": rel(steps[0]["loss"], want["loss"]),
                "grad_norm": rel(steps[0]["grad_norm"], want["grad_norm"])}
        if arch in TP_F32_GRAD:  # the bf16 grad_norm is printed, not held
            f32 = g["train_f32"]
            gaps["bf16 grad_norm, not held"] = gaps.pop("grad_norm")
            gaps["f32 loss"] = rel(f32["loss"], single_f32[arch]["loss"])
            gaps["grad_norm"] = rel(f32["grad_norm"],
                                    single_f32[arch]["grad_norm"])
        kinds = (("rglru_scan", "rglru_scan_bwd") if "rglru" in
                 cfg.block_pattern else ("rwkv6_scan", "rwkv6_scan_bwd_ds",
                                         "rwkv6_scan_bwd_chunk"))
        counts = {k: {o[arch]["train_launches"][k] for o in outs}
                  for k in kinds + ("fused_ce",)}
        ok = (gaps["loss"] <= TP_LOSS_TOL and gaps["grad_norm"] <= TP_GNORM_TOL
              and gaps.get("f32 loss", 0.0) <= TP_LOSS_TOL
              and all(np.isfinite([s["loss"], s["grad_norm"]]).all()
                      for o in outs for s in o[arch]["train"])
              and counts["fused_ce"] == {TP_TRAIN_STEPS}
              and all(min(v) > 0 for v in counts.values()))
        if not ok:
            raise AssertionError(
                f"(b) {arch} training on 4 gloo ranks: step 1 against the "
                f"single device {gaps} (limits {TP_LOSS_TOL}, "
                f"{TP_GNORM_TOL}), kernel launches a rank {counts}")
        launches[f"sharded_tp_{arch}_rank0_train"] = g["train_launches"]
        log(_train_line(
            f"sharded tp train (b) {arch}, 4 gloo ranks on one card, mesh "
            f"(data=2, model=2), rank 0 (step 1 against the single device: "
            f"{ {k: float(f'{v:.3g}') for k, v in gaps.items()} }); kernel "
            f"launches a rank over the {TP_TRAIN_STEPS} steps {counts}; peak "
            f"memory a rank "
            f"{[round(o[arch]['train_peak'] / 1e9, 2) for o in outs]} GB",
            steps, card))
        sg = g["gaps"]
        n_attn = sum(k == "attn" for k in layer_kinds(cfg))
        prefill = {o[arch]["serve"]["prefill_launches"][kinds[0]]
                   for o in outs}
        if min(prefill) != len(layer_kinds(cfg)) - n_attn and kinds[0] == (
                "rglru_scan"):
            raise AssertionError(f"(b) {arch}: prefill scan launches a rank "
                                 f"{prefill}")
        if min(prefill) == 0:
            raise AssertionError(f"(b) {arch}: a rank's prefill launched no "
                                 f"{kinds[0]}")
        for layout in ("fsdp", "tp"):
            lg = sg[layout]
            per_step = {x for o in outs
                        for x in o[arch]["serve"][layout]["launches"]}
            ok = (sg["hidden"] <= SERVE_TOL and sg["tok0_equal"]
                  and lg["logits"] <= SERVE_TOL and lg["cache"] <= SERVE_TOL
                  and lg["pos_equal"]
                  and 0 < lg["tokens_compared"] == lg["tokens_equal"]
                  and per_step == {n_attn})
            if not ok:
                raise AssertionError(
                    f"(b) {arch} {layout} on 4 gloo ranks against the single "
                    f"device: hidden {sg['hidden']:.3g}, first token equal "
                    f"{sg['tok0_equal']}, {lg} (limit {SERVE_TOL}), "
                    f"decode_attention a step {per_step} (want {n_attn})")
            s = g["serve"][layout]
            launches[f"sharded_tp_{arch}_rank0_{layout}"] = s[
                "kernel_launches"]
            log(f"sharded tp serve (b) {arch} {layout}, 4 gloo ranks on one "
                f"card, mesh (data=2, model=2), rank 0 [{layers} layers; "
                f"{card}]: prefill {g['serve']['prefill_ms']:.3f} ms, decode "
                f"{statistics.median(s['ms']):.3f} ms/token (steps "
                f"{[round(x, 3) for x in s['ms']]}), kernel launches "
                f"{s['kernel_launches']}, collectives of the last step "
                f"{s['collectives'][-1]}; against the single device: hidden "
                f"{sg['hidden']:.3g}, {lg} (limit {SERVE_TOL} of the largest "
                f"value); cache a rank {g['serve']['shapes'][0]}; peak memory "
                f"a rank {[round(o[arch]['serve']['peak'] / 1e9, 3) for o in outs]} GB")
        launches[f"sharded_tp_{arch}_rank0_prefill"] = g["serve"][
            "prefill_launches"]
    log(f"sharded tp: ranks' wall {ranks_s:.1f} s")
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
    t0 = start = time.perf_counter()

    def done(phase: str) -> None:  # where the run's time goes, phase by phase
        log(f"-- {phase}: done at {time.perf_counter() - start:.1f} s")
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
    sharded_attn = sharded_attention_phases(dev)
    family_shard_attn, family_shard_ce = family_shard_kernel_phases(dev)
    scan, scan_bwd = rglru_kernel_phases(dev)
    wkv = rwkv_kernel_phases(dev)
    wkv_bwd = rwkv_bwd_phases(dev)
    tp_scan, tp_scan_bwd, tp_wkv, tp_wkv_bwd, tp_ce, tp_attn = (
        tp_shard_kernel_phases(dev))
    scan, scan_bwd = scan + tp_scan, scan_bwd + tp_scan_bwd
    wkv, wkv_bwd = wkv + tp_wkv, wkv_bwd + tp_wkv_bwd
    ce, ce_grads = train_kernel_phases(dev)
    sp_ce, sp_ce_grads = sp_ce_phases(dev)
    wide = wide_kernel_phases(dev)
    done("kernel phases")
    launches = main_path(mnist)
    waits = step_syncs(mnist)
    if waits:
        raise AssertionError(f"the FlyMC step waits for the card: {waits}")
    done("main path")
    convergence_path()
    done("convergence path")
    gradient_path()
    exactness(mnist)
    hmc_launches = hmc_path(mnist)
    plain_engines(mnist)
    done("gradient, exactness, HMC, plain engines")
    del mnist
    torch.cuda.empty_cache()
    robust_launches, robust_err, theta_map = robust_path()
    torch.cuda.empty_cache()
    done("robust path")
    service_launches, service_err, service_jobs, service_res = service_path()
    torch.cuda.empty_cache()
    done("service path")
    restored_launches, chaos_err = checkpoint_path(service_jobs, service_res)
    torch.cuda.empty_cache()
    done("checkpoint path")
    vmap_mix_launches, vmap_launches, vmap_err = vmap_service_path(
        service_jobs, service_res)
    del service_jobs, service_res
    torch.cuda.empty_cache()
    done("vmap service path")
    dist_launches, dist_err = dist_path(theta_map)
    torch.cuda.empty_cache()
    done("dist path")

    decode_exactness(dev, ARCH, EXACT_BATCH, EXACT_PROMPT)
    serve_launches = serve_path(dev)
    rwkv_serve_exactness(dev)
    rwkv_launches = rwkv_serve_path(dev)
    torch.cuda.empty_cache()
    done("recurrentgemma and rwkv serving")
    dense_launches, dense_attn = dense_serve_path(dev)
    torch.cuda.empty_cache()
    done("dense serving")
    for arch, n_layers, batch, prompt in FAMILY_EXACT:
        decode_exactness(dev, arch, batch, prompt, n_layers)
    family_launches, family_attn = family_serve_path(dev)
    torch.cuda.empty_cache()
    done("MoE, encdec and VLM serving")
    ll_launches, ll_err = lastlayer_path(dev)
    torch.cuda.empty_cache()
    done("lastlayer path")

    train_launches, model, _ = train_path(dev)
    step_breakdown(model, dev)
    descent_check(model, dev)
    n_train = sum(p.numel() for p in model.parameters())
    del model
    torch.cuda.empty_cache()
    resumed_launches = train_resume_path(dev, n_train)
    torch.cuda.empty_cache()
    done("training")
    sp_launches, _ = train_sp_path(dev)
    torch.cuda.empty_cache()
    done("SP-mode training")
    rwkv_train_launches, _ = train_rwkv_path(dev)
    torch.cuda.empty_cache()
    done("rwkv6 training")
    sharded_launches, ce_shard = sharded_train_path(dev)
    torch.cuda.empty_cache()
    done("sharded training")
    serve_sharded_launches = sharded_serve_path(dev)
    torch.cuda.empty_cache()
    done("sharded serving")
    family_sharded_launches = sharded_family_path(dev)
    torch.cuda.empty_cache()
    done("sharded MoE, encdec and VLM")
    tp_launches = sharded_tp_path(dev)
    torch.cuda.empty_cache()
    done("sharded TP-mode archs")

    def tp_runs(kernel, arch, part=""):
        """The sharded TP-mode path's launches of ``kernel`` in each run of
        ``arch`` (whose name holds ``part``)."""
        return {f"launches_{run}": c[kernel] for run, c in tp_launches.items()
                if arch in run and part in run}

    for p in bright + z + scan + scan_bwd + wkv_bwd:
        one_kernel_a_call(p, "bright_glm_kernel" if p in bright
                          else "z_candidates_kernel" if p in z
                          else "rglru_scan_kernel" if p in scan
                          else "rglru_scan_bwd_kernel" if p in scan_bwd
                          else BWD_KERNELS)
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
         "launches_vmap_mix": vmap_mix_launches["bright_glm"],
         "launches_vmap_group": vmap_launches["bright_glm"],
         **{f"launches_{k}": v["bright_glm"] for k, v in dist_launches.items()},
         "max_abs_err": max([p["max_abs_err"] for p in bright]
                            + [robust_err, service_err, chaos_err, vmap_err,
                               dist_err]),
         "max_abs_err_robust": robust_err,
         "max_abs_err_service": service_err,
         "max_abs_err_chaos": chaos_err,
         "max_abs_err_vmap": vmap_err,
         "max_abs_err_dist": dist_err,
         "ms": main_b["ms"], "call_ms": main_b["call_ms"],
         "plain_ms": main_b["plain_ms"],
         "bound_ms": main_b["bound_ms"], "bound_by": main_b["bound_by"],
         "library_ms": None, "phases": bright},
        {"name": "bright_glm_wide", "route": "cuda",
         "source": "src/repro_torch/csrc/bright_glm.cu",
         "replaces": "src/repro/kernels/bright_glm/kernel.py:173",
         "launches": ll_launches["bright_glm_wide"],
         "max_abs_err": max([p["max_abs_err"] for p in wide] + [ll_err]),
         "max_abs_err_lastlayer": ll_err,
         "ms": wide[0]["ms"], "call_ms": wide[0]["call_ms"],
         "queued_ms": wide[0]["queued_ms"], "plain_ms": wide[0]["plain_ms"],
         "bound_ms": wide[0]["bound_ms"], "bound_by": wide[0]["bound_by"],
         "library_ms": None, "phases": wide},
        {"name": "z_update", "route": "cuda",
         "source": "src/repro_torch/csrc/z_update.cu",
         "replaces": "src/repro/kernels/z_update/kernel.py:129",
         "launches": launches["z_update"],
         "launches_lastlayer": ll_launches["z_update"],
         "launches_robust": robust_launches["z_update"],
         "launches_hmc": hmc_launches["z_update"],
         "launches_service": service_launches["z_update"],
         "launches_restored": restored_launches["z_update"],
         "launches_vmap_mix": vmap_mix_launches["z_update"],
         "launches_vmap_group": vmap_launches["z_update"],
         **{f"launches_{k}": v["z_update"] for k, v in dist_launches.items()},
         "max_abs_err": 0.0,
         "ms": main_z["ms"], "call_ms": main_z["call_ms"],
         "plain_ms": main_z["plain_ms"],
         "bound_ms": main_z["bound_ms"], "bound_by": main_z["bound_by"],
         "library_ms": None, "phases": z},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention/kernel.py:115",
         "launches": serve_launches["decode_attention"],
         **{f"launches_{a}": v for a, v in dense_launches.items()},
         **{f"launches_{a}": v for a, v in family_launches.items()},
         **{f"launches_{k}": v for k, v in serve_sharded_launches.items()},
         **{f"launches_{k}": v for k, v in
            family_sharded_launches["decode_attention"].items()},
         **{k: v for layout in ("_fsdp", "_tp") for k, v in
            tp_runs("decode_attention", "recurrentgemma", layout).items()},
         "max_abs_err": max(p["max_abs_err"] for p in attn + dense_attn
                            + family_attn + sharded_attn
                            + family_shard_attn + tp_attn),
         "merge_max_abs_err": max(sharded_attn[0]["merge_max_abs_err"],
                                  family_shard_attn[0]["merge_max_abs_err"]),
         "ms": attn[0]["ms"], "call_ms": attn[0]["call_ms"],
         "plain_ms": attn[0]["plain_ms"], "bound_ms": attn[0]["bound_ms"],
         "bound_by": attn[0]["bound_by"], "library_ms": attn[0]["library_ms"],
         "phases": attn + dense_attn + family_attn + sharded_attn
         + family_shard_attn + tp_attn},
        {"name": "rglru_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru_scan/kernel.py:61",
         "launches": serve_launches["rglru_scan"],
         "launches_train": train_launches["rglru_scan"],
         "launches_bwd_train": train_launches["rglru_scan_bwd"],
         "launches_resumed": resumed_launches["rglru_scan"],
         "launches_bwd_resumed": resumed_launches["rglru_scan_bwd"],
         **tp_runs("rglru_scan", "recurrentgemma"),
         **{k.replace("launches_", "launches_bwd_"): v for k, v in
            tp_runs("rglru_scan_bwd", "recurrentgemma", "_train").items()},
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
         "launches_train": rwkv_train_launches["rwkv6_scan"],
         "launches_bwd_train": rwkv_train_launches["rwkv6_scan_bwd"],
         **tp_runs("rwkv6_scan", "rwkv6"),
         "max_abs_err": max(p["max_abs_err"] for p in wkv + wkv_bwd),
         "ms": wkv[0]["ms"], "call_ms": wkv[0]["call_ms"],
         "plain_ms": wkv[0]["plain_ms"], "bound_ms": wkv[0]["bound_ms"],
         "bound_by": wkv[0]["bound_by"], "library_ms": None,
         "bwd_ms": wkv_bwd[0]["bwd_ms"],
         "bwd_call_ms": wkv_bwd[0]["bwd_call_ms"],
         "bwd_bound_ms": wkv_bwd[0]["bound_ms"],
         "bwd_plain_ms": wkv_bwd[0]["bwd_plain_ms"],
         "phases": wkv + wkv_bwd},
        *({"name": f"rwkv6_scan_bwd_{part}", "route": "cuda",
           "source": "src/repro_torch/csrc/rwkv6_scan.cu",
           "replaces": "src/repro/models/layers.py:499 (the VJP JAX derives "
                       "from _wkv_chunk; the backward of "
                       "src/repro/kernels/rwkv6_scan/kernel.py:91)",
           "launches": rwkv_train_launches[f"rwkv6_scan_bwd_{part}"],
           **tp_runs(f"rwkv6_scan_bwd_{part}", "rwkv6", "_train"),
           "max_abs_err": max(p[f"max_abs_err_{part}"] for p in wkv_bwd),
           "ms": wkv_bwd[0][f"{part}_ms"],
           "plain_ms": wkv_bwd[0][f"{part}_plain_ms"],
           "bound_ms": wkv_bwd[0][f"{part}_bound_ms"],
           "bound_by": wkv_bwd[0][f"{part}_bound_by"], "library_ms": None,
           "phases": [{k_: p[k_] for k_ in ("phase", "S", f"{part}_ms",
                                            f"max_abs_err_{part}")}
                      for p in wkv_bwd]}
          for part in ("ds", "chunk")),
        {"name": "fused_ce", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_ce.cu",
         "replaces": "src/repro/kernels/fused_ce/kernel.py:88",
         "launches": train_launches["fused_ce"],
         "launches_resumed": resumed_launches["fused_ce"],
         "launches_train_rwkv6-7b": rwkv_train_launches["fused_ce"],
         **{f"launches_train_{a}": v for a, v in sp_launches.items()},
         **{f"launches_{k}": v for k, v in sharded_launches.items()},
         **{f"launches_{k}": v for k, v in
            family_sharded_launches["fused_ce"].items()},
         **{k: v for arch in ("recurrentgemma", "rwkv6") for k, v in
            tp_runs("fused_ce", arch, "_train").items()},
         "max_abs_err": max(p["max_abs_err"] for p in ce + sp_ce
                            + [ce_shard] + family_shard_ce + tp_ce),
         "ms": ce[0]["ms"], "call_ms": ce[0]["call_ms"],
         "plain_ms": ce[0]["plain_ms"], "bound_ms": ce[0]["bound_ms"],
         "bound_by": ce[0]["bound_by"], "library_ms": ce[0]["library_ms"],
         "phases": ce + ce_grads + sp_ce + sp_ce_grads + [ce_shard]
         + family_shard_ce + tp_ce},
    ]}
    log(card)  # as nvidia-smi prints it: name, power limit
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
