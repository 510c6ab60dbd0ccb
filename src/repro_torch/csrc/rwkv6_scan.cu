// rwkv6_scan.cu — the chunked WKV6 recurrence of the RWKV6 time mix.
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan/kernel.py (rwkv6_pallas,
// its pallas_call at kernel.py:91), and adds what the model path needs and
// that kernel lacks: a carried-in state (state0), so a prefill cut into time
// chunks continues the recurrence from one time chunk to the next.
//
// For batch row b and head h it sweeps the sequence in chunks of c steps
// (1 <= c <= 64, S % c == 0) from S₀ = state0 (or zeros) and computes, per
// chunk, the closed form of kernels/rwkv6_scan/ref.py::wkv_chunk (the
// model's _wkv_chunk), with the same operations in the same order where it
// can:
//   logp = cumsum(logw) inclusive (sequential, one thread per column),
//   rq = r·exp(logp - logw), kk = k·exp(-logp), k2 = k·exp(logp_c - logp),
//   y  = tril_strict(rq·kkᵀ)·v + rq·S₀ + diag(r·u·k)·v,
//   S' = S₀·diag(exp(logp_c)) + k2ᵀ·v   (S is key × value),
// writes y (B, H, S, D) chunk by chunk and the final state (B, H, D, D)
// once. The model clips logw to [-1, -1e-6], so e^{±logp} stays within
// e^{±64}, inside float32; the strictly upper part of rq·kkᵀ is computed
// and replaced by 0, never multiplied by a mask.
//
// What bounds it on an H100: bytes, narrowly. Each chunk of each head needs
// c(c-1)·D + 2·c·D² float32 FMAs (the strictly lower triangles of rq·kkᵀ
// and of A·v, then rq·S₀ and k2ᵀ·v) against 4 c×D inputs and a c×D
// output: at the serving path's B=4, H=64, S=512, D=64, c=64 that is
// 3.2 GFLOP ≈ 0.048 ms at 67 TFLOP/s on the CUDA cores, under the 176 MB
// of traffic ≈ 0.053 ms at 3.35 TB/s. This first version computes the
// full c×c square of rq·kkᵀ and is right and simple:
//   - one CTA of kThreads threads per (b, h); the D×D state stays in
//     shared memory for the whole sweep over chunks;
//   - per chunk, r, k, v and logw are staged in shared memory (rows padded
//     to kLd = 65 floats, so lanes that walk a column hit distinct banks);
//   - each product is register-tiled one way: a thread owns one output
//     column and up to kMaxRows rows, reads the column's operand once per
//     step of the sum and the row operand as a shared-memory broadcast;
//   - ~100 KB of shared memory, so two CTAs share an SM and the 256 CTAs
//     of the serving path run in one wave on 128 of the 132 SMs.
// No atomics: each CTA owns its outputs, so results are the same run to
// run. Tensor cores (wgmma) for the four products, TMA staging with the next
// chunk's loads in flight, and a split over chunks are left to a later
// change.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 64;  // head dim
constexpr int kMaxC = 64;  // chunk length
constexpr int kLd = 65;  // padded row stride of every shared matrix
constexpr int kTile = kMaxC * kLd;  // floats of one c×D (or c×c) matrix
constexpr int kMaxRows = 16;  // rows a thread owns: kMaxC / (kThreads / 64)
// Shared memory: S, RQ, K (→ k2), V, KK, LA (logw → logp → A), then
// diag (c), p_end (D) and u (D).
constexpr int kSmemFloats = 6 * kTile + kMaxC + 2 * kMaxD;
constexpr int kSmemBytes = 4 * kSmemFloats;

__global__ void __launch_bounds__(kThreads, 2) rwkv6_scan_kernel(
    const float* __restrict__ r,  // (B, H, S, D)
    const float* __restrict__ k,
    const float* __restrict__ v,
    const float* __restrict__ logw,
    const float* __restrict__ u,  // (H, D)
    const float* __restrict__ state0,  // (B, H, D, D) or null
    float* __restrict__ y,  // (B, H, S, D)
    float* __restrict__ state_out,  // (B, H, D, D)
    int H, int S, int D, int c) {
  extern __shared__ float smem[];
  float* st = smem;  // D × D, st[d·kLd + e]
  float* rq = st + kTile;  // c × D: r, then rq
  float* kb = rq + kTile;  // c × D: k, then k2
  float* vb = kb + kTile;  // c × D
  float* kk = vb + kTile;  // c × D
  float* la = kk + kTile;  // c × D logw → logp, then c × c A
  float* diag = la + kTile;  // c
  float* pend = diag + kMaxC;  // D
  float* us = pend + kMaxD;  // D

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int h = bh % H;
  const size_t seq_base = (size_t)bh * S * D;
  const size_t st_base = (size_t)bh * D * D;

  for (int i = tid; i < D * D; i += kThreads) {
    const int d = i / D, e = i % D;
    st[d * kLd + e] = state0 ? state0[st_base + i] : 0.f;
  }
  for (int d = tid; d < D; d += kThreads) us[d] = u[(size_t)h * D + d];

  // Thread layout of the products whose output column runs over D (y and
  // S'): column e = tid % D, rows g, g + ng, g + 2·ng, ...
  const int ng_d = kThreads / D;
  const int g_d = tid / D, e_d = tid % D;
  // ... and of rq·kkᵀ, whose output column runs over the chunk.
  const int ng_c = kThreads / c;
  const int g_c = tid / c, j_c = tid % c;

  for (int t0 = 0; t0 < S; t0 += c) {
    // 0. stage the chunk (c × D contiguous floats of each input)
    const size_t off = seq_base + (size_t)t0 * D;
#pragma unroll 4
    for (int i = tid; i < c * D; i += kThreads) {
      const int row = i / D, col = i % D;
      const int s = row * kLd + col;
      rq[s] = r[off + i];
      kb[s] = k[off + i];
      vb[s] = v[off + i];
      la[s] = logw[off + i];
    }
    __syncthreads();

    // 1. bonus term diag_i = Σ_d r_id·u_d·k_id, one thread per row
    if (tid < c) {
      float acc = 0.f;
      for (int d = 0; d < D; ++d)
        acc += rq[tid * kLd + d] * us[d] * kb[tid * kLd + d];
      diag[tid] = acc;
    }
    __syncthreads();

    // 2. cumulative log decay down each column, and the decay-scaled
    //    operands: rq, kk, p_end and k2 (in place of r and k)
    if (tid < D) {
      const int d = tid;
      float run = 0.f;
      for (int i = 0; i < c; ++i) {
        const int s = i * kLd + d;
        const float lw = la[s];
        run = run + lw;
        la[s] = run;
        rq[s] = rq[s] * expf(run - lw);
        kk[s] = kb[s] * expf(-run);
      }
      pend[d] = expf(run);
      for (int i = 0; i < c; ++i) {
        const int s = i * kLd + d;
        kb[s] = kb[s] * expf(run - la[s]);
      }
    }
    __syncthreads();

    // 3. A = tril_strict(rq·kkᵀ), written over logp
    if (g_c < ng_c) {
      float acc[kMaxRows];
#pragma unroll
      for (int m = 0; m < kMaxRows; ++m) acc[m] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float kv = kk[j_c * kLd + d];
#pragma unroll
        for (int m = 0; m < kMaxRows; ++m) {
          const int i = g_c + ng_c * m;
          if (i < c) acc[m] += rq[i * kLd + d] * kv;
        }
      }
#pragma unroll
      for (int m = 0; m < kMaxRows; ++m) {
        const int i = g_c + ng_c * m;
        if (i < c) la[i * kLd + j_c] = j_c < i ? acc[m] : 0.f;
      }
    }
    __syncthreads();

    // 4. y = A·v + rq·S₀ + diag·v
    if (g_d < ng_d) {
      float av[kMaxRows], rs[kMaxRows];
#pragma unroll
      for (int m = 0; m < kMaxRows; ++m) av[m] = rs[m] = 0.f;
      for (int j = 0; j < c; ++j) {
        const float vv = vb[j * kLd + e_d];
#pragma unroll
        for (int m = 0; m < kMaxRows; ++m) {
          const int i = g_d + ng_d * m;
          if (i < c) av[m] += la[i * kLd + j] * vv;
        }
      }
      for (int d = 0; d < D; ++d) {
        const float sv = st[d * kLd + e_d];
#pragma unroll
        for (int m = 0; m < kMaxRows; ++m) {
          const int i = g_d + ng_d * m;
          if (i < c) rs[m] += rq[i * kLd + d] * sv;
        }
      }
#pragma unroll
      for (int m = 0; m < kMaxRows; ++m) {
        const int i = g_d + ng_d * m;
        if (i < c)
          y[off + (size_t)i * D + e_d] =
              (av[m] + rs[m]) + diag[i] * vb[i * kLd + e_d];
      }
    }
    __syncthreads();  // every read of S₀ is done before it is overwritten

    // 5. S' = S₀·diag(p_end) + k2ᵀ·v
    if (g_d < ng_d) {
      float acc[kMaxRows];
#pragma unroll
      for (int m = 0; m < kMaxRows; ++m) acc[m] = 0.f;
      for (int j = 0; j < c; ++j) {
        const float vv = vb[j * kLd + e_d];
#pragma unroll
        for (int m = 0; m < kMaxRows; ++m) {
          const int d = g_d + ng_d * m;
          if (d < D) acc[m] += kb[j * kLd + d] * vv;
        }
      }
#pragma unroll
      for (int m = 0; m < kMaxRows; ++m) {
        const int d = g_d + ng_d * m;
        if (d < D) {
          const int s = d * kLd + e_d;
          st[s] = st[s] * pend[d] + acc[m];
        }
      }
    }
    __syncthreads();  // the next chunk's loads overwrite k2 and v
  }

  for (int i = tid; i < D * D; i += kThreads) {
    const int d = i / D, e = i % D;
    state_out[st_base + i] = st[d * kLd + e];
  }
}

}  // namespace

extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* logw, const void* u,
                                 const void* state0, void* y, void* state_out,
                                 int B, int H, int S, int D, int c,
                                 void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || D <= 0 || D > kMaxD || c <= 0 ||
      c > kMaxC || S % c != 0 || (long long)B * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;  // opt in to > 48 KB of shared memory once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        rwkv6_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  rwkv6_scan_kernel<<<B * H, kThreads, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(state0),
      static_cast<float*>(y), static_cast<float*>(state_out), H, S, D, c);
  return static_cast<int>(cudaGetLastError());
}
