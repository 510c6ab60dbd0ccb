// bright_glm.cu — fused gather + bound-corrected likelihood (FlyMC θ-update).
//
// Replaces the TPU kernel repro/kernels/bright_glm/kernel.py
// (bright_glm_pallas_chains, its pallas_call at kernel.py:173).
//
// Chains may come in lanes: a lane is one dataset (x, t, ξ) with its own
// chains, L lanes of K chains each, so one launch evaluates L·K chains on L
// datasets (the sampling service's "vmap" lanes). Chain k = l·K + j reads
// lane l's dataset and its own idx row; one dataset shared by every chain is
// the case L = 1, the same launch as before the lane axis. A chain's blocks,
// and the order of its sums, do not depend on L or on its neighbours, so
// L·K chains in one launch are bitwise L launches of K chains.
//
// For chain k and buffer slot c it gathers the row x[idx[k, c]], forms
// s = θ_k·x (logistic, Student-t) or η = Θ_k x (softmax), computes
// δ = log L − log B with the formulas of repro_torch/core/numerics.py (same
// branch structure, full-precision expm1f/log1pf/tanhf/logf — no fast math,
// because δ feeds accept decisions) and the per-chain total
// Σ_{c < n_bright[k]} log_expm1(δ).
//
// What bounds it on an H100: per slot it reads one index, one row of D
// floats, t and ξ, and writes one δ — K·C·(4D + 12) bytes, under 0.1 µs over
// 3.35 TB/s at the main path's C = 512 and D = 51 — and does 2·D·Kt flops.
// Neither comes near the cost of a launch, so at the main path's sizes the
// kernel's floor is launch latency, and the design spends one launch a call:
//   * one block per (chain, tile of BR = 8 rows), one warp per row; lanes
//     stride over D so each row load is contiguous across the warp, and the
//     dot products reduce with warp shuffles (a fixed butterfly order);
//   * θ_k (Kt × D floats) is staged once per block in shared memory;
//   * indices are clamped into [0, N) in the kernel: buffer padding and the
//     candidate buffer's sentinel N would otherwise read past x;
//   * the TPU kernel's running total over a sequential grid has no GPU
//     counterpart, and float atomics would make the sum depend on block
//     order. Each block writes its partial (its BR rows summed in row order),
//     fences, and takes a ticket from its chain's arrival counter (an integer
//     atomic). The block that draws the chain's last ticket sums the chain's
//     partials in block order and writes the total, in the same launch. With
//     BR fixed, valid rows always fall into the same blocks and padded rows
//     add exactly +0.0, so the total — and the chain — is bitwise independent
//     of the buffer capacity, of the number of chains and of the order in
//     which blocks run;
//   * the arrival counters are a persistent int32 workspace (one per chain,
//     zeroed once by the wrapper). The last block resets its chain's counter
//     to 0, so the workspace is clean for the next call without a memset
//     launch. Calls on one stream run one after another and may share a
//     workspace; two calls in flight at once on one workspace (two streams,
//     or two host threads, sharing it) are not supported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockRows = 8;   // rows (warps) per block; fixes the sum order
constexpr int kMaxClasses = 16; // softmax classes held in registers

enum Family { kLogistic = 0, kStudentT = 1, kSoftmax = 2 };

__device__ __forceinline__ float log_expm1(float delta) {
  float d = fmaxf(delta, 1e-10f);
  if (d < 15.0f) return logf(expm1f(d));
  return d + log1pf(-expf(-fminf(d, 80.0f)));
}

// jax.nn.softplus = logaddexp(x, 0).
__device__ __forceinline__ float softplus(float x) {
  if (isnan(x)) return x;
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float jj_a(float xi) {
  if (fabsf(xi) < 1e-4f) return -0.125f + xi * xi / 96.0f;
  return -tanhf(xi / 2.0f) / (4.0f * xi);
}

__device__ __forceinline__ float logistic_delta(float s, float xi) {
  float a = jj_a(xi);
  float c = -a * xi * xi + xi / 2.0f - softplus(xi);
  float log_l = -softplus(-s);
  float log_b = a * s * s + 0.5f * s + c;
  return log_l - log_b;
}

__device__ __forceinline__ float student_t_delta(float r, float xi, float nu,
                                                 float sigma, float h) {
  float zs = r / sigma;
  float z2 = zs * zs;
  float us = xi / sigma;
  float u0 = us * us;
  float fprime = -h / (nu + u0);
  float f_z = -h * log1pf(z2 / nu);
  float f_u0 = -h * log1pf(u0 / nu);
  return f_z - (f_u0 + fprime * (z2 - u0));
}

__device__ float softmax_delta(const float* eta, const float* eta0, int t,
                               int kc) {
  float m = -1e30f, m0 = -1e30f;
  for (int j = 0; j < kc; ++j) {
    m = fmaxf(m, eta[j]);
    m0 = fmaxf(m0, eta0[j]);
  }
  float se = 0.0f, se0 = 0.0f;
  for (int j = 0; j < kc; ++j) {
    se += expf(eta[j] - m);
    se0 += expf(eta0[j] - m0);
  }
  float lse = m + logf(se);
  float lse0 = m0 + logf(se0);
  float dsum = 0.0f;
  for (int j = 0; j < kc; ++j) dsum += eta[j] - eta0[j];
  float gd = 0.0f, quad = 0.0f;
  for (int j = 0; j < kc; ++j) {
    float d = eta[j] - eta0[j];
    float g = (j == t ? 1.0f : 0.0f) - expf(eta0[j] - lse0);
    gd += g * d;
    quad += d * (0.5f * (d - dsum / kc));
  }
  float ll_eta = eta[t] - lse;
  float ll_eta0 = eta0[t] - lse0;
  return ll_eta - (ll_eta0 + gd - 0.5f * quad);
}

// grid (ceil(C / BR), L·K), block BR warps; dynamic shared memory Kt·D
// floats. Lane l's dataset starts at x + l·x_lane, t + l·t_lane and
// xi + l·xi_lane (elements); chain (l, j)'s slots at idx + l·idx_lane +
// j·idx_stride. Every per-chain operand and output is indexed by the flat
// chain k = l·K + j.
__global__ void __launch_bounds__(kBlockRows * 32)
bright_glm_kernel(const float* __restrict__ x, const void* __restrict__ t,
                  const float* __restrict__ xi,
                  const int32_t* __restrict__ idx, int64_t idx_stride,
                  const int64_t* __restrict__ n_bright,
                  const float* __restrict__ theta, float* __restrict__ delta,
                  float* __restrict__ partials, float* __restrict__ total,
                  unsigned int* __restrict__ arrivals, int C, int N, int D,
                  int kt, int family, float nu, float sigma, float h,
                  int lane_chains, int64_t x_lane, int64_t t_lane,
                  int64_t xi_lane, int64_t idx_lane) {
  extern __shared__ float th[];
  __shared__ float contrib[kBlockRows];
  __shared__ bool last;
  const int k = blockIdx.y;
  const int ln = k / lane_chains;  // the chain's lane and its place there
  const int j = k - ln * lane_chains;
  x += ln * x_lane;
  xi += ln * xi_lane;
  const int tile = blockIdx.x;
  const int nblk = gridDim.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // The loads that do not wait on θ go first, so their latencies overlap
  // the staging of θ: this row's index, the chain's bright count, then the
  // row's t and ξ for lane 0.
  const int c = tile * kBlockRows + warp;
  const bool valid = c < C;
  int r = 0;
  if (valid)
    r = min(max(idx[ln * idx_lane + (int64_t)j * idx_stride + c], 0), N - 1);
  const int64_t nb = n_bright[k];
  const float* th_k = theta + (int64_t)k * kt * D;
  for (int i = threadIdx.x; i < kt * D; i += blockDim.x) th[i] = th_k[i];
  float tv = 0.0f, xv = 0.0f;
  int tc = 0;
  if (valid && lane == 0) {
    if (family == kSoftmax) {
      tc = (int)static_cast<const int64_t*>(t)[ln * t_lane + r];
    } else {
      tv = static_cast<const float*>(t)[ln * t_lane + r];
      xv = xi[r];
    }
  }
  __syncthreads();

  float part = 0.0f;
  if (valid) {
    const float* row = x + (int64_t)r * D;
    float acc[kMaxClasses];
#pragma unroll
    for (int j = 0; j < kMaxClasses; ++j) acc[j] = 0.0f;
    for (int d = lane; d < D; d += 32) {
      const float xd = row[d];
#pragma unroll
      for (int j = 0; j < kMaxClasses; ++j)
        if (j < kt) acc[j] += xd * th[j * D + d];
    }
#pragma unroll
    for (int j = 0; j < kMaxClasses; ++j) {
      if (j < kt) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
      }
    }
    if (lane == 0) {
      float dl;
      if (family == kSoftmax) {
        dl = softmax_delta(acc, xi + (int64_t)r * kt, tc, kt);
      } else {
        dl = family == kLogistic ? logistic_delta(tv * acc[0], xv)
                                 : student_t_delta(tv - acc[0], xv, nu, sigma, h);
      }
      delta[(int64_t)k * C + c] = dl;
      if (c < nb) part = log_expm1(dl);
    }
  }
  if (lane == 0) contrib[warp] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = contrib[0];
    for (int w = 1; w < kBlockRows; ++w) s += contrib[w];
    partials[(int64_t)k * nblk + tile] = s;
    __threadfence();  // release: the partial is visible before the ticket
    last = atomicAdd(&arrivals[k], 1u) == (unsigned int)(nblk - 1);
  }
  __syncthreads();
  if (!last || warp != 0) return;

  // The chain's last block: every partial of chain k has been written and
  // fenced before its ticket. Sum them in block order: the warp loads 128
  // partials at a time (from L2, past this SM's L1) and every lane adds them
  // in index order (shuffle broadcast, unrolled so the shuffles run ahead of
  // the dependent adds), so the order is sequential whatever the block
  // count.
  __threadfence();  // acquire
  const float* p = partials + (int64_t)k * nblk;
  constexpr int kChunks = 4;
  float s = 0.0f;
  for (int base = 0; base < nblk; base += 32 * kChunks) {
    float v[kChunks];
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int i = base + 32 * q + lane;
      v[q] = i < nblk ? __ldcg(p + i) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int i = base + 32 * q + j;
        const float w = __shfl_sync(0xffffffffu, v[q], j);
        if (i < nblk) s = i == 0 ? w : s + w;
      }
    }
  }
  if (lane == 0) {
    total[k] = s;
    arrivals[k] = 0u;  // clean for the next call on this workspace
  }
}

}  // namespace

// K is the chain count of every lane, L the lane count: L·K chains in all.
// One lane (L = 1, the lane strides unused) is the single-dataset call.
extern "C" int bright_glm_launch(const float* x, const void* t,
                                 const float* xi, const int32_t* idx,
                                 int64_t idx_stride, const int64_t* n_bright,
                                 const float* theta, float* delta,
                                 float* partials, float* total,
                                 unsigned int* arrivals, int K, int C, int N,
                                 int D, int kt, int family, float nu,
                                 float sigma, float h, int L, int64_t x_lane,
                                 int64_t t_lane, int64_t xi_lane,
                                 int64_t idx_lane, void* stream) {
  if (kt > kMaxClasses || C <= 0 || K <= 0 || L <= 0 ||
      (int64_t)L * K > 65535)
    return (int)cudaErrorInvalidValue;
  const int nblk = (C + kBlockRows - 1) / kBlockRows;
  size_t smem = (size_t)kt * D * sizeof(float);
  bright_glm_kernel<<<dim3(nblk, L * K), kBlockRows * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      x, t, xi, idx, idx_stride, n_bright, theta, delta, partials, total,
      arrivals, C, N, D, kt, family, nu, sigma, h, K, x_lane, t_lane,
      xi_lane, idx_lane);
  return (int)cudaGetLastError();
}

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
