// bright_glm.cu — fused gather + bound-corrected likelihood (FlyMC θ-update).
//
// Replaces the TPU kernel repro/kernels/bright_glm/kernel.py
// (bright_glm_pallas_chains, its pallas_call at kernel.py:173).
//
// For chain k and buffer slot c it gathers the row x[idx[k, c]], forms
// s = θ_k·x (logistic, Student-t) or η = Θ_k x (softmax), computes
// δ = log L − log B with the formulas of repro_torch/core/numerics.py (same
// branch structure, full-precision expm1f/log1pf/tanhf/logf — no fast math,
// because δ feeds accept decisions) and the per-chain total
// Σ_{c < n_bright[k]} log_expm1(δ).
//
// What bounds it on an H100: bytes. Per slot it reads one index, one row of
// D floats, t and ξ, and writes one δ: K·C·(4 + 4D + 8) bytes in and K·C·4
// out, a few microseconds at most over 3.35 TB/s at C = 512. At the main
// path's sizes the kernel is far below that, so launch latency is its real
// floor. The design follows:
//   * one block per (chain, tile of BR = 8 rows), one warp per row; lanes
//     stride over D so each row load is contiguous across the warp, and the
//     dot products reduce with warp shuffles (a fixed butterfly order);
//   * θ_k (Kt × D floats) is staged once per block in shared memory;
//   * indices are clamped into [0, N) in the kernel: buffer padding and the
//     candidate buffer's sentinel N would otherwise read past x;
//   * the TPU kernel's running total over a sequential grid has no GPU
//     counterpart, and float atomics would make the sum depend on block
//     order. Each block writes its partial (its BR rows summed in row order)
//     and a second tiny launch sums the partials of each chain in block
//     order. With BR fixed, valid rows always fall into the same blocks and
//     padded rows add exactly +0.0, so the total — and the chain — is bitwise
//     independent of the buffer capacity and of the number of chains.

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

// grid (ceil(C / BR), K), block BR warps; dynamic shared memory Kt·D floats.
__global__ void bright_glm_rows(const float* __restrict__ x,
                                const void* __restrict__ t,
                                const float* __restrict__ xi,
                                const int32_t* __restrict__ idx,
                                int64_t idx_stride,
                                const int64_t* __restrict__ n_bright,
                                const float* __restrict__ theta,
                                float* __restrict__ delta,
                                float* __restrict__ partials, int C, int N,
                                int D, int kt, int family, float nu,
                                float sigma, float h) {
  extern __shared__ float th[];
  __shared__ float contrib[kBlockRows];
  const int k = blockIdx.y;
  const int tile = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const float* th_k = theta + (int64_t)k * kt * D;
  for (int i = threadIdx.x; i < kt * D; i += blockDim.x) th[i] = th_k[i];
  __syncthreads();

  const int c = tile * kBlockRows + warp;
  float part = 0.0f;
  if (c < C) {
    int r = idx[(int64_t)k * idx_stride + c];
    r = min(max(r, 0), N - 1);
    const float* row = x + (int64_t)r * D;
    float acc[kMaxClasses];
#pragma unroll
    for (int j = 0; j < kMaxClasses; ++j) acc[j] = 0.0f;
    for (int d = lane; d < D; d += 32) {
      float xv = row[d];
#pragma unroll
      for (int j = 0; j < kMaxClasses; ++j)
        if (j < kt) acc[j] += xv * th[j * D + d];
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
        int tc = (int)static_cast<const int64_t*>(t)[r];
        dl = softmax_delta(acc, xi + (int64_t)r * kt, tc, kt);
      } else {
        float tv = static_cast<const float*>(t)[r];
        float xv = xi[r];
        dl = family == kLogistic ? logistic_delta(tv * acc[0], xv)
                                 : student_t_delta(tv - acc[0], xv, nu, sigma, h);
      }
      delta[(int64_t)k * C + c] = dl;
      if (c < n_bright[k]) part = log_expm1(dl);
    }
  }
  if (lane == 0) contrib[warp] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = contrib[0];
    for (int w = 1; w < kBlockRows; ++w) s += contrib[w];
    partials[(int64_t)k * gridDim.x + tile] = s;
  }
}

// grid K, one warp: sums each chain's block partials in block order. The
// warp loads 32 partials at a time and every lane adds them in index order
// (shuffle broadcast), so the order is sequential whatever the block count.
__global__ void bright_glm_total(const float* __restrict__ partials,
                                 float* __restrict__ total, int nblk) {
  const int k = blockIdx.x;
  const int lane = threadIdx.x;
  const float* p = partials + (int64_t)k * nblk;
  float s = 0.0f;
  for (int base = 0; base < nblk; base += 32) {
    float v = base + lane < nblk ? p[base + lane] : 0.0f;
    int m = min(32, nblk - base);
    for (int j = 0; j < m; ++j) {
      float w = __shfl_sync(0xffffffffu, v, j);
      s = (base + j == 0) ? w : s + w;
    }
  }
  if (lane == 0) total[k] = s;
}

}  // namespace

extern "C" int bright_glm_launch(const float* x, const void* t,
                                 const float* xi, const int32_t* idx,
                                 int64_t idx_stride, const int64_t* n_bright,
                                 const float* theta, float* delta,
                                 float* partials, float* total, int K, int C,
                                 int N, int D, int kt, int family, float nu,
                                 float sigma, float h, void* stream) {
  if (kt > kMaxClasses || C <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = (C + kBlockRows - 1) / kBlockRows;
  dim3 grid(nblk, K);
  size_t smem = (size_t)kt * D * sizeof(float);
  bright_glm_rows<<<grid, kBlockRows * 32, smem, s>>>(
      x, t, xi, idx, idx_stride, n_bright, theta, delta, partials, C, N, D,
      kt, family, nu, sigma, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bright_glm_total<<<K, 32, 0, s>>>(partials, total, nblk);
  return (int)cudaGetLastError();
}

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
