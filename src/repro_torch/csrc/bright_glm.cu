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

// Σ p[0..nblk) in index order by one warp: the warp loads 128 partials at a
// time (from L2, past this SM's L1) and every lane adds them in index order
// (shuffle broadcast, unrolled so the shuffles run ahead of the dependent
// adds), so the order is sequential whatever the block count. Every lane
// returns the sum.
__device__ __forceinline__ float sum_in_block_order(const float* p, int nblk,
                                                    int lane) {
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
  return s;
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
  // fenced before its ticket.
  __threadfence();  // acquire
  const float s = sum_in_block_order(partials + (int64_t)k * nblk, nblk, lane);
  if (lane == 0) {
    total[k] = s;
    arrivals[k] = 0u;  // clean for the next call on this workspace
  }
}


// ---------------------------------------------------------------------------
// The wide softmax path: any class count (an LM head's vocabulary).
// ---------------------------------------------------------------------------
//
// Past kMaxClasses, or where Θ_k does not fit shared memory, one chain's Θ is
// streamed instead of staged: at an LM head (Kc = 128,256, D = 3,072) it is
// 1.58 GB. Work layout:
//   * a CTA takes a tile of kWideRows bright rows of one chain and one split
//     of kWideSplit classes, which it walks in tiles of kWideTile classes.
//     For each tile its rows' features and the tile's Θ rows go through
//     shared memory in chunks of kWideChunk features, and each thread forms
//     η for 8 rows × 8 classes (warp w: rows 8w..8w+7, a broadcast float4
//     pair; lane l: classes l, l + 32, ..., l + 224), each a sequential FMA
//     chain over D. The tile's η goes to shared memory;
//   * 4 threads a row then fold the tile into per-row running statistics,
//     each over the classes p, p + 4, ... of the tile (its part p), in one
//     pass: an online logsumexp of η (m, s); an online logsumexp of η0 with
//     w = Σ e^{η0 − m0}·d, d = η − η0 (m0, s0, w); Welford's count, mean and
//     M2 = Σ (d − d̄)² of d (n, mean, M2); and η_t, η0_t where the class is
//     the row's label. M2 is the Böhning quadratic's Σ d·(d − Σd/K) without
//     the cancellation of Σd² − (Σd)²/K over 10⁵ classes;
//   * after the split, a row's 4 threads merge by a fixed butterfly of
//     shuffles (Chan's merge for the Welford triple, a rescaled sum for the
//     logsumexps), and the split's statistics go to a workspace;
//   * each (chain, row tile) has an arrival counter: the CTA that draws the
//     tile's last ticket merges the splits' statistics in split order, forms
//     δ = (η_t − lse) − [(η0_t − lse0) + (d_t − w/s0) − ½·quad], quad =
//     ½·M2 (numerics.softmax_delta_padded's formula), writes δ and the
//     tile's 8-row partials of Σ log_expm1(δ), and takes a ticket from the
//     chain's counter; the chain's last tile sums the partials in block
//     order, as the register kernel does.
// Every class reduction runs in an order fixed by Kc alone (tile, split,
// part and butterfly), and a row's δ does not depend on the other rows, so
// δ and the total are bitwise independent of C, K, L and the capacity. The
// counters are persistent workspaces left zeroed by every call. Two CTAs
// (2 × 105.6 KiB of shared memory, ≤ 128 registers a thread) share an SM.

constexpr int kWideRows = 64;     // bright rows a CTA: 8 warps × 8
constexpr int kWideTile = 256;    // classes a tile: 32 lanes × 8
constexpr int kWideChunk = 32;    // features a shared-memory stage
constexpr int kWideSplit = 2048;  // classes a CTA: fixes the merge order
constexpr int kWideThreads = 256;
constexpr int kWideParts = kWideThreads / kWideRows;  // threads a row
constexpr int kWideStats = 10;    // m s m0 s0 w n mean M2 eta_t eta0_t
// Shared-memory row strides: x chunk rows float4-aligned (stores at most
// 4-way conflicted), Θ chunk and η tile conflict-free for their readers.
constexpr int kXsStride = kWideRows + 4;
constexpr int kThsStride = kWideTile + 1;
constexpr int kEsStride = kWideTile + 4;
constexpr int kWideSmemFloats = kWideChunk * kXsStride +
                                kWideChunk * kThsStride +
                                kWideRows * kEsStride;

struct RowStats {
  float m, s, m0, s0, w, n, mean, m2, et, e0t;
};

__device__ __forceinline__ void stats_init(RowStats& r) {
  r.m = -1e30f; r.s = 0.0f; r.m0 = -1e30f; r.s0 = 0.0f; r.w = 0.0f;
  r.n = 0.0f; r.mean = 0.0f; r.m2 = 0.0f; r.et = 0.0f; r.e0t = 0.0f;
}

__device__ __forceinline__ void stats_add(RowStats& r, float eta, float eta0,
                                          bool target) {
  const float d = eta - eta0;
  if (eta > r.m) {
    r.s = r.s * expf(r.m - eta) + 1.0f;
    r.m = eta;
  } else {
    r.s += expf(eta - r.m);
  }
  if (eta0 > r.m0) {
    const float sc = expf(r.m0 - eta0);
    r.s0 = r.s0 * sc + 1.0f;
    r.w = r.w * sc + d;
    r.m0 = eta0;
  } else {
    const float e = expf(eta0 - r.m0);
    r.s0 += e;
    r.w += e * d;
  }
  r.n += 1.0f;
  const float dl = d - r.mean;
  r.mean += dl / r.n;
  r.m2 += dl * (d - r.mean);
  if (target) {
    r.et = eta;
    r.e0t = eta0;
  }
}

// a ← merge(a, b): the statistics of a's classes followed by b's.
__device__ __forceinline__ void stats_merge(RowStats& a, const RowStats& b) {
  const float m = fmaxf(a.m, b.m);
  a.s = a.s * expf(a.m - m) + b.s * expf(b.m - m);
  a.m = m;
  const float m0 = fmaxf(a.m0, b.m0);
  const float ea = expf(a.m0 - m0), eb = expf(b.m0 - m0);
  a.s0 = a.s0 * ea + b.s0 * eb;
  a.w = a.w * ea + b.w * eb;
  a.m0 = m0;
  const float n = a.n + b.n;
  if (n > 0.0f) {
    const float dl = b.mean - a.mean;
    a.mean = a.mean + dl * (b.n / n);
    a.m2 = a.m2 + b.m2 + dl * dl * (a.n * b.n / n);
  }
  a.n = n;
  a.et += b.et;  // one class is the label: the other terms are +0.0
  a.e0t += b.e0t;
}

__device__ __forceinline__ RowStats stats_shfl_xor(const RowStats& r,
                                                   int off) {
  RowStats o;
  o.m = __shfl_xor_sync(0xffffffffu, r.m, off);
  o.s = __shfl_xor_sync(0xffffffffu, r.s, off);
  o.m0 = __shfl_xor_sync(0xffffffffu, r.m0, off);
  o.s0 = __shfl_xor_sync(0xffffffffu, r.s0, off);
  o.w = __shfl_xor_sync(0xffffffffu, r.w, off);
  o.n = __shfl_xor_sync(0xffffffffu, r.n, off);
  o.mean = __shfl_xor_sync(0xffffffffu, r.mean, off);
  o.m2 = __shfl_xor_sync(0xffffffffu, r.m2, off);
  o.et = __shfl_xor_sync(0xffffffffu, r.et, off);
  o.e0t = __shfl_xor_sync(0xffffffffu, r.e0t, off);
  return o;
}

// grid (ceil(C / kWideRows), ceil(Kc / kWideSplit), L·K), kWideThreads,
// kWideSmemFloats floats of dynamic shared memory. stats: (L·K, tiles,
// splits, kWideStats, kWideRows) floats; tile_arrivals: (L·K, tiles) and
// arrivals (L·K) persistent zeroed counters. Lanes as in bright_glm_kernel.
__global__ void __launch_bounds__(kWideThreads, 2)
bright_glm_wide_kernel(const float* __restrict__ x,
                       const int64_t* __restrict__ t,
                       const float* __restrict__ xi,
                       const int32_t* __restrict__ idx, int64_t idx_stride,
                       const int64_t* __restrict__ n_bright,
                       const float* __restrict__ theta,
                       float* __restrict__ delta, float* __restrict__ partials,
                       float* __restrict__ total, float* __restrict__ stats,
                       unsigned int* __restrict__ arrivals,
                       unsigned int* __restrict__ tile_arrivals, int C, int N,
                       int D, int kt, int lane_chains, int64_t x_lane,
                       int64_t t_lane, int64_t xi_lane, int64_t idx_lane) {
  extern __shared__ __align__(16) float wsm[];
  float* xs = wsm;                               // [chunk][kXsStride]
  float* ths = xs + kWideChunk * kXsStride;      // [chunk][kThsStride]
  float* es = ths + kWideChunk * kThsStride;     // [rows][kEsStride]
  __shared__ int64_t rid[kWideRows];
  __shared__ int tgt[kWideRows];
  __shared__ float contrib[kWideRows];
  __shared__ bool last;

  const int k = blockIdx.z;
  const int ln = k / lane_chains;
  const int jc = k - ln * lane_chains;
  x += ln * x_lane;
  xi += ln * xi_lane;
  t += ln * t_lane;
  const int tile = blockIdx.x, ntiles = gridDim.x;
  const int split = blockIdx.y, nsplits = gridDim.y;
  const int tid = threadIdx.x, tx = tid % 32, wp = tid / 32;

  if (tid < kWideRows) {
    const int c = tile * kWideRows + tid;
    int r = 0;
    if (c < C)
      r = min(max(idx[ln * idx_lane + (int64_t)jc * idx_stride + c], 0),
              N - 1);
    rid[tid] = r;
    tgt[tid] = (int)t[r];
  }
  __syncthreads();

  const float* th_k = theta + (int64_t)k * kt * D;
  const int lo = split * kWideSplit;
  const int hi = min(kt, lo + kWideSplit);
  // The statistics' thread: row sr, part sp.
  const int sr = tid / kWideParts, sp = tid % kWideParts;
  const int64_t xi_row = rid[sr] * (int64_t)kt;
  const int lab = tgt[sr];
  RowStats st;
  stats_init(st);

  for (int v0 = lo; v0 < hi; v0 += kWideTile) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int d0 = 0; d0 < D; d0 += kWideChunk) {
      for (int e = tid; e < kWideRows * kWideChunk; e += kWideThreads) {
        const int row = e / kWideChunk, dd = e % kWideChunk;
        xs[dd * kXsStride + row] =
            d0 + dd < D ? x[rid[row] * D + d0 + dd] : 0.0f;
      }
      for (int e = tid; e < kWideTile * kWideChunk; e += kWideThreads) {
        const int cl = e / kWideChunk, dd = e % kWideChunk;
        const int cls = v0 + cl;
        ths[dd * kThsStride + cl] = (cls < hi && d0 + dd < D)
                                        ? th_k[(int64_t)cls * D + d0 + dd]
                                        : 0.0f;
      }
      __syncthreads();
#pragma unroll 2
      for (int dd = 0; dd < kWideChunk; ++dd) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(xs + dd * kXsStride + wp * 8);
        const float4 a1 =
            *reinterpret_cast<const float4*>(xs + dd * kXsStride + wp * 8 + 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float b[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = ths[dd * kThsStride + tx + 32 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        es[(wp * 8 + i) * kEsStride + tx + 32 * j] = acc[i][j];
    __syncthreads();
    const float* er = es + sr * kEsStride;
    for (int q = sp; q < kWideTile; q += kWideParts) {
      const int cls = v0 + q;
      if (cls < hi) stats_add(st, er[q], xi[xi_row + cls], cls == lab);
    }
    // es is written again only after the next tile's chunk barriers.
  }

  // A row's 4 threads (consecutive lanes) merge by a fixed butterfly, each
  // pair in part order; part 0 writes the split's statistics.
#pragma unroll
  for (int off = 1; off < kWideParts; off <<= 1) {
    const RowStats o = stats_shfl_xor(st, off);
    if (sp & off) {
      const RowStats b = st;
      st = o;
      stats_merge(st, b);
    } else {
      stats_merge(st, o);
    }
  }
  float* ws = stats + (((int64_t)k * ntiles + tile) * nsplits + split) *
                          (kWideStats * kWideRows);
  if (sp == 0) {
    const float v[kWideStats] = {st.m, st.s,    st.m0, st.s0, st.w,
                                 st.n, st.mean, st.m2, st.et, st.e0t};
#pragma unroll
    for (int f = 0; f < kWideStats; ++f) ws[f * kWideRows + sr] = v[f];
  }
  __threadfence();  // release: the statistics are visible before the ticket
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(&tile_arrivals[(int64_t)k * ntiles + tile], 1u) ==
           (unsigned int)(nsplits - 1);
  __syncthreads();
  if (!last) return;

  // The tile's last split: merge the splits in split order, one row a thread.
  __threadfence();  // acquire
  const int nblk = (C + kBlockRows - 1) / kBlockRows;
  if (tid < kWideRows) {
    const int c = tile * kWideRows + tid;
    const float* base = stats + ((int64_t)k * ntiles + tile) * nsplits *
                                    (kWideStats * kWideRows) + tid;
    RowStats a;
    stats_init(a);
    for (int sq = 0; sq < nsplits; ++sq) {
      const float* q = base + (int64_t)sq * (kWideStats * kWideRows);
      RowStats b;
      b.m = __ldcg(q + 0 * kWideRows);
      b.s = __ldcg(q + 1 * kWideRows);
      b.m0 = __ldcg(q + 2 * kWideRows);
      b.s0 = __ldcg(q + 3 * kWideRows);
      b.w = __ldcg(q + 4 * kWideRows);
      b.n = __ldcg(q + 5 * kWideRows);
      b.mean = __ldcg(q + 6 * kWideRows);
      b.m2 = __ldcg(q + 7 * kWideRows);
      b.et = __ldcg(q + 8 * kWideRows);
      b.e0t = __ldcg(q + 9 * kWideRows);
      if (sq == 0)
        a = b;
      else
        stats_merge(a, b);
    }
    const float lse = a.m + logf(a.s);
    const float lse0 = a.m0 + logf(a.s0);
    const float gd = (a.et - a.e0t) - a.w / a.s0;
    const float quad = 0.5f * a.m2;
    const float dl = (a.et - lse) - ((a.e0t - lse0) + gd - 0.5f * quad);
    float part = 0.0f;
    if (c < C) {
      delta[(int64_t)k * C + c] = dl;
      if (c < n_bright[k]) part = log_expm1(dl);
    }
    contrib[tid] = part;
  }
  __syncthreads();
  if (tid < kWideRows / kBlockRows) {
    const int b = tile * (kWideRows / kBlockRows) + tid;
    if (b < nblk) {
      float s = contrib[tid * kBlockRows];
      for (int w = 1; w < kBlockRows; ++w) s += contrib[tid * kBlockRows + w];
      partials[(int64_t)k * nblk + b] = s;
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    tile_arrivals[(int64_t)k * ntiles + tile] = 0u;  // clean for the next call
    last = atomicAdd(&arrivals[k], 1u) == (unsigned int)(ntiles - 1);
  }
  __syncthreads();
  if (!last || wp != 0) return;

  // The chain's last tile: its partials, in block order.
  __threadfence();  // acquire
  const float s = sum_in_block_order(partials + (int64_t)k * nblk, nblk, tx);
  if (tx == 0) {
    total[k] = s;
    arrivals[k] = 0u;
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

// The wide softmax path (any class count): the same outputs, plus a float
// workspace of (L·K, tiles, splits, 10, 32) statistics and a zeroed
// (L·K, tiles) tile-arrival workspace.
extern "C" int bright_glm_wide_launch(
    const float* x, const int64_t* t, const float* xi, const int32_t* idx,
    int64_t idx_stride, const int64_t* n_bright, const float* theta,
    float* delta, float* partials, float* total, float* stats,
    unsigned int* arrivals, unsigned int* tile_arrivals, int K, int C, int N,
    int D, int kt, int L, int64_t x_lane, int64_t t_lane, int64_t xi_lane,
    int64_t idx_lane, void* stream) {
  const int64_t splits = ((int64_t)kt + kWideSplit - 1) / kWideSplit;
  if (kt <= 0 || C <= 0 || K <= 0 || L <= 0 || D <= 0 ||
      (int64_t)L * K > 65535 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  const int tiles = (C + kWideRows - 1) / kWideRows;
  const size_t smem = sizeof(float) * kWideSmemFloats;
  cudaError_t err = cudaFuncSetAttribute(
      bright_glm_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  bright_glm_wide_kernel<<<dim3(tiles, (unsigned)splits, L * K), kWideThreads,
                           smem, static_cast<cudaStream_t>(stream)>>>(
      x, t, xi, idx, idx_stride, n_bright, theta, delta, partials, total,
      stats, arrivals, tile_arrivals, C, N, D, kt, K, x_lane, t_lane, xi_lane,
      idx_lane);
  return (int)cudaGetLastError();
}

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
