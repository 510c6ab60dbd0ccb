// decode_attention.cu — flash-decode of one token over a ring KV cache.
//
// Replaces the TPU kernel repro/kernels/decode_attention/kernel.py
// (decode_attention_pallas, its pallas_call at kernel.py:115).
//
// For batch row b and KV head hk, the G = H/Hk query rows q[b, hk·G + g]
// (float32, scaled by 1/sqrt(D)) attend the W ring slots k/v[b, :, hk]
// (float32 or bfloat16). Slot c takes part iff pos[c] >= 0, pos[c] <= t and,
// with a window, pos[c] > t - window; a masked score is -1e30. The softmax is
// online in float32 (running max m, denominator l, accumulator acc), and the
// kernel writes out = acc / max(l, 1e-30), m and l — the function of
// kernels/decode_attention/ref.py. A fully masked row gives what the plain
// version gives: m = -1e30 and every weight 1. Slots past W are never
// visited (the TPU wrapper padded W with pos = -1 instead, which would count
// them in a fully masked row's l).
//
// What bounds it on an H100: bytes. Each K and V element is read once
// (2·B·W·Hk·D elements) and the work is 4·B·H·W·D flops of float32 FMA, so
// the byte bound is ~2.5 us at the serving path's shapes (B=4, W=2048, Hk=1,
// D=256, bf16). This first version is simple and correct, not fast: one CTA
// of kThreads threads per (b, hk) — only B·Hk CTAs, 4 on 132 SMs at the
// path's shapes, so the arithmetic and shared-memory traffic of those few
// SMs, not bytes, set its time — walks the ring in tiles of kBlockK slots:
//   0. the tile's K and V rows (16-byte loads, all of them in flight at once)
//      are converted to float32 in shared memory, and the next tile's loads
//      are issued into registers before this tile is used, so their latency
//      overlaps the arithmetic;
//   1. scores: thread (g, j) takes the dot product of query row g with slot
//      j (float4 reads; K rows padded to D + 4 floats, so the lanes of a
//      warp, which take consecutive slots, hit distinct banks);
//   2. online softmax: one warp per query row rescales (m, l) and turns the
//      tile's scores into weights p;
//   3. accumulate: thread (g-range, d) adds p[g][j]·v[j][d] over the tile.
// The TPU kernel kept (m, l, acc) in VMEM scratch across a sequential grid
// axis; here the loop over tiles runs inside the CTA. No float atomics:
// the result is the same run to run. Split-K over W (more CTAs, with a
// merge of the per-split (m, l, acc)), TMA staging and tensor cores are left
// to a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockK = 64;  // ring slots per tile
constexpr int kMaxG = 32;  // query rows per KV head
constexpr int kMaxD = 256;
constexpr int kMaxGD = 4096;  // G·D of one CTA (16 KB of q)
constexpr int kMaxAcc = 16;  // (g, d) accumulators a thread
constexpr int kPairs = kMaxG * kBlockK / kThreads;  // (g, j) scores a thread
constexpr int kGStep = kThreads / kBlockK;  // rows between a thread's pairs
constexpr int kPad = 4;  // floats of padding per shared K/V row
constexpr float kNeg = -1e30f;

// Shared memory in floats: q, K tile, V tile, p, m, l, corr, pos.
__host__ __device__ constexpr int smem_floats(int G, int D) {
  return G * D + 2 * kBlockK * (D + kPad) + kMaxG * kBlockK + 3 * kMaxG +
         kBlockK;
}
// The K/V tiles grow with D and q is at most kMaxGD floats: ~155 KB at most.
constexpr int kMaxSmemBytes = 4 * smem_floats(kMaxGD / kMaxD, kMaxD);

template <typename T>
struct Vec {  // 16-byte loads of T
  static constexpr int kElems = 16 / sizeof(T);
  static constexpr int kPerThread = kBlockK * kMaxD / kElems / kThreads;
};

__device__ __forceinline__ void unpack(const uint4& r, float* out, float) {
  *reinterpret_cast<float4*>(out) = *reinterpret_cast<const float4*>(&r);
}
__device__ __forceinline__ void unpack(const uint4& r, float* out,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(out)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(out)[1] = make_float4(c.x, c.y, d.x, d.y);
}

// Issue the 16-byte loads of tile rows [k0, k0 + nk) of one (b, hk) ring.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ base,
                                          size_t row_stride, int k0, int nk,
                                          int D, uint4* reg) {
  const int vpr = D / Vec<T>::kElems;  // loads per row
#pragma unroll
  for (int i = 0; i < Vec<T>::kPerThread; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < nk * vpr) {
      const int r = idx / vpr, c = idx - r * vpr;
      reg[i] = *reinterpret_cast<const uint4*>(
          base + (size_t)(k0 + r) * row_stride + (size_t)c * Vec<T>::kElems);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_tile(const uint4* reg, int nk, int D,
                                           float* __restrict__ dst) {
  const int vpr = D / Vec<T>::kElems;
#pragma unroll
  for (int i = 0; i < Vec<T>::kPerThread; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < nk * vpr) {
      const int r = idx / vpr, c = idx - r * vpr;
      unpack(reg[i], dst + r * (D + kPad) + c * Vec<T>::kElems, T());
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) decode_attention_kernel(
    const float* __restrict__ q,  // (B, Hk, G, D)
    const T* __restrict__ k,  // (B, W, Hk, D)
    const T* __restrict__ v,  // (B, W, Hk, D)
    const int32_t* __restrict__ pos,  // (W,)
    float* __restrict__ out,  // (B, Hk, G, D)
    float* __restrict__ m_out,  // (B, Hk, G)
    float* __restrict__ l_out,  // (B, Hk, G)
    int Hk, int G, int D, int W, long long t, long long window,
    int has_window) {
  extern __shared__ float4 smem4[];
  const int ld = D + kPad;
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + G * D;
  float* v_s = k_s + kBlockK * ld;
  float* p_s = v_s + kBlockK * ld;  // [g][j]
  float* m_s = p_s + kMaxG * kBlockK;
  float* l_s = m_s + kMaxG;
  float* corr_s = l_s + kMaxG;
  int* pos_s = reinterpret_cast<int*>(corr_s + kMaxG);

  const int bh = blockIdx.x;  // b·Hk + hk
  const int b = bh / Hk, hk = bh % Hk;
  const int GD = G * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row_stride = (size_t)Hk * D;  // between ring slots
  const T* kb = k + (size_t)b * W * row_stride + (size_t)hk * D;
  const T* vb = v + (size_t)b * W * row_stride + (size_t)hk * D;

  const float scale = sqrtf((float)D);
  const float* qb = q + (size_t)bh * GD;
  for (int e = threadIdx.x; e < GD; e += kThreads) q_s[e] = qb[e] / scale;
  if (threadIdx.x < G) {
    m_s[threadIdx.x] = kNeg;
    l_s[threadIdx.x] = 0.f;
  }
  // Phase 3's owner of (g, d): column d3, rows [g3, g3 + n3).
  const int groups = kThreads / D;
  const int rows = (G + groups - 1) / groups;
  const int d3 = threadIdx.x % D, g3 = (threadIdx.x / D) * rows;
  const int n3 = threadIdx.x < groups * D ? max(0, min(rows, G - g3)) : 0;
  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;

  uint4 kreg[Vec<T>::kPerThread], vreg[Vec<T>::kPerThread];
  int pos_reg = 0;
  int nk = min(kBlockK, W);
  load_tile(kb, row_stride, 0, nk, D, kreg);
  load_tile(vb, row_stride, 0, nk, D, vreg);
  if (threadIdx.x < nk) pos_reg = pos[threadIdx.x];

  for (int k0 = 0; k0 < W; k0 += kBlockK) {
    // 0. this tile into shared memory; the next tile's loads in flight.
    store_tile<T>(kreg, nk, D, k_s);
    store_tile<T>(vreg, nk, D, v_s);
    if (threadIdx.x < nk) pos_s[threadIdx.x] = pos_reg;
    __syncthreads();
    const int nk_next = min(kBlockK, W - k0 - kBlockK);
    if (nk_next > 0) {
      load_tile(kb, row_stride, k0 + kBlockK, nk_next, D, kreg);
      load_tile(vb, row_stride, k0 + kBlockK, nk_next, D, vreg);
      if (threadIdx.x < nk_next) pos_reg = pos[k0 + kBlockK + threadIdx.x];
    }

    // 1. scores: thread (g, j) for g = g1, g1 + kGStep, ...
    {
      const int j = threadIdx.x % kBlockK, g1 = threadIdx.x / kBlockK;
      if (j < nk) {
        float s[kPairs];
#pragma unroll
        for (int i = 0; i < kPairs; ++i) s[i] = 0.f;
        const float* kr = k_s + j * ld;
        for (int d = 0; d < D; d += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
          for (int i = 0; i < kPairs; ++i) {
            const int g = g1 + i * kGStep;
            if (g < G) {
              const float4 qv = *reinterpret_cast<const float4*>(q_s + g * D + d);
              s[i] = fmaf(qv.x, kv.x, s[i]);
              s[i] = fmaf(qv.y, kv.y, s[i]);
              s[i] = fmaf(qv.z, kv.z, s[i]);
              s[i] = fmaf(qv.w, kv.w, s[i]);
            }
          }
        }
        const long long p = pos_s[j];
        const bool valid = p >= 0 && p <= t && (!has_window || p > t - window);
#pragma unroll
        for (int i = 0; i < kPairs; ++i) {
          const int g = g1 + i * kGStep;
          if (g < G) p_s[g * kBlockK + j] = valid ? s[i] : kNeg;
        }
      }
    }
    __syncthreads();

    // 2. online softmax, one warp per query row.
    for (int g = warp; g < G; g += kWarps) {
      float* row = p_s + g * kBlockK;
      float mx = -INFINITY;
      for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < nk; j += 32) {
        const float e = expf(row[j] - m_new);
        row[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // 3. acc[g][d] = acc·corr[g] + Σ_j p[g][j]·v[j][d].
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i)
      if (i < n3) acc[i] *= corr_s[g3 + i];
    for (int j = 0; j < nk; ++j) {
      const float vv = v_s[j * ld + d3];
#pragma unroll
      for (int i = 0; i < kMaxAcc; ++i)
        if (i < n3) acc[i] = fmaf(p_s[(g3 + i) * kBlockK + j], vv, acc[i]);
    }
    __syncthreads();
    nk = nk_next;
  }

  float* ob = out + (size_t)bh * GD;
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i)
    if (i < n3) ob[(g3 + i) * D + d3] = acc[i] / fmaxf(l_s[g3 + i], 1e-30f);
  if (threadIdx.x < G) {
    m_out[(size_t)bh * G + threadIdx.x] = m_s[threadIdx.x];
    l_out[(size_t)bh * G + threadIdx.x] = l_s[threadIdx.x];
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* pos, void* out, void* m, void* l, int B,
                   int Hk, int G, int D, int W, long long t, long long window,
                   int has_window, cudaStream_t s) {
  static bool configured = false;  // opt in to > 48 KB of shared memory once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  decode_attention_kernel<T><<<B * Hk, kThreads, 4 * smem_floats(G, D), s>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(pos),
      static_cast<float*>(out), static_cast<float*>(m),
      static_cast<float*>(l), Hk, G, D, W, t, window, has_window);
  return cudaGetLastError();
}

}  // namespace

// K/V rows are read with 16-byte loads: D must be a multiple of 8 and k, v
// 16-byte aligned (the wrapper checks both).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* pos, void* out,
    void* m, void* l, int B, int Hk, int G, int D, int W, long long t,
    long long window, int has_window, int kv_bf16, void* stream) {
  const int groups = D > 0 ? kThreads / D : 0;
  if (B <= 0 || Hk <= 0 || G <= 0 || G > kMaxG || D <= 0 || D > kMaxD ||
      D % 8 != 0 || G * D > kMaxGD || W <= 0 ||
      (G + groups - 1) / groups > kMaxAcc)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      kv_bf16 ? launch<__nv_bfloat16>(q, k, v, pos, out, m, l, B, Hk, G, D, W,
                                      t, window, has_window, s)
              : launch<float>(q, k, v, pos, out, m, l, B, Hk, G, D, W, t,
                              window, has_window, s);
  return static_cast<int>(e);
}
