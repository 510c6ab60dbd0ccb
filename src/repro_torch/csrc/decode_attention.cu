// decode_attention.cu — flash-decode of one token over a ring KV cache.
//
// Replaces the TPU kernel repro/kernels/decode_attention/kernel.py
// (decode_attention_pallas, its pallas_call at kernel.py:115).
//
// For batch row b and KV head hk, the G = H/Hk query rows q[b, hk·G + g]
// (float32, scaled by 1/sqrt(D)) attend the W ring slots k/v[b, :, hk]
// (float32 or bfloat16). Slot c takes part iff pos[c] >= 0, pos[c] <= t and,
// with a window, pos[c] > t - window; a masked score is -1e30. The softmax is
// online in float32, and the result is out = acc / max(l, 1e-30), m and l —
// the function of kernels/decode_attention/ref.py. A fully masked row gives
// what the plain version gives: m = -1e30, every weight 1, l = W and out the
// mean of V. Slots past W are never visited (the TPU wrapper padded W with
// pos = -1 instead, which would count them in a fully masked row's l).
//
// What bounds it on an H100: bytes. Each K and V element is read once
// (2·B·W·Hk·D elements, 8.4 MB at the serving path's B=4, W=2048, Hk=1,
// D=256 in bf16: ~2.5 us at 3.35 TB/s) for 4·B·H·W·D flops of float32 FMA
// (134 MFLOP, ~2 us at the float32 peak). One CTA per (b, hk) would leave
// 128 of the 132 SMs idle and walk the ring serially, so the ring is split:
//   1. decode_attention_split, grid (B·Hk, n_split): the CTA for split j
//      takes ring slots [j·L, min(W, (j+1)·L)) (L chosen by the wrapper so
//      the grid fills the card), in tiles of kBlockK slots:
//        a. cp.async stages the tile's K rows, then its V rows, in their own
//           dtype (rows padded by 16 bytes: the lanes of a warp, which take
//           consecutive slots, hit distinct banks), so the scores start
//           while V is still in flight;
//        b. scores: thread (slot, row group) takes q·k for up to 8 query
//           rows in float32 (q stays float32, broadcast from shared memory);
//        c. online softmax, one warp per query row: (m, l) and p = e^{s-m};
//        d. acc[g][d] = acc·corr + Σ_j p[g][j]·v[j][d], four slots at a time.
//      It writes its unnormalised (acc_j, m_j, l_j) to a float32 scratch
//      tensor (n_split, B, Hk, G, D + 2). A fully masked split has
//      m_j = -1e30 and l_j = its number of slots.
//   2. decode_attention_merge, one CTA per (b, hk, g): in split order,
//      m = max_j m_j, l = Σ_j l_j·e^{m_j - m}, acc = Σ_j acc_j·e^{m_j - m},
//      out = acc / max(l, 1e-30).
// No float atomics: a run gives the same result every time. Tensor cores
// are not used: they would need q in bf16, which changes the function.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockK = 64;  // ring slots per tile
constexpr int kMaxG = 32;  // query rows per KV head
constexpr int kMaxD = 256;
constexpr int kMaxGD = 4096;  // G·D of one CTA (16 KB of q)
constexpr int kMaxAcc = kMaxG;  // (g, d) accumulators a thread: one d, ≤ G rows
constexpr int kRowGroups = kThreads / kBlockK;  // query-row groups of the scores
constexpr int kScoreRows = kMaxG / kRowGroups;  // query rows a thread scores
constexpr int kPadBytes = 16;  // padding per shared K/V row
constexpr int kMergeThreads = 256;
constexpr float kNeg = -1e30f;

// Shared memory: q (float32), the K and V tiles (padded rows of T), the
// scores/weights p[g][j], and m, l, corr per query row.
__host__ __device__ constexpr int smem_bytes(int G, int D, int elt) {
  return 4 * G * D + 2 * kBlockK * (D * elt + kPadBytes) +
         4 * kMaxG * kBlockK + 3 * 4 * kMaxG;
}
constexpr int kMaxSmemBytes = smem_bytes(kMaxGD / kMaxD, kMaxD, 4);

// Eight consecutive elements of a K row as float32.
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// cp.async the 16-byte chunks of rows [0, nk) (row stride `stride`
// elements in global memory) into shared rows of `ld` bytes at `dst`.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           size_t stride, int nk, int D,
                                           uint32_t dst, int ld) {
  const int chunks = D * (int)sizeof(T) / 16;
  for (int idx = threadIdx.x; idx < nk * chunks; idx += kThreads) {
    const int r = idx / chunks, c = idx - r * chunks;
    const char* g = reinterpret_cast<const char*>(src + (size_t)r * stride) + c * 16;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     dst + r * ld + c * 16),
                 "l"(g)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
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
__global__ void __launch_bounds__(kThreads) decode_attention_split(
    const float* __restrict__ q,  // (B, Hk, G, D)
    const T* __restrict__ k,  // (B, W, Hk, D)
    const T* __restrict__ v,  // (B, W, Hk, D)
    const int32_t* __restrict__ pos,  // (W,)
    float* __restrict__ part,  // (n_split, B, Hk, G, D + 2)
    int Hk, int G, int D, int W, int split_len, long long t,
    long long window, int has_window) {
  extern __shared__ float4 smem4[];
  constexpr int kPadElems = kPadBytes / sizeof(T);
  const int ld = D + kPadElems;  // elements per shared K/V row
  float* q_s = reinterpret_cast<float*>(smem4);
  T* k_s = reinterpret_cast<T*>(q_s + G * D);
  T* v_s = k_s + kBlockK * ld;
  float* p_s = reinterpret_cast<float*>(v_s + kBlockK * ld);  // [g][j]
  float* m_s = p_s + kMaxG * kBlockK;
  float* l_s = m_s + kMaxG;
  float* corr_s = l_s + kMaxG;
  const uint32_t k_addr = static_cast<uint32_t>(__cvta_generic_to_shared(k_s));
  const uint32_t v_addr = static_cast<uint32_t>(__cvta_generic_to_shared(v_s));

  const int bh = blockIdx.x;  // b·Hk + hk
  const int split = blockIdx.y;
  const int b = bh / Hk, hk = bh % Hk;
  const int GD = G * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row_stride = (size_t)Hk * D;  // between ring slots
  const int s_begin = split * split_len;
  const int s_end = min(W, s_begin + split_len);
  const T* kb = k + ((size_t)b * W + s_begin) * row_stride + (size_t)hk * D;
  const T* vb = v + ((size_t)b * W + s_begin) * row_stride + (size_t)hk * D;

  const float scale = sqrtf((float)D);
  const float* qb = q + (size_t)bh * GD;
  for (int e = threadIdx.x; e < GD; e += kThreads) q_s[e] = qb[e] / scale;
  if (threadIdx.x < G) {
    m_s[threadIdx.x] = kNeg;
    l_s[threadIdx.x] = 0.f;
  }
  // Step d's owner of (g, d): column d3, rows [g3, g3 + n3).
  const int groups = kThreads / D;
  const int rows = (G + groups - 1) / groups;
  const int d3 = threadIdx.x % D, g3 = (threadIdx.x / D) * rows;
  const int n3 = threadIdx.x < groups * D ? max(0, min(rows, G - g3)) : 0;
  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < s_end - s_begin; k0 += kBlockK) {
    const int nk = min(kBlockK, s_end - s_begin - k0);
    // a. K, then V, in flight; wait for K.
    stage_rows(kb + (size_t)k0 * row_stride, row_stride, nk, D, k_addr,
               ld * (int)sizeof(T));
    stage_rows(vb + (size_t)k0 * row_stride, row_stride, nk, D, v_addr,
               ld * (int)sizeof(T));
    cp_async_wait<1>();
    __syncthreads();

    // b. scores: thread (j, g1) for rows g1, g1 + kRowGroups, ...
    {
      const int j = threadIdx.x % kBlockK, g1 = threadIdx.x / kBlockK;
      if (j < nk) {
        float s[kScoreRows];
#pragma unroll
        for (int i = 0; i < kScoreRows; ++i) s[i] = 0.f;
        const T* kr = k_s + j * ld;
        for (int d = 0; d < D; d += 8) {
          float kv[8];
          load8(kr + d, kv);
#pragma unroll
          for (int i = 0; i < kScoreRows; ++i) {
            const int g = g1 + i * kRowGroups;
            if (g < G) {
              const float4 qa = *reinterpret_cast<const float4*>(q_s + g * D + d);
              const float4 qc = *reinterpret_cast<const float4*>(q_s + g * D + d + 4);
              s[i] = fmaf(qa.x, kv[0], s[i]);
              s[i] = fmaf(qa.y, kv[1], s[i]);
              s[i] = fmaf(qa.z, kv[2], s[i]);
              s[i] = fmaf(qa.w, kv[3], s[i]);
              s[i] = fmaf(qc.x, kv[4], s[i]);
              s[i] = fmaf(qc.y, kv[5], s[i]);
              s[i] = fmaf(qc.z, kv[6], s[i]);
              s[i] = fmaf(qc.w, kv[7], s[i]);
            }
          }
        }
        const long long p = pos[s_begin + k0 + j];
        const bool valid = p >= 0 && p <= t && (!has_window || p > t - window);
#pragma unroll
        for (int i = 0; i < kScoreRows; ++i) {
          const int g = g1 + i * kRowGroups;
          if (g < G) p_s[g * kBlockK + j] = valid ? s[i] : kNeg;
        }
      }
    }
    __syncthreads();

    // c. online softmax, one warp per query row.
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
    cp_async_wait<0>();
    __syncthreads();

    // d. acc[g][d] = acc·corr[g] + Σ_j p[g][j]·v[j][d].
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i)
      if (i < n3) acc[i] *= corr_s[g3 + i];
    int j = 0;
    for (; j + 4 <= nk; j += 4) {
      const float v0 = to_f32(v_s[j * ld + d3]);
      const float v1 = to_f32(v_s[(j + 1) * ld + d3]);
      const float v2 = to_f32(v_s[(j + 2) * ld + d3]);
      const float v3 = to_f32(v_s[(j + 3) * ld + d3]);
#pragma unroll
      for (int i = 0; i < kMaxAcc; ++i)
        if (i < n3) {
          const float4 pp =
              *reinterpret_cast<const float4*>(p_s + (g3 + i) * kBlockK + j);
          acc[i] = fmaf(pp.x, v0, acc[i]);
          acc[i] = fmaf(pp.y, v1, acc[i]);
          acc[i] = fmaf(pp.z, v2, acc[i]);
          acc[i] = fmaf(pp.w, v3, acc[i]);
        }
    }
    for (; j < nk; ++j) {
      const float vv = to_f32(v_s[j * ld + d3]);
#pragma unroll
      for (int i = 0; i < kMaxAcc; ++i)
        if (i < n3) acc[i] = fmaf(p_s[(g3 + i) * kBlockK + j], vv, acc[i]);
    }
    __syncthreads();
  }

  float* o = part + ((size_t)split * gridDim.x + bh) * G * (D + 2);
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i)
    if (i < n3) o[(g3 + i) * (D + 2) + d3] = acc[i];
  if (threadIdx.x < G) {
    o[threadIdx.x * (D + 2) + D] = m_s[threadIdx.x];
    o[threadIdx.x * (D + 2) + D + 1] = l_s[threadIdx.x];
  }
}

// One CTA per query row (b, hk, g): merge the splits in split order.
__global__ void __launch_bounds__(kMergeThreads) decode_attention_merge(
    const float* __restrict__ part,  // (n_split, rows, D + 2)
    float* __restrict__ out,  // (rows, D)
    float* __restrict__ m_out,  // (rows,)
    float* __restrict__ l_out,  // (rows,)
    int D, int n_split) {
  const int row = blockIdx.x;
  const size_t split_stride = (size_t)gridDim.x * (D + 2);
  const float* p = part + (size_t)row * (D + 2);
  float m = -INFINITY;
  for (int j = 0; j < n_split; ++j) m = fmaxf(m, p[j * split_stride + D]);
  for (int d = threadIdx.x; d < D; d += kMergeThreads) {
    float l = 0.f, a = 0.f;
    for (int j = 0; j < n_split; ++j) {
      const float* pj = p + j * split_stride;
      const float w = expf(pj[D] - m);
      l += pj[D + 1] * w;
      a += pj[d] * w;
    }
    out[(size_t)row * D + d] = a / fmaxf(l, 1e-30f);
    if (d == 0) {
      m_out[row] = m;
      l_out[row] = l;
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* pos, void* part, void* out, void* m, void* l,
                   int B, int Hk, int G, int D, int W, int split_len,
                   int n_split, long long t, long long window, int has_window,
                   cudaStream_t s) {
  static bool configured = false;  // opt in to > 48 KB of shared memory once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attention_split<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmemBytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  decode_attention_split<T>
      <<<dim3(B * Hk, n_split), kThreads, smem_bytes(G, D, sizeof(T)), s>>>(
          static_cast<const float*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const int32_t*>(pos),
          static_cast<float*>(part), Hk, G, D, W, split_len, t, window,
          has_window);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_attention_merge<<<B * Hk * G, kMergeThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out),
      static_cast<float*>(m), static_cast<float*>(l), D, n_split);
  return cudaGetLastError();
}

}  // namespace

// K/V rows are staged in 16-byte chunks: D must be a multiple of 8 and k, v
// 16-byte aligned (the wrapper checks both). part is float32 scratch of
// n_split·B·Hk·G·(D + 2) elements, n_split = ceil(W / split_len).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* pos, void* part,
    void* out, void* m, void* l, int B, int Hk, int G, int D, int W,
    int split_len, int n_split, long long t, long long window, int has_window,
    int kv_bf16, void* stream) {
  if (B <= 0 || Hk <= 0 || G <= 0 || G > kMaxG || D <= 0 || D > kMaxD ||
      D % 8 != 0 || G * D > kMaxGD || W <= 0 || split_len <= 0 ||
      n_split != (W + split_len - 1) / split_len || n_split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      kv_bf16 ? launch<__nv_bfloat16>(q, k, v, pos, part, out, m, l, B, Hk, G,
                                      D, W, split_len, n_split, t, window,
                                      has_window, s)
              : launch<float>(q, k, v, pos, part, out, m, l, B, Hk, G, D, W,
                              split_len, n_split, t, window, has_window, s);
  return static_cast<int>(e);
}
