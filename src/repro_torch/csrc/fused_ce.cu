// fused_ce.cu — softmax cross-entropy parts over a large vocabulary: for
// every token t, lse_t = logsumexp_v (x_t · W[:, v]) and tgt_t = x_t ·
// W[:, labels_t], without the (T, V) logits ever leaving the chip.
//
// Replaces the TPU kernel repro/kernels/fused_ce/kernel.py (fused_ce_pallas,
// its pallas_call at kernel.py:88), the function of kernels/fused_ce/ref.py:
// float32 products of the inputs' values (a bfloat16 input is exact in
// float32), an online logsumexp over the vocabulary, and the logit at the
// label (0 for a label outside [0, V), as the TPU kernel gives).
//
// What bounds it on an H100: operations. 2·T·D·V flops (8.59 TFLOP at the
// training path's T = 4096, D = 4096, V = 256,000) against x + W + out bytes
// (2.1 GB in bfloat16): 8.7 ms at the bf16 tensor-core peak, 128 ms at the
// float32 CUDA-core peak. This first kernel runs float32 FMAs on the CUDA
// cores, so the float32 figure is its own ceiling; wgmma on bf16 tiles (with
// TMA staging) is what would approach the first.
//
// Design. The TPU grid's sequential vocab axis carried (m, se, tgt) in VMEM
// from one vocab block to the next (kernel.py:54-58, 79-82). Here:
//   1. ce_tiles_kernel: a CTA takes kBT = 128 tokens and one vocab split of
//      kTilesPerSplit · kBV = 1024 columns. For each 128-column tile it forms
//      the (128 × 128) logits itself: a k-loop over D with x and W slices
//      staged (double-buffered) in shared memory as float32, each of the 256
//      threads holding an 8 × 8 register block of float32 FMA accumulators.
//      Each row's tile max and Σ e^{l − max} are reduced over the 16 threads
//      that hold the row (a fixed butterfly of warp shuffles) and merged into
//      the row's running (m, se) in shared memory; the thread that holds the
//      label's column keeps the target logit. Masked entries — columns ≥ V of
//      a ragged last tile — are replaced by −inf with a select and never join
//      the max or the sum; rows ≥ T (a ragged last token tile) are computed on
//      zeros and never written. The CTA writes its split's (m, se, tgt).
//   2. ce_merge_kernel: one thread per token merges the splits in split
//      order: m = max_j m_j, se = Σ_j se_j·e^{m_j − m}, lse = m + log se, and
//      tgt from the one split that holds the label.
// No float atomics: the result does not depend on launch order. Grid x walks
// the token tiles fastest, so the CTAs that share a split's W columns run
// together and read them from L2.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBT = 128;  // tokens per CTA
constexpr int kBV = 128;  // vocab columns per tile
constexpr int kBKMax = 16;  // depth of one shared-memory stage (bf16)
constexpr int kThreads = 256;  // 16 × 16 threads, 8 × 8 logits each
constexpr int kTilesPerSplit = 8;  // a CTA's vocab split: 1024 columns
constexpr int kSplitCols = kBV * kTilesPerSplit;

// Unpack one 16-byte vector of inputs into float32: 4 floats or 8 bf16
// (element 0 in the low half of the first word; bf16 → f32 is exact).
template <bool kBf16>
__device__ __forceinline__ void unpack(const uint4& u, float* out) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (kBf16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = __uint_as_float(w[i]);
  }
}

// One 16-byte vector of x and one of W per thread and stage: a stage is
// 16 deep for bf16 and 8 for float32 (no register spills at 128 registers).
template <bool kBf16>
struct Tiles {
  static constexpr int kBK = kBf16 ? kBKMax : kBKMax / 2;
  static constexpr int kVec = kBf16 ? 8 : 4;  // elements per 16-byte load
  static constexpr int kAPerRow = kBK / kVec;  // x vectors per token row
  static constexpr int kBPerRow = kBV / kVec;  // W vectors per depth row
  static constexpr int kA = kBT * kAPerRow / kThreads;  // per thread
  static constexpr int kB = kBK * kBPerRow / kThreads;
};

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2) ce_tiles_kernel(
    const char* __restrict__ xb,  // (T, D) float32 or bf16
    const char* __restrict__ wb,  // (D, V)
    const int* __restrict__ labels,  // (T,)
    float* __restrict__ part,  // (3, n_split, T): m, se, tgt
    int T, int D, int V, int n_split) {
  using Tl = Tiles<kBf16>;
  constexpr int kBK = Tl::kBK;
  constexpr int kElt = kBf16 ? 2 : 4;  // bytes per element
  static_assert(Tl::kA == 1 && Tl::kB == 1, "one vector per thread and stage");

  __shared__ __align__(16) float As[2][kBK][kBT];  // x slice, k-major
  __shared__ __align__(16) float Bs[2][kBK][kBV];  // W slice
  __shared__ float s_m[kBT], s_se[kBT], s_tgt[kBT];
  __shared__ int s_lab[kBT];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int t0 = blockIdx.x * kBT;
  const int split = blockIdx.y;
  for (int r = tid; r < kBT; r += kThreads) {
    s_m[r] = -INFINITY;
    s_se[r] = 0.f;
    s_tgt[r] = 0.f;
    s_lab[r] = (t0 + r < T) ? labels[t0 + r] : -1;
  }

  uint4 ra[Tl::kA], rb[Tl::kB];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  auto load = [&](int k0, int v0) {
#pragma unroll
    for (int i = 0; i < Tl::kA; ++i) {
      const int idx = tid + i * kThreads;
      const int row = idx / Tl::kAPerRow, k = k0 + (idx % Tl::kAPerRow) * Tl::kVec;
      ra[i] = (t0 + row < T && k < D)
                  ? *reinterpret_cast<const uint4*>(
                        xb + ((size_t)(t0 + row) * D + k) * kElt)
                  : zero;
    }
#pragma unroll
    for (int i = 0; i < Tl::kB; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / Tl::kBPerRow, v = v0 + (idx % Tl::kBPerRow) * Tl::kVec;
      rb[i] = (k0 + r < D && v < V)
                  ? *reinterpret_cast<const uint4*>(
                        wb + ((size_t)(k0 + r) * V + v) * kElt)
                  : zero;
    }
  };
  auto store = [&](int stage) {
#pragma unroll
    for (int i = 0; i < Tl::kA; ++i) {
      const int idx = tid + i * kThreads;
      const int row = idx / Tl::kAPerRow, k = (idx % Tl::kAPerRow) * Tl::kVec;
      float f[Tl::kVec];
      unpack<kBf16>(ra[i], f);
#pragma unroll
      for (int j = 0; j < Tl::kVec; ++j) As[stage][k + j][row] = f[j];
    }
#pragma unroll
    for (int i = 0; i < Tl::kB; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / Tl::kBPerRow, v = (idx % Tl::kBPerRow) * Tl::kVec;
      float f[Tl::kVec];
      unpack<kBf16>(rb[i], f);
#pragma unroll
      for (int j = 0; j < Tl::kVec; j += 4)
        *reinterpret_cast<float4*>(&Bs[stage][r][v + j]) =
            make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
    }
  };

  const int v_begin = split * kSplitCols;
  const int v_end = min(V, v_begin + kSplitCols);
  for (int v0 = v_begin; v0 < v_end; v0 += kBV) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    load(0, v0);
    store(0);
    __syncthreads();
    int cur = 0;
    for (int k0 = 0; k0 < D; k0 += kBK) {
      const bool more = k0 + kBK < D;
      if (more) load(k0 + kBK, v0);
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        // rows ty·4 + {0..3} and 64 + ty·4 + {0..3}; columns likewise by tx:
        // a quarter-warp's 16-byte loads cover 128 contiguous bytes
        const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (more) store(cur ^ 1);
      __syncthreads();
      cur ^= 1;
    }

    // Epilogue: merge this tile into each row's running (m, se); keep the
    // target logit. Lanes tx = 0..15 of one ty share a half-warp.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
      float l[8];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
        l[j] = (v0 + c < V) ? acc[i][j] : -INFINITY;
        mx = fmaxf(mx, l[j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) s += expf(l[j] - mx);  // e^{-inf} = 0
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      const int lc = s_lab[r] - v0;  // the label's column in this tile
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
        if (c == lc) s_tgt[r] = acc[i][j];
      }
      if (tx == 0) {
        const float m_old = s_m[r];
        const float m_new = fmaxf(m_old, mx);
        s_se[r] = s_se[r] * expf(m_old - m_new) + s * expf(mx - m_new);
        s_m[r] = m_new;
      }
    }
  }
  __syncthreads();
  for (int r = tid; r < kBT; r += kThreads) {
    if (t0 + r < T) {
      const size_t o = (size_t)split * T + t0 + r;
      part[o] = s_m[r];
      part[(size_t)n_split * T + o] = s_se[r];
      part[2 * (size_t)n_split * T + o] = s_tgt[r];
    }
  }
}

__global__ void ce_merge_kernel(const float* __restrict__ part,
                                const int* __restrict__ labels,
                                float* __restrict__ lse,
                                float* __restrict__ tgt, int T, int V,
                                int n_split) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const float* pm = part;
  const float* pse = part + (size_t)n_split * T;
  const float* ptg = part + 2 * (size_t)n_split * T;
  float m = -INFINITY;
  for (int j = 0; j < n_split; ++j) m = fmaxf(m, pm[(size_t)j * T + t]);
  float se = 0.f;
  for (int j = 0; j < n_split; ++j)
    se += pse[(size_t)j * T + t] * expf(pm[(size_t)j * T + t] - m);
  lse[t] = m + logf(se);
  const int lab = labels[t];
  tgt[t] = (lab >= 0 && lab < V) ? ptg[(size_t)(lab / kSplitCols) * T + t] : 0.f;
}

}  // namespace

extern "C" int fused_ce_launch(const void* x, const void* w, const void* labels,
                               void* part, void* lse, void* tgt, int T, int D,
                               int V, int is_bf16, void* stream) {
  if (T <= 0 || D <= 0 || V <= 0 || D % 8 != 0 || V % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_split = (V + kSplitCols - 1) / kSplitCols;
  if (n_split > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((T + kBT - 1) / kBT, n_split);
  const auto* xr = static_cast<const char*>(x);
  const auto* wr = static_cast<const char*>(w);
  const auto* lab = static_cast<const int*>(labels);
  auto* p = static_cast<float*>(part);
  if (is_bf16)
    ce_tiles_kernel<true><<<grid, kThreads, 0, s>>>(xr, wr, lab, p, T, D, V,
                                                     n_split);
  else
    ce_tiles_kernel<false><<<grid, kThreads, 0, s>>>(xr, wr, lab, p, T, D, V,
                                                      n_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_merge_kernel<<<(T + 255) / 256, 256, 0, s>>>(
      p, lab, static_cast<float*>(lse), static_cast<float*>(tgt), T, V,
      n_split);
  return static_cast<int>(cudaGetLastError());
}
