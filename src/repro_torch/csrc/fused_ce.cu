// fused_ce.cu — softmax cross-entropy parts over a large vocabulary: for
// every token t, lse_t = logsumexp_v (x_t · W[:, v]) and tgt_t = x_t ·
// W[:, labels_t], without the (T, V) logits ever leaving the chip.
//
// Replaces the TPU kernel repro/kernels/fused_ce/kernel.py (fused_ce_pallas,
// its pallas_call at kernel.py:88), the function of kernels/fused_ce/ref.py:
// float32 products of the inputs' values (a bfloat16 input is exact in
// float32), an online logsumexp over the vocabulary, and the logit at the
// label (0 for a label outside [0, V), as the TPU kernel gives).
// For bfloat16 inputs a second mode (round_logits) rounds each float32
// logit to bfloat16 and back before the max, the sum and the target pick:
// the logits of the model's bf16 loss, whose x·W is a bf16 dot.
//
// What bounds it on an H100: operations. 2·T·D·V flops (8.59 TFLOP at the
// training path's T = 4096, D = 4096, V = 256,000) against x + W + out bytes
// (2.1 GB in bfloat16): 8.7 ms at the bf16 tensor-core peak (989 TFLOP/s),
// 128 ms at the float32 CUDA-core peak (67 TFLOP/s).
//
// The TPU grid's sequential vocab axis carried (m, se, tgt) in VMEM from one
// vocab block to the next (kernel.py:54-58, 79-82). Here a CTA takes 128
// tokens and one vocab split of kSplitCols = 1024 columns, keeps each row's
// running (m, se, tgt) on chip across the split's tiles and writes them once;
// ce_merge_kernel then merges the splits of each token in split order
// (m = max_j m_j, se = Σ_j se_j·e^{m_j − m}, lse = m + log se; tgt from the
// one split that holds the label). No float atomics: the result does not
// depend on launch order. Grid x walks the token tiles fastest, so the CTAs
// that share a split's W columns run together (W is read from HBM about
// once) while x stays in L2. Columns ≥ V of a ragged last tile become −inf
// by a select before the max and the sum; rows ≥ T of a ragged last token
// tile are computed on zeros and never written.
//
// bfloat16 inputs — ce_wgmma_kernel, on the tensor cores. A bf16 × bf16
// product is exact in float32, so wgmma with bf16 operands and float32
// accumulators computes what the Pallas kernel computes (both operands cast
// to float32, accumulated in float32); only the order of the sums differs.
//   * 3 warpgroups: one producer warp (the other three idle) issues TMA
//     (cp.async.bulk.tensor) loads into a ring of kStages stages, each a
//     128 × 64 x tile (16 KB) and a 64 × 256 W tile (four 64 × 64 boxes,
//     32 KB), with an mbarrier "full" and "empty" per stage; setmaxnreg
//     moves registers from the producer to the two consumer warpgroups.
//   * Each consumer warpgroup owns 64 token rows: per stage, four
//     wgmma.mma_async.m64n256k16.f32.bf16.bf16 (x K-major from shared
//     memory, W MN-major through the transpose bit), 128 float32
//     accumulators a thread. The TMA descriptors write 128-byte swizzled
//     tiles, and the wgmma shared-memory descriptors read them with the
//     same swizzle (layout type 1): x atoms are 8 rows × 128 B (SBO 1 KB),
//     W atoms 8 depth rows × 64 columns (SBO 1 KB, LBO 8 KB between boxes).
//   * Epilogue on the accumulator registers: in the m64 layout a thread
//     holds two rows, 64 columns each, shared by the 4 lanes of a quad; each
//     row's tile max and Σ e^{l − max} take two __shfl_xor_sync, and the
//     row's running (m, se, tgt) stays in registers across the split's tiles
//     (the same thread holds the same rows for every tile).
// float32 inputs — ce_tiles_kernel, on the CUDA cores: the card has no
// tensor-core mode for float32 that keeps the function (TF32 rounds the
// operands to 10 bits). 128 × 128 logit tiles from a double-buffered k-loop,
// an 8 × 8 register block of float32 FMAs per thread (256 threads); the
// running (m, se) of a row lives in shared memory. The float32 peak is its
// ceiling.
//
// The descriptors hold the base pointers, so they are encoded per call
// (cuTensorMapEncodeTiled, taken through cudaGetDriverEntryPoint: no -lcuda;
// the barrier and TMA helpers are in tma.cuh) and passed by value as
// __grid_constant__ parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int kBT = 128;  // tokens per CTA (both kernels)
constexpr int kSplitCols = 1024;  // vocab columns of one CTA's split

// ---------------------------------------------------------------------------
// float32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int kBV = 128;  // vocab columns per tile
constexpr int kBK = 8;  // depth of one shared-memory stage
constexpr int kThreads = 256;  // 16 × 16 threads, 8 × 8 logits each
constexpr int kAPerRow = kBK / 4;  // 16-byte x vectors per token row
constexpr int kBPerRow = kBV / 4;  // 16-byte W vectors per depth row
static_assert(kBT * kAPerRow == kThreads && kBK * kBPerRow == kThreads,
              "one 16-byte vector of x and one of W per thread and stage");
static_assert(kSplitCols % kBV == 0, "a split is whole tiles");

__global__ void __launch_bounds__(kThreads, 2) ce_tiles_kernel(
    const float* __restrict__ x,  // (T, D)
    const float* __restrict__ w,  // (D, V)
    const int* __restrict__ labels,  // (T,)
    float* __restrict__ part,  // (3, n_split, T): m, se, tgt
    int T, int D, int V, int n_split) {
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

  float4 ra, rb;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  auto load = [&](int k0, int v0) {
    const int row = tid / kAPerRow, k = k0 + (tid % kAPerRow) * 4;
    ra = (t0 + row < T && k < D)
             ? *reinterpret_cast<const float4*>(x + (size_t)(t0 + row) * D + k)
             : zero;
    const int r = tid / kBPerRow, v = v0 + (tid % kBPerRow) * 4;
    rb = (k0 + r < D && v < V)
             ? *reinterpret_cast<const float4*>(w + (size_t)(k0 + r) * V + v)
             : zero;
  };
  auto store = [&](int stage) {
    const int row = tid / kAPerRow, k = (tid % kAPerRow) * 4;
    As[stage][k][row] = ra.x;
    As[stage][k + 1][row] = ra.y;
    As[stage][k + 2][row] = ra.z;
    As[stage][k + 3][row] = ra.w;
    const int r = tid / kBPerRow, v = (tid % kBPerRow) * 4;
    *reinterpret_cast<float4*>(&Bs[stage][r][v]) = rb;
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

// ---------------------------------------------------------------------------
// bfloat16: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kWV = 256;  // vocab columns per tile: one m64n256 product
constexpr int kWK = 64;  // depth of one stage: 128 bytes of bf16, the swizzle
constexpr int kStages = 4;
constexpr int kBoxV = 64;  // W columns per TMA box (128 bytes)
constexpr int kXBytes = kBT * kWK * 2;  // 16 KB
constexpr int kBoxBytes = kWK * kBoxV * 2;  // 8 KB
constexpr int kStageBytes = kXBytes + (kWV / kBoxV) * kBoxBytes;  // 48 KB
constexpr int kWgThreads = 384;  // consumer warpgroups 0, 1; producer 2
constexpr int kWgmmaSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
static_assert(kSplitCols % kWV == 0, "a split is whole tiles");

// A wgmma shared-memory descriptor for a 128-byte swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout type 1.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads across a wgmma wait.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 × 256, float32) = A (64 × 16, K-major) · B (16 × 256, MN-major) + d
// (or + 0 when accumulate is 0).
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <bool kRoundLogits>
__global__ void __launch_bounds__(kWgThreads, 1) ce_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_x,  // (T, D) bf16, box 128 × 64
    const __grid_constant__ CUtensorMap tm_w,  // (D, V) bf16, box 64 × 64
    const int* __restrict__ labels,  // (T,)
    float* __restrict__ part,  // (3, n_split, T): m, se, tgt
    int T, int D, int V, int n_split) {
  extern __shared__ uint8_t smem_raw[];
  // Stage s: x at base + s·kStageBytes, its four W boxes after it; the
  // swizzle atoms need 1024-byte alignment.
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = base + kStages * kStageBytes;  // full[s]: + 8s
  const uint32_t empty0 = full0 + kStages * 8;  // empty[s]: + 8s
  const int wg = threadIdx.x / 128;
  const int t0 = blockIdx.x * kBT;
  const int split = blockIdx.y;
  const int v_begin = split * kSplitCols;
  const int n_tiles = (min(V, v_begin + kSplitCols) - v_begin + kWV - 1) / kWV;
  const int n_k = (D + kWK - 1) / kWK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);  // the producer's expect_tx
      mbar_init(empty0 + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // Producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 2 * 128) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&tm_x))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&tm_w))
                   : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = 0; tile < n_tiles; ++tile) {
        const int v0 = v_begin + tile * kWV;
        for (int kb = 0; kb < n_k; ++kb) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          const uint32_t sx = base + stage * kStageBytes;
          mbar_expect_tx(full, kStageBytes);
          tma_load_2d(sx, &tm_x, full, kb * kWK, t0);
#pragma unroll
          for (int j = 0; j < kWV / kBoxV; ++j)
            tma_load_2d(sx + kXBytes + j * kBoxBytes, &tm_w, full,
                        v0 + j * kBoxV, kb * kWK);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup wg owns rows wg·64 .. wg·64 + 63 of the tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32, quad = lane % 4;
    const int r0 = wg * 64 + (tid / 32) * 16 + lane / 4;  // and r0 + 8
    const int lab[2] = {t0 + r0 < T ? labels[t0 + r0] : -1,
                        t0 + r0 + 8 < T ? labels[t0 + r0 + 8] : -1};
    float m_run[2] = {-INFINITY, -INFINITY}, se_run[2] = {0.f, 0.f};
    float tgt[2] = {0.f, 0.f};
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;

    int stage = 0;
    uint32_t phase = 0;
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int v0 = v_begin + tile * kWV;
      int prev = 0;
      for (int kb = 0; kb < n_k; ++kb) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t sx = base + stage * kStageBytes + wg * (64 * 128);
        const uint32_t sw = base + stage * kStageBytes + kXBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWK / 16; ++kk)
          // x: 16 deep is 32 bytes along the swizzled row; W: 16 rows of
          // 128 bytes
          wgmma_m64n256k16(d, desc_sw128(sx + kk * 32, 16, 1024),
                           desc_sw128(sw + kk * 2048, kBoxBytes, 1024),
                           (kb > 0 || kk > 0) ? 1 : 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        if (kb > 0 && tid == 0) mbar_arrive(empty0 + 8 * prev);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(d);
      if (tid == 0) mbar_arrive(empty0 + 8 * prev);

      // Epilogue: register d[4j + 2i + c] is row r0 + 8i, column
      // v0 + 8j + 2·quad + c. In the rounding mode each logit is first
      // rounded to bfloat16 (to nearest even, as a bf16 dot's output is)
      // and back, so the max, the exp-sum and the target all see it.
      if (kRoundLogits) {
#pragma unroll
        for (int i = 0; i < 128; ++i)
          d[i] = __bfloat162float(__float2bfloat16_rn(d[i]));
      }
      const bool ragged = v0 + kWV > V;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kWV / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            if (ragged && v0 + 8 * j + 2 * quad + c >= V)
              d[4 * j + 2 * i + c] = -INFINITY;
            mx = fmaxf(mx, d[4 * j + 2 * i + c]);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        float s = 0.f;
        const int lc = lab[i] - v0;  // the label's column in this tile
#pragma unroll
        for (int j = 0; j < kWV / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float l = d[4 * j + 2 * i + c];
            s += expf(l - mx);  // e^{-inf} = 0
            if (8 * j + 2 * quad + c == lc) tgt[i] = l;
          }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        const float m_new = fmaxf(m_run[i], mx);
        se_run[i] = se_run[i] * expf(m_run[i] - m_new) + s * expf(mx - m_new);
        m_run[i] = m_new;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // one lane of the quad holds the target (the others keep 0)
      float tg = tgt[i] + __shfl_xor_sync(0xffffffffu, tgt[i], 1);
      tg += __shfl_xor_sync(0xffffffffu, tg, 2);
      const int t = t0 + r0 + 8 * i;
      if (quad == 0 && t < T) {
        const size_t o = (size_t)split * T + t;
        part[o] = m_run[i];
        part[(size_t)n_split * T + o] = se_run[i];
        part[2 * (size_t)n_split * T + o] = tg;
      }
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

// A row-major (rows, cols) bf16 matrix read in (box_rows, box_cols) boxes,
// 128-byte swizzled; boxes past the edge are filled with zeros.
bool encode_bf16(CUtensorMap* map, const void* ptr, int rows, int cols,
                 int box_rows, int box_cols) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kRoundLogits>
cudaError_t launch_wgmma(const void* x, const void* w, const int* lab,
                         float* part, int T, int D, int V, int n_split,
                         cudaStream_t s) {
  static bool configured = false;  // opt in to > 48 KB of shared memory once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ce_wgmma_kernel<kRoundLogits>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kWgmmaSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap tm_x, tm_w;
  if (!encode_bf16(&tm_x, x, T, D, kBT, kWK) ||
      !encode_bf16(&tm_w, w, D, V, kWK, kBoxV))
    return cudaErrorInvalidValue;
  const dim3 grid((T + kBT - 1) / kBT, n_split);
  ce_wgmma_kernel<kRoundLogits><<<grid, kWgThreads, kWgmmaSmem, s>>>(
      tm_x, tm_w, lab, part, T, D, V, n_split);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_ce_launch(const void* x, const void* w, const void* labels,
                               void* part, void* lse, void* tgt, int T, int D,
                               int V, int is_bf16, int round_logits,
                               void* stream) {
  if (T <= 0 || D <= 0 || V <= 0 || D % 8 != 0 || V % 8 != 0 ||
      (round_logits && !is_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_split = (V + kSplitCols - 1) / kSplitCols;
  if (n_split > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* lab = static_cast<const int*>(labels);
  auto* p = static_cast<float*>(part);
  cudaError_t err;
  if (is_bf16) {
    err = round_logits ? launch_wgmma<true>(x, w, lab, p, T, D, V, n_split, s)
                       : launch_wgmma<false>(x, w, lab, p, T, D, V, n_split, s);
  } else {
    ce_tiles_kernel<<<dim3((T + kBT - 1) / kBT, n_split), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), lab, p, T,
        D, V, n_split);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_merge_kernel<<<(T + 255) / 256, 256, 0, s>>>(
      p, lab, static_cast<float*>(lse), static_cast<float*>(tgt), T, V,
      n_split);
  return static_cast<int>(cudaGetLastError());
}
