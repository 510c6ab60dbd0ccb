// rglru_scan.cu — the RG-LRU linear recurrence over a sequence, and its
// backward.
//
// Replaces the TPU kernel repro/kernels/rglru_scan/kernel.py (rglru_pallas,
// its pallas_call at kernel.py:61).
//
// rglru_scan_kernel: for every batch row b and channel c it runs h_t =
// exp(log_a_t)·h_{t-1} + b_t from h_0 (zeros, or the h0 operand) over t =
// 0..S-1 in float32, and writes y[b, t, c] = h_t and h_last[b, c] = h_{S-1}
// — the function of kernels/rglru_scan/ref.py, with the same operations in
// the same order: expf (no fast math), one rounded multiply and one rounded
// add per step (__fmul_rn/__fadd_rn keep nvcc from contracting them into an
// FMA). So h_last is bitwise y[:, -1], and a scan of [0, s) followed by one
// of [s, S) from its h_last is bitwise one scan of [0, S).
//
// rglru_scan_bwd_kernel: the backward, walking each channel backwards in
// time with the roundings of ref.py::rglru_bwd_ref (the reversed scan
// composed with torch products):
//   G_{S-1} = 1·g_last + ḡ_{S-1};  G_t = a_{t+1}·G_{t+1} + ḡ_t,
//   ∂b_t = G_t,  ∂log_a_t = (G_t·a_t)·h_{t-1},  ∂h0 = a_0·G_0,
// with a_t = expf(log_a_t) computed once a step: it serves ∂log_a_t and then
// the decay of G_{t-1}. h_{-1} is h0 (or 0); g_last absent is 0.
//
// The TPU kernel uses a closed form over each chunk, h_i = e^{cumA_i}(h_0 +
// Σ_j b_j e^{-cumA_j}); e^{-cumA} overflows float32 once a chunk's summed
// log-decay passes about -88, which the model's own gates reach within a few
// dozen steps (log a ≈ -5 per step). These kernels run the recurrence itself
// and never form e^{-cumA}; nor do they reassociate it into chunk pairs.
//
// What bounds them on an H100: bytes. The forward reads log_a and b and
// writes y (3·B·S·C·4 bytes, ~135 us at the serving path's B=4, S=2304,
// C=4096); the backward reads log_a, ḡ and h and writes ∂log_a and ∂b
// (5·B·S·C·4 bytes, ~100 us at the training path's B=2, S=2048). The
// arithmetic is an expf, a multiply and an add a step, and the serial chain
// (one multiply and one add, ~8 cycles) is ~10 us over 2,304 steps. A thread
// a channel loading its own steps keeps too few bytes in flight: keeping
// 3.35 TB/s busy at a loaded latency of ~0.7 us needs ~2.3 MB over the card.
// Staged, the kernels run at ~0.8 of the bound, and the warp's own
// instructions, not the loads, set the pace.
//
// Design: one CTA of one warp per (batch row, 32-channel tile) — 512 CTAs at
// the serving shape, 256 at training's — so a time step of the tile is one
// 128-byte row. Its inputs are staged in shared memory, kRows = 64 steps a
// stage, in a ring of kStages = 3 stages (16 KB of log_a and b a stage
// forward, 48 KB a CTA, four CTAs an SM; 24 KB with ḡ and h backward, 72 KB,
// three an SM), filled ahead while the warp walks the current stage row by
// row (lane = channel, conflict-free). The backward fills its ring in
// reverse tile order and walks each tile from its last row; its h tile holds
// rows [t0-1, t0+kRows-1), so h_{t-1} sits beside log_a_t, and row -1 is
// replaced by h0. Two routes:
//   * TMA (C % 4 == 0 and 16-byte aligned operands), the path's: lane 0
//     issues one cp.async.bulk.tensor.3d box of (32 channels, 64 steps, 1
//     row) per array and stage over the (C, S, B) tensor, its completion
//     counted by the stage's mbarrier; the ragged edges of C and S read as
//     zeros (TMA needs the row stride C·4 to be a multiple of 16 bytes).
//     Each step's result is written back into the stage over the input it
//     consumed (y_t over log_a_t; ∂b_t over ḡ_t, ∂log_a_t over log_a_t),
//     and the tile leaves by one TMA store per array, which writes nothing
//     outside the tensor. Lane 0 refills a stage once the store of the
//     next tile has been issued and this one's has read shared memory, so
//     one stage is in flight ahead of the one being walked (16 or 24 KB a
//     CTA, 64–72 KB an SM). The warp spends no instruction on a global
//     store: a TMA store took 1.3% (prefill shape) and 7–8% (training
//     shape) less time than a 128-byte store from registers a row (H100
//     80GB HBM3, 700 W).
//   * cp.async (any C): each lane copies its own channel's column with
//     4-byte cp.async.ca, one commit group a stage, waits for its own
//     groups (no lane reads another's column, so no barrier is needed) and
//     writes its results from registers; two stages are in flight ahead.
// The warp itself is the producer: it refills a stage once every lane is
// done with it (__syncwarp), so the ring needs no "empty" barrier.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "tma.cuh"

namespace {

constexpr int kCh = 32;  // channels of a CTA: one warp, one 128-byte row
constexpr int kRows = 64;  // time steps of a stage
constexpr int kStages = 3;
constexpr int kTile = kRows * kCh;  // floats of one array in one stage
constexpr int kTileBytes = kTile * 4;  // 8 KB
constexpr int kFwdSmem = kStages * (2 * kTileBytes + 8);  // + the mbarriers
constexpr int kBwdSmem = kStages * (3 * kTileBytes + 8);

// cp.async route: the lane of channel c copies rows [t0, t0 + kRows) ∩ [0, S)
// of its channel of the (B, S, C) array `src` into its column of the tile
// `dst`, whose row 0 is time t0. Other rows are left as they are: no step
// reads them (row -1 of the backward's h tile is written with h0).
__device__ __forceinline__ void cp_rows(float* dst, const float* src, int b,
                                        int t0, int S, int C, int c,
                                        int lane) {
  const int lo = max(t0, 0), hi = min(t0 + kRows, S);
  const float* p = src + ((size_t)b * S + lo) * C + c;
  for (int t = lo; t < hi; ++t, p += C)
    cp_async4(dst + (t - t0) * kCh + lane, p);
}

__device__ __forceinline__ void init_barriers(uint64_t* full, int lane) {
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(full + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
}

template <bool kTma>
__global__ void __launch_bounds__(kCh) rglru_scan_kernel(
    const __grid_constant__ CUtensorMap tm_a,  // log_a (TMA route)
    const __grid_constant__ CUtensorMap tm_b,  // bx (TMA route)
    const __grid_constant__ CUtensorMap tm_y,  // y (TMA route)
    const float* __restrict__ log_a,  // (B, S, C)
    const float* __restrict__ bx,  // (B, S, C)
    const float* __restrict__ h0,  // (B, C) or null
    float* __restrict__ y,  // (B, S, C)
    float* __restrict__ h_last,  // (B, C)
    int S, int C, int n_ctile) {
  extern __shared__ __align__(128) float ring[];  // [kStages][2][kRows][kCh]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * 2 * kTile);
  const int lane = threadIdx.x;
  const int b = blockIdx.x / n_ctile;
  const int c0 = (blockIdx.x - b * n_ctile) * kCh;
  const int c = c0 + lane;
  const bool active = c < C;
  const int n_tiles = (S + kRows - 1) / kRows;
  if constexpr (kTma) init_barriers(full, lane);

  auto fill = [&](int k) {  // stage tile k, if there is one
    float* st = ring + (k % kStages) * 2 * kTile;
    if constexpr (kTma) {  // lane 0 only
      if (k < n_tiles) {
        const uint32_t bar = smem_u32(full + k % kStages);
        mbar_expect_tx(bar, 2 * kTileBytes);
        tma_load_3d(smem_u32(st), &tm_a, bar, c0, k * kRows, b);
        tma_load_3d(smem_u32(st + kTile), &tm_b, bar, c0, k * kRows, b);
      }
    } else {
      if (k < n_tiles && active) {
        cp_rows(st, log_a, b, k * kRows, S, C, c, lane);
        cp_rows(st + kTile, bx, b, k * kRows, S, C, c, lane);
      }
      cp_async_commit();  // one group a tile, empty or not
    }
  };
  if (!kTma || lane == 0)
    for (int k = 0; k < kStages; ++k) fill(k);

  float h = (active && h0 != nullptr) ? h0[(size_t)b * C + c] : 0.f;
  for (int k = 0; k < n_tiles; ++k) {
    float* st = ring + (k % kStages) * 2 * kTile;
    float* sa = st + lane;
    const int rows = min(kRows, S - k * kRows);
    if constexpr (kTma) {
      mbar_wait(smem_u32(full + k % kStages), (k / kStages) & 1);
      // every lane walks its column; those past C are zeros, never stored
#pragma unroll 8
      for (int r = 0; r < rows; ++r) {
        h = __fadd_rn(__fmul_rn(expf(sa[r * kCh]), h), sa[kTile + r * kCh]);
        sa[r * kCh] = h;  // y_t over log_a_t
      }
      fence_proxy_async();  // this lane's writes, before the store reads them
      __syncwarp();
      if (lane == 0) {
        tma_store_3d(&tm_y, smem_u32(st), c0, k * kRows, b);
        bulk_commit();
        bulk_wait_read<1>();  // the previous tile's store has read its stage
        if (k > 0) fill(k - 1 + kStages);
      }
    } else {
      cp_async_wait<kStages - 1>();
      if (active) {
        float* yk = y + ((size_t)b * S + k * kRows) * C + c;
#pragma unroll 8
        for (int r = 0; r < rows; ++r) {
          h = __fadd_rn(__fmul_rn(expf(sa[r * kCh]), h), sa[kTile + r * kCh]);
          yk[(size_t)r * C] = h;
        }
      }
      fill(k + kStages);
    }
  }
  if constexpr (kTma) {
    if (lane == 0) bulk_wait<0>();
  }
  if (active) h_last[(size_t)b * C + c] = h;
}

template <bool kTma>
__global__ void __launch_bounds__(kCh) rglru_scan_bwd_kernel(
    const __grid_constant__ CUtensorMap tm_a,  // log_a (TMA route)
    const __grid_constant__ CUtensorMap tm_g,  // g_h (TMA route)
    const __grid_constant__ CUtensorMap tm_h,  // h (TMA route)
    const __grid_constant__ CUtensorMap tm_da,  // d_log_a (TMA route)
    const __grid_constant__ CUtensorMap tm_db,  // d_bx (TMA route)
    const float* __restrict__ log_a,  // (B, S, C)
    const float* __restrict__ g_h,  // (B, S, C): ḡ, the cotangent of y
    const float* __restrict__ h,  // (B, S, C): the forward's y
    const float* __restrict__ h0,  // (B, C) or null
    const float* __restrict__ g_last,  // (B, C) or null (zeros)
    float* __restrict__ d_log_a,  // (B, S, C) or null (not wanted)
    float* __restrict__ d_bx,  // (B, S, C)
    float* __restrict__ d_h0,  // (B, C) or null (not wanted)
    int S, int C, int n_ctile) {
  extern __shared__ __align__(128) float ring[];  // [kStages][3][kRows][kCh]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * 3 * kTile);
  const int lane = threadIdx.x;
  const int b = blockIdx.x / n_ctile;
  const int c0 = (blockIdx.x - b * n_ctile) * kCh;
  const int c = c0 + lane;
  const bool active = c < C;
  const bool with_h = d_log_a != nullptr;  // h is read only for ∂log_a
  const int n_tiles = (S + kRows - 1) / kRows;
  if constexpr (kTma) init_barriers(full, lane);

  auto fill = [&](int j) {  // stage the j-th tile of the walk: time tile n-1-j
    const int t0 = (n_tiles - 1 - j) * kRows;
    float* st = ring + (j % kStages) * 3 * kTile;
    if constexpr (kTma) {  // lane 0 only
      if (j < n_tiles) {
        const uint32_t bar = smem_u32(full + j % kStages);
        mbar_expect_tx(bar, (with_h ? 3 : 2) * kTileBytes);
        tma_load_3d(smem_u32(st), &tm_a, bar, c0, t0, b);
        tma_load_3d(smem_u32(st + kTile), &tm_g, bar, c0, t0, b);
        if (with_h)
          tma_load_3d(smem_u32(st + 2 * kTile), &tm_h, bar, c0, t0 - 1, b);
      }
    } else {
      if (j < n_tiles && active) {
        cp_rows(st, log_a, b, t0, S, C, c, lane);
        cp_rows(st + kTile, g_h, b, t0, S, C, c, lane);
        if (with_h) cp_rows(st + 2 * kTile, h, b, t0 - 1, S, C, c, lane);
      }
      cp_async_commit();
    }
  };
  if (!kTma || lane == 0)
    for (int j = 0; j < kStages; ++j) fill(j);

  float G = (active && g_last != nullptr) ? g_last[(size_t)b * C + c] : 0.f;
  // exp(0): G_{S-1} = 1·g_last + ḡ_{S-1}, as the reversed scan rounds it
  float a_next = 1.f;
  const float h_init = (active && h0 != nullptr) ? h0[(size_t)b * C + c] : 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    const int t0 = (n_tiles - 1 - j) * kRows;
    float* st = ring + (j % kStages) * 3 * kTile;
    float* sl = st + lane;  // log_a_t, then ∂log_a_t; ḡ_t, then ∂b_t; h_{t-1}
    const int rows = min(kRows, S - t0);
    if constexpr (kTma) {
      mbar_wait(smem_u32(full + j % kStages), (j / kStages) & 1);
      if (with_h && t0 == 0) sl[2 * kTile] = h_init;  // row 0 holds h_{-1}
#pragma unroll 8
      for (int r = rows - 1; r >= 0; --r) {
        G = __fadd_rn(__fmul_rn(a_next, G), sl[kTile + r * kCh]);
        const float a = expf(sl[r * kCh]);
        sl[kTile + r * kCh] = G;
        if (with_h)
          sl[r * kCh] = __fmul_rn(__fmul_rn(G, a), sl[2 * kTile + r * kCh]);
        a_next = a;
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        tma_store_3d(&tm_db, smem_u32(st + kTile), c0, t0, b);
        if (with_h) tma_store_3d(&tm_da, smem_u32(st), c0, t0, b);
        bulk_commit();
        bulk_wait_read<1>();
        if (j > 0) fill(j - 1 + kStages);
      }
    } else {
      cp_async_wait<kStages - 1>();
      if (active) {
        if (with_h && t0 == 0) sl[2 * kTile] = h_init;
        const size_t base = ((size_t)b * S + t0) * C + c;
#pragma unroll 8
        for (int r = rows - 1; r >= 0; --r) {
          G = __fadd_rn(__fmul_rn(a_next, G), sl[kTile + r * kCh]);
          const float a = expf(sl[r * kCh]);
          const size_t i = base + (size_t)r * C;
          d_bx[i] = G;
          if (with_h)
            d_log_a[i] = __fmul_rn(__fmul_rn(G, a), sl[2 * kTile + r * kCh]);
          a_next = a;
        }
      }
      fill(j + kStages);
    }
  }
  if constexpr (kTma) {
    if (lane == 0) bulk_wait<0>();
  }
  if (active && d_h0 != nullptr) d_h0[(size_t)b * C + c] = __fmul_rn(a_next, G);
}

// A (B, S, C) float32 tensor read in boxes of kCh channels × kRows steps of
// one batch row; boxes past an edge read zeros there.
bool encode_bsc(CUtensorMap* map, const void* ptr, int B, int S, int C) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(C) * 4,
                                 static_cast<cuuint64_t>(S) * C * 4};
  const cuuint32_t box[3] = {kCh, kRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The TMA route takes row strides of whole 16-byte units and 16-byte
// aligned bases (null operands are not read or written).
bool tma_route(int C, std::initializer_list<const void*> ptrs) {
  if (C % 4 != 0) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// Opt the kernel in to its dynamic shared memory (> 48 KB) once.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = e == cudaSuccess;
  return e;
}

// The grid: one CTA per (batch row, channel tile), batch rows folded into x.
bool grid_of(int B, int S, int C, int* n_ctile, unsigned* grid) {
  if (B <= 0 || S <= 0 || C <= 0) return false;
  *n_ctile = (C + kCh - 1) / kCh;
  const long long n = static_cast<long long>(B) * *n_ctile;
  if (n > 0x7fffffffll) return false;
  *grid = static_cast<unsigned>(n);
  return true;
}

}  // namespace

extern "C" int rglru_scan_launch(const void* log_a, const void* bx,
                                 const void* h0, void* y, void* h_last, int B,
                                 int S, int C, void* stream) {
  int n_ctile;
  unsigned grid;
  if (!grid_of(B, S, C, &n_ctile, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* la = static_cast<const float*>(log_a);
  const auto* bv = static_cast<const float*>(bx);
  const auto* hi = static_cast<const float*>(h0);
  auto* yo = static_cast<float*>(y);
  auto* hl = static_cast<float*>(h_last);
  CUtensorMap ta{}, tb{}, ty{};
  cudaError_t e;
  if (tma_route(C, {log_a, bx, y})) {
    static bool done = false;
    e = opt_in(rglru_scan_kernel<true>, kFwdSmem, done);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (!encode_bsc(&ta, log_a, B, S, C) || !encode_bsc(&tb, bx, B, S, C) ||
        !encode_bsc(&ty, y, B, S, C))
      return static_cast<int>(cudaErrorInvalidValue);
    rglru_scan_kernel<true><<<grid, kCh, kFwdSmem, s>>>(
        ta, tb, ty, la, bv, hi, yo, hl, S, C, n_ctile);
  } else {
    static bool done = false;
    e = opt_in(rglru_scan_kernel<false>, kFwdSmem, done);
    if (e != cudaSuccess) return static_cast<int>(e);
    rglru_scan_kernel<false><<<grid, kCh, kFwdSmem, s>>>(
        ta, tb, ty, la, bv, hi, yo, hl, S, C, n_ctile);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rglru_scan_bwd_launch(const void* log_a, const void* g_h,
                                     const void* h, const void* h0,
                                     const void* g_last, void* d_log_a,
                                     void* d_bx, void* d_h0, int B, int S,
                                     int C, void* stream) {
  int n_ctile;
  unsigned grid;
  if (!grid_of(B, S, C, &n_ctile, &grid) || d_bx == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* la = static_cast<const float*>(log_a);
  const auto* gh = static_cast<const float*>(g_h);
  const auto* hv = static_cast<const float*>(h);
  const auto* hi = static_cast<const float*>(h0);
  const auto* gl = static_cast<const float*>(g_last);
  auto* dla = static_cast<float*>(d_log_a);
  auto* dbx = static_cast<float*>(d_bx);
  auto* dh0 = static_cast<float*>(d_h0);
  const bool with_h = d_log_a != nullptr;
  CUtensorMap ta{}, tg{}, th{}, tda{}, tdb{};
  cudaError_t e;
  if (tma_route(C, {log_a, g_h, d_bx, with_h ? h : nullptr, d_log_a})) {
    static bool done = false;
    e = opt_in(rglru_scan_bwd_kernel<true>, kBwdSmem, done);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (!encode_bsc(&ta, log_a, B, S, C) || !encode_bsc(&tg, g_h, B, S, C) ||
        !encode_bsc(&tdb, d_bx, B, S, C) ||
        (with_h && (!encode_bsc(&th, h, B, S, C) ||
                    !encode_bsc(&tda, d_log_a, B, S, C))))
      return static_cast<int>(cudaErrorInvalidValue);
    rglru_scan_bwd_kernel<true><<<grid, kCh, kBwdSmem, s>>>(
        ta, tg, th, tda, tdb, la, gh, hv, hi, gl, dla, dbx, dh0, S, C,
        n_ctile);
  } else {
    static bool done = false;
    e = opt_in(rglru_scan_bwd_kernel<false>, kBwdSmem, done);
    if (e != cudaSuccess) return static_cast<int>(e);
    rglru_scan_bwd_kernel<false><<<grid, kCh, kBwdSmem, s>>>(
        ta, tg, th, tda, tdb, la, gh, hv, hi, gl, dla, dbx, dh0, S, C,
        n_ctile);
  }
  return static_cast<int>(cudaGetLastError());
}
