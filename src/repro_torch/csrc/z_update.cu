// z_update.cu — streamed dark-set candidate selection (FlyMC z-update).
//
// Replaces the TPU kernel repro/kernels/z_update/kernel.py
// (z_candidates_pallas_chains, its pallas_call at kernel.py:129).
//
// For every position pos in [num_k, N) of chain k's partition array arr_k
// it takes 24 bits of Threefry-2x32(kw0_k, kw1_k; DRAW_CAND, arr_k[pos]) —
// uint32 arithmetic, so every shift is logical — and the datum is a
// candidate iff bits24 < q_bits. Candidate ids are compacted in
// arr-position order into cand[k, :cap] (slots past the count hold N, writes
// at slots >= cap are dropped) and count[k] is the true total, which may
// exceed cap (the driver's overflow signal).
//
// What bounds it on an H100: its byte bound is K·N·4 bytes of arr read once
// plus K·cap·4 bytes written, a few microseconds at N = 1.8M — but each
// datum also costs ~80 integer operations of Threefry, and this
// first version reads arr and hashes it twice, so integer throughput and the
// three launches set its time. The TPU kernel kept its order and its running
// count in a sequential grid; blocks on the GPU run in no order, so the
// compaction is three launches:
//   1. per-tile candidate counts (a tile is 8 warps × 8 rounds × 32 lanes =
//      2048 consecutive positions; each round's flags are one warp ballot);
//   2. per-chain exclusive scan of the tile counts (one block per chain),
//      which also writes the chain's total and fills cand[count:cap] with N;
//   3. recompute the flags and scatter: a candidate's slot is its tile's
//      offset + its warp's offset in the tile + the popc of the ballot bits
//      below its lane, i.e. its rank in arr-position order.
// The result is bitwise the plain version's (kernels/z_update/ref.py): the
// RNG is pure integer math and the order is the stable one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRounds = 8;
constexpr int kTile = kWarps * kRounds * 32;  // positions per block
constexpr int kScanThreads = 1024;
constexpr uint32_t kDrawCand = 1;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

__device__ __forceinline__ uint32_t threefry_x0(uint32_t k0, uint32_t k1,
                                                uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int r = 0; r < 5; ++r) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl(x1, rot[r % 2][i]) ^ x0;
    }
    x0 += ks[(r + 1) % 3];
    x1 += ks[(r + 2) % 3] + (uint32_t)(r + 1);
  }
  return x0;
}

// Ballot masks of this warp's kRounds rounds of 32 consecutive positions.
__device__ __forceinline__ void candidate_masks(
    const int32_t* __restrict__ arr_k, int64_t num, int N, uint32_t k0,
    uint32_t k1, uint32_t q_bits, int64_t base, uint32_t* masks,
    int32_t* datum) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    int64_t pos = base + r * 32 + lane;
    bool cand = false;
    int32_t id = 0;
    if (pos < N) {
      id = arr_k[pos];
      if (pos >= num) {
        uint32_t b = threefry_x0(k0, k1, kDrawCand, (uint32_t)id);
        cand = (b >> 8) < q_bits;
      }
    }
    datum[r] = id;
    masks[r] = __ballot_sync(0xffffffffu, cand);
  }
}

__global__ void z_tile_counts(const int32_t* __restrict__ arr,
                              int64_t arr_stride,
                              const int64_t* __restrict__ num,
                              const int64_t* __restrict__ kw,
                              int32_t* __restrict__ tile_counts, int N,
                              uint32_t q_bits) {
  __shared__ int warp_counts[kWarps];
  const int k = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int64_t base = (int64_t)blockIdx.x * kTile + warp * kRounds * 32;
  uint32_t masks[kRounds];
  int32_t datum[kRounds];
  candidate_masks(arr + k * arr_stride, num[k], N, (uint32_t)kw[2 * k],
                  (uint32_t)kw[2 * k + 1], q_bits, base, masks, datum);
  int cnt = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) cnt += __popc(masks[r]);
  if (threadIdx.x % 32 == 0) warp_counts[warp] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += warp_counts[w];
    tile_counts[(int64_t)k * gridDim.x + blockIdx.x] = s;
  }
}

// grid K, kScanThreads threads: exclusive scan of the chain's tile counts in
// place; count[k] = total; cand[k, total:cap] = N.
__global__ void z_scan(int32_t* __restrict__ tile_counts,
                       int32_t* __restrict__ count,
                       int32_t* __restrict__ cand, int ntiles, int cap,
                       int N) {
  __shared__ int warp_sums[kScanThreads / 32];
  __shared__ int carry;
  const int k = blockIdx.x;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  int32_t* tc = tile_counts + (int64_t)k * ntiles;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < ntiles; base += kScanThreads) {
    int i = base + threadIdx.x;
    int v = i < ntiles ? tc[i] : 0;
    int x = v;  // inclusive warp scan
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int ws = warp_sums[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        int y = __shfl_up_sync(0xffffffffu, ws, off);
        if (lane >= off) ws += y;
      }
      warp_sums[lane] = ws;  // inclusive over warps
    }
    __syncthreads();
    int before = carry + (warp > 0 ? warp_sums[warp - 1] : 0);
    if (i < ntiles) tc[i] = before + x - v;  // exclusive
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();
  }
  const int total = carry;
  if (threadIdx.x == 0) count[k] = total;
  for (int s = total + threadIdx.x; s < cap; s += blockDim.x)
    cand[(int64_t)k * cap + s] = N;
}

__global__ void z_scatter(const int32_t* __restrict__ arr,
                          int64_t arr_stride,
                          const int64_t* __restrict__ num,
                          const int64_t* __restrict__ kw,
                          const int32_t* __restrict__ tile_offsets,
                          int32_t* __restrict__ cand, int N, uint32_t q_bits,
                          int cap) {
  __shared__ int warp_off[kWarps];
  const int k = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t base = (int64_t)blockIdx.x * kTile + warp * kRounds * 32;
  uint32_t masks[kRounds];
  int32_t datum[kRounds];
  candidate_masks(arr + k * arr_stride, num[k], N, (uint32_t)kw[2 * k],
                  (uint32_t)kw[2 * k + 1], q_bits, base, masks, datum);
  int cnt = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) cnt += __popc(masks[r]);
  if (lane == 0) warp_off[warp] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = tile_offsets[(int64_t)k * gridDim.x + blockIdx.x];
    for (int w = 0; w < kWarps; ++w) {
      int c = warp_off[w];
      warp_off[w] = s;
      s += c;
    }
  }
  __syncthreads();
  int slot0 = warp_off[warp];
  const uint32_t below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (masks[r] & (1u << lane)) {
      int slot = slot0 + __popc(masks[r] & below);
      if (slot < cap) cand[(int64_t)k * cap + slot] = datum[r];
    }
    slot0 += __popc(masks[r]);
  }
}

}  // namespace

extern "C" int z_candidates_launch(const int32_t* arr, int64_t arr_stride,
                                   const int64_t* num,
                                   const int64_t* kw, int32_t* cand,
                                   int32_t* count, int32_t* tile_counts, int K,
                                   int N, int q_bits, int cap, void* stream) {
  if (K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ntiles = (N + kTile - 1) / kTile;
  dim3 grid(ntiles, K);
  z_tile_counts<<<grid, kWarps * 32, 0, s>>>(arr, arr_stride, num, kw, tile_counts, N,
                                            (uint32_t)q_bits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  z_scan<<<K, kScanThreads, 0, s>>>(tile_counts, count, cand, ntiles, cap, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  z_scatter<<<grid, kWarps * 32, 0, s>>>(arr, arr_stride, num, kw, tile_counts, cand, N,
                                        (uint32_t)q_bits, cap);
  return (int)cudaGetLastError();
}
