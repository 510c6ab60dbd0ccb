// z_update.cu — streamed dark-set candidate selection (FlyMC z-update).
//
// Replaces the TPU kernel repro/kernels/z_update/kernel.py
// (z_candidates_pallas_chains, its pallas_call at kernel.py:129).
//
// Chains may come in lanes (L lanes of K chains, the sampling service's
// "vmap" lanes): chain k = l·K + j streams row j of lane l's (K, N)
// partition block, which may sit anywhere in memory (a lane stride and a
// chain stride). Every other operand and output is indexed by the flat
// chain k, and a chain's work never depends on L or on its neighbours, so
// L·K chains in one launch are bitwise L launches of K chains; L = 1 is the
// launch as it was before the lane axis.
//
// For every position pos in [num_k, N) of chain k's partition array arr_k
// it takes 24 bits of Threefry-2x32(kw0_k, kw1_k; DRAW_CAND, arr_k[pos]) —
// uint32 arithmetic, so every shift is logical — and the datum is a
// candidate iff bits24 < q_bits. Candidate ids are compacted in
// arr-position order into cand[k, :cap] (slots past the count hold N, writes
// at slots >= cap are dropped) and count[k] is the true total, which may
// exceed cap (the driver's overflow signal).
//
// What bounds it on an H100. Bytes: K·N·4 of arr read once plus K·cap·4
// written, ~4 µs at N = 1.8M. Integer issue: each datum costs one Threefry,
// whose 19 rotations and 19 xors (of ~70 integer instructions) run only on
// the ALU pipe, 64 lanes an SM: ~8 µs at N = 1.8M — so at that size the
// kernel is bound by integer issue, and hashing each
// datum once is what matters. At the main path's N = 12,214 both are well
// under a microsecond, and the floor is launch latency. So the design is one
// launch a call and one hash a datum: a single-pass compaction with
// decoupled look-back (Merrill & Garland, "Single-pass parallel prefix scan
// with decoupled look-back", 2016), per chain:
//   * a tile is 8 warps × 8 rounds × 32 lanes = 2048 consecutive positions;
//     each round's candidate flags are one warp ballot. A block hashes its
//     tile once and keeps the ballot masks and datum ids in registers;
//   * a block takes its tile index from its chain's atomic ticket, not from
//     blockIdx: every tile before it was taken by a block that is running or
//     done, so waiting on a predecessor cannot deadlock;
//   * it publishes its tile's count in a status word (flag A), looks back
//     over its predecessors' words with one warp, 32 at a time, adding
//     aggregates until it meets an inclusive prefix (flag P), publishes its
//     own inclusive prefix, and scatters each candidate to its tile's offset
//     + its warp's offset + the popc of the ballot bits below its lane: its
//     rank in arr-position order. Counts are integers, so the result is
//     bitwise the plain version's (kernels/z_update/ref.py) whatever order
//     the blocks run in;
//   * the tile with the chain's last ticket learns the total: it writes
//     count[k] and fills cand[k, count:cap] with N;
//   * a status word is one 64-bit store: the chain's epoch (32 bits), the
//     flag (2 bits) and the count (30 bits; the wrapper holds N below 2^30).
//     A word whose epoch is not this call's is stale and read as "not yet",
//     so no word from an earlier call, of any N, is taken for this call's;
//   * the workspace (per chain: ticket, arrival counter, epoch; then the
//     status words, one row of tiles per chain) is persistent, zeroed once by
//     the wrapper. Every block takes an arrival ticket when it is done; the
//     chain's last block resets the ticket and the counter and bumps the
//     epoch, so the workspace is clean for the next call, of any N and K,
//     without a memset launch. Calls on one stream run one after another and
//     may share a workspace; two calls in flight at once on one workspace
//     (two streams, or two host threads, sharing it) are not supported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRounds = 8;
constexpr int kTile = kWarps * kRounds * 32;  // positions per block
constexpr uint32_t kDrawCand = 1;
constexpr unsigned long long kFlagAggregate = 1ull << 30;
constexpr unsigned long long kFlagPrefix = 2ull << 30;
constexpr unsigned long long kCountMask = (1ull << 30) - 1;

struct ChainCtl {  // 16 bytes per chain at the head of the workspace
  unsigned int ticket, arrived, epoch, pad;
};

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

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long w) {
  *reinterpret_cast<volatile unsigned long long*>(p) = w;
}

// grid (ntiles, L·K), kWarps warps. status: L·K rows of status_stride
// words. Chain (l, j)'s partition array starts at arr + l·arr_lane +
// j·arr_stride.
__global__ void __launch_bounds__(kWarps * 32)
z_candidates_kernel(const int32_t* __restrict__ arr, int64_t arr_stride,
                    int64_t arr_lane, int lane_chains,
                    const int64_t* __restrict__ num,
                    const int64_t* __restrict__ kw,
                    int32_t* __restrict__ cand, int32_t* __restrict__ count,
                    ChainCtl* __restrict__ ctl,
                    unsigned long long* __restrict__ status,
                    int64_t status_stride, int N, uint32_t q_bits, int cap) {
  __shared__ int s_tile;
  __shared__ unsigned int s_epoch;
  __shared__ int warp_off[kWarps];
  __shared__ int s_total;
  const int k = blockIdx.y;
  const int ntiles = gridDim.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  ChainCtl* c = ctl + k;

  if (threadIdx.x == 0) {
    s_epoch = *reinterpret_cast<volatile unsigned int*>(&c->epoch);
    s_tile = (int)atomicAdd(&c->ticket, 1u);
  }
  __syncthreads();
  const int tile = s_tile;
  const unsigned int epoch = s_epoch;
  const unsigned long long tag = (unsigned long long)epoch << 32;

  // ---- hash the tile once: ballot masks and ids stay in registers -------
  const int ln = k / lane_chains;
  const int32_t* arr_k =
      arr + ln * arr_lane + (int64_t)(k - ln * lane_chains) * arr_stride;
  const int64_t n0 = num[k];
  const uint32_t k0 = (uint32_t)kw[2 * k], k1 = (uint32_t)kw[2 * k + 1];
  const int base = tile * kTile + warp * kRounds * 32 + lane;  // N < 2^30
  int32_t datum[kRounds];
  uint32_t masks[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int pos = base + r * 32;
    datum[r] = pos < N ? arr_k[pos] : 0;
  }
  // Hash every round without a branch, so the rounds' independent chains
  // interleave; positions outside [num, N) are masked afterwards.
  uint32_t bits[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r)
    bits[r] = threefry_x0(k0, k1, kDrawCand, (uint32_t)datum[r]);
  int cnt = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int pos = base + r * 32;
    masks[r] = __ballot_sync(0xffffffffu,
                             pos < N && pos >= n0 && (bits[r] >> 8) < q_bits);
    cnt += __popc(masks[r]);
  }
  if (lane == 0) warp_off[warp] = cnt;
  __syncthreads();

  // ---- publish, look back, publish the inclusive prefix (warp 0) --------
  if (warp == 0) {
    const int v = lane < kWarps ? warp_off[lane] : 0;
    int incl = v;  // inclusive scan of the warp counts
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    const int agg = __shfl_sync(0xffffffffu, incl, kWarps - 1);
    unsigned long long* st = status + (int64_t)k * status_stride;
    int excl = 0;
    if (tile == 0) {
      if (lane == 0) store_status(st, tag | kFlagPrefix | (unsigned)agg);
    } else {
      if (lane == 0)
        store_status(st + tile, tag | kFlagAggregate | (unsigned)agg);
      // Lane i reads predecessor (end − i); the window moves back 32 tiles
      // until it holds an inclusive prefix. Tile 0 always publishes one.
      for (int end = tile - 1;; end -= 32) {
        const int j = end - lane;
        unsigned long long w;
        bool ready;
        do {
          w = j >= 0 ? load_status(st + j) : (tag | kFlagPrefix);
          ready = (unsigned int)(w >> 32) == epoch &&
                  (w & (kFlagAggregate | kFlagPrefix)) != 0;
        } while (!__all_sync(0xffffffffu, ready));
        const unsigned prefix = __ballot_sync(0xffffffffu,
                                              (w & kFlagPrefix) != 0);
        // Lanes up to the nearest prefix (lowest such lane) contribute.
        const int stop = prefix ? __ffs(prefix) - 1 : 31;
        int part = lane <= stop && j >= 0 ? (int)(w & kCountMask) : 0;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        excl += part;
        if (prefix) break;
      }
      if (lane == 0)
        store_status(st + tile, tag | kFlagPrefix | (unsigned)(excl + agg));
    }
    if (lane < kWarps) warp_off[lane] = excl + incl - v;  // per-warp offset
    if (lane == 0 && tile == ntiles - 1) {
      s_total = excl + agg;
      count[k] = excl + agg;
    }
  }
  __syncthreads();

  // ---- scatter at the candidates' ranks in arr-position order -----------
  int32_t* cand_k = cand + (int64_t)k * cap;
  int slot0 = warp_off[warp];
  const uint32_t below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (masks[r] & (1u << lane)) {
      int slot = slot0 + __popc(masks[r] & below);
      if (slot < cap) cand_k[slot] = datum[r];
    }
    slot0 += __popc(masks[r]);
  }
  if (tile == ntiles - 1)
    for (int s = s_total + threadIdx.x; s < cap; s += blockDim.x)
      cand_k[s] = N;

  // ---- leave the workspace clean: the chain's last block resets it ------
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&c->arrived, 1u) == (unsigned int)(ntiles - 1)) {
      c->ticket = 0u;
      c->arrived = 0u;
      c->epoch = epoch + 1u;
    }
  }
}

}  // namespace

// K is the chain count of every lane, L the lane count: L·K chains in all.
extern "C" int z_candidates_launch(const int32_t* arr, int64_t arr_stride,
                                   int64_t arr_lane, const int64_t* num,
                                   const int64_t* kw, int32_t* cand,
                                   int32_t* count, void* ctl, void* status,
                                   int64_t status_stride, int K, int L, int N,
                                   int q_bits, int cap, void* stream) {
  if (K <= 0 || L <= 0 || (int64_t)L * K > 65535 || N <= 0 || cap <= 0 ||
      (int64_t)N > (int64_t)kCountMask)
    return (int)cudaErrorInvalidValue;
  const int ntiles = (N + kTile - 1) / kTile;
  if (status_stride < ntiles) return (int)cudaErrorInvalidValue;
  z_candidates_kernel<<<dim3(ntiles, L * K), kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      arr, arr_stride, arr_lane, K, num, kw, cand, count,
      static_cast<ChainCtl*>(ctl),
      static_cast<unsigned long long*>(status), status_stride, N,
      (uint32_t)q_bits, cap);
  return (int)cudaGetLastError();
}
