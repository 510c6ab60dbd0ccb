// rwkv6_scan.cu — the chunked WKV6 recurrence of the RWKV6 time mix.
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan/kernel.py (rwkv6_pallas,
// its pallas_call at kernel.py:91), and adds what the model path needs and
// that kernel lacks: a carried-in state (state0), so a prefill cut into time
// chunks continues the recurrence from one time chunk to the next.
//
// For batch row b and head h it sweeps the sequence in chunks of c steps
// (1 <= c <= 64, S % c == 0) from S₀ = state0 (or zeros) and computes, per
// chunk, the closed form of kernels/rwkv6_scan/ref.py::wkv_chunk (the
// model's _wkv_chunk):
//   logp = cumsum(logw) inclusive down each column,
//   rq = r·exp(logp - logw), kk = k·exp(-logp), k2 = k·exp(logp_c - logp),
//   y  = tril_strict(rq·kkᵀ)·v + rq·S₀ + diag(r·u·k)·v,
//   S' = S₀·diag(exp(logp_c)) + k2ᵀ·v   (S is key × value),
// writes y (B, H, S, D) chunk by chunk and the final state (B, H, D, D)
// once. The model clips logw to [-1, -1e-6], so e^{±logp} stays within
// e^{±64}, inside float32; the strictly upper part of rq·kkᵀ is replaced by
// 0, never multiplied by a mask.
//
// What bounds it on an H100: bytes, narrowly, in principle. At the serving
// path's B=4, H=64, S=512, D=64, c=64 the four products are 3.2 GFLOP (the
// two triangular ones counted as triangles) against 176 MB of traffic:
// 0.053 ms at 3.35 TB/s, 0.048 ms at the CUDA cores' 67 TFLOP/s. The chunks
// of one head depend on each other through S and each product is small
// (64 × 64 × 64, a dependency after it), so a CTA keeps one head's sweep
// with S in shared memory, and the design works on what stalls the sweep:
//   - Tensor cores at float32 accuracy. The four products run as
//     mma.sync.m16n8k8 in TF32 with the 3xTF32 split: a = hi + lo, hi =
//     rna_tf32(a), lo = rna_tf32(a - hi), and a·b ≈ lo·hi + hi·lo + hi·hi
//     into one float32 accumulator (single-pass TF32 keeps ~3 digits, far
//     from the 1e-5 the kernel is held to). rna_tf32 is cvt.rna.tf32.f32's
//     rounding done in two integer instructions. Tiles of rq·kkᵀ wholly
//     above the diagonal are skipped, and A·v runs only over the columns of
//     A at or below each 16-row block's diagonal: the two triangular
//     products do 20 of 32 tiles, ~7.5 GFLOP of mma a call. mma.sync and not
//     wgmma: wgmma in TF32 reads both operands K-major from shared memory,
//     so v, k2 and S would each need a transposed, swizzled copy every chunk.
//   - A parallel decay scan. Four threads a column each scan 16 rows; three
//     shuffles give each its offset and the column's total. The same pass
//     forms rq, kk, k2, p_end and the bonus diag (shuffle sums over the
//     warp's 8 columns, then a fixed-order sum over the 8 warps).
//   - Staging. A chunk's r, k, v and logw arrive by cp.async (16 B a thread,
//     zero-filled past c and D); rq, kk and k2 are formed in place of r,
//     logw and k, and A has its own tile. One chunk is staged at a time: the
//     CTA takes 108 KB of shared memory, two CTAs (16 warps) share a SM and
//     the path's 256 (b, h) CTAs run in one wave; while one CTA waits for
//     its chunk, the other computes. A ring of two stages with the next
//     chunk in flight (178 KB, one CTA of 8 warps a SM, two waves) measured
//     slower (PERF.md): 8 warps hide less of the latency below. Splitting a
//     head over its value columns would repeat rq·kkᵀ in both halves for no
//     gain in CTAs a SM.
//   - Banks. A fragment reads 8 rows × 4 columns (the A operand, and B read
//     as [n][k]) or 4 rows × 8 columns (B read as [k][n], and the A operand
//     read transposed). Rows are padded to kLdA = 68 floats (≡ 4 mod 32) for
//     the first kind (r → rq, logw → kk, A) and kLdB = 72 (≡ 8) for the
//     second (k → k2, v, S), which puts each fragment on 32 banks. The scan
//     reads columns, four 16-row quarters a warp: the staged r, logw and k
//     XOR their 8-column group with their 16-row block (col ^ 8·(row/16)), so
//     the four quarters land on four groups of banks; a fragment's rows
//     share one 16-row block, so it reads a contiguous 8-column group still.
// What sets its pace now (PERF.md): neither bytes nor the tensor pipe, but
// the instructions that feed the mmas. Each fragment value takes a shared
// load and a five-instruction hi/lo split, and rq, A and k2 are split by
// four warps each; with the scan and the barriers between the phases, the
// SM issues far below one instruction a clock. Two CTAs a SM cap a thread
// at 128 registers: changes that keep more live (all of a quarter's rows
// loaded before the first store, the next r and logw staged during step 3,
// step 3 cut in two) spilled and ran slower. Splitting each operand once
// into shared memory, or wgmma, are the next steps.
// Padding: rows past c and columns past D are staged as zeros (r = k = v =
// logw = 0), so a padded row's logw (0) adds nothing to a real row's cumsum
// and the column total is the last real row's; padded entries of rq, kk,
// k2, A and S are 0. No atomics: each CTA owns its outputs, and every sum
// runs in a fixed order, so results are the same run to run.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 64;  // head dim
constexpr int kMaxC = 64;  // chunk length
constexpr int kLdA = 68;  // row stride of rq (staged r), kk (staged logw), A
constexpr int kLdB = 72;  // row stride of k2 (staged k), v, S
// The staged chunk: r, logw (kLdA), k, v (kLdB), 64 rows each.
constexpr int kStageFloats = kMaxC * (2 * kLdA + 2 * kLdB);
// Then S (D × D), A (c × c), the diag partials (8 warps × c), diag (c),
// p_end (D) and u (D): 108 KB, so two CTAs share a SM.
constexpr int kSmemFloats = kStageFloats + kMaxD * kLdB + kMaxC * kLdA +
                            kWarps * kMaxC + kMaxC + 2 * kMaxD;
constexpr int kSmemBytes = 4 * kSmemFloats;
constexpr unsigned kFull = 0xffffffffu;

// Staged column of (row, col) in r, logw and k: the 8-column group XOR the
// 16-row block.
__device__ __forceinline__ int swz(int row, int col) {
  return col ^ ((row >> 1) & 0x18);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// a rounded to TF32 (the low 13 mantissa bits zero) to nearest, ties away
// from zero: the value cvt.rna.tf32.f32 gives for a finite a, in two integer
// instructions (the conversion unit runs at a quarter of their rate).
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// a = hi + lo, both TF32; a - hi is exact.
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a·b in 3xTF32: the two small cross terms first, then hi·hi.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// Stage rows [0, cp) × columns [0, dp) of one chunk's r, k, v and logw;
// entries past c or D are zero-filled. off: the chunk's first element.
__device__ __forceinline__ void load_chunk(float* stage, const float* r,
                                           const float* k, const float* v,
                                           const float* logw, size_t off,
                                           int c, int D, int cp, int dp,
                                           bool vec) {
  float* R = stage;
  float* LW = R + kMaxC * kLdA;
  float* K = LW + kMaxC * kLdA;
  float* V = K + kMaxC * kLdB;
  if (vec) {  // D % 4 == 0 and 16-byte aligned operands
    const int q4 = dp / 4;
    for (int i = threadIdx.x; i < cp * q4; i += kThreads) {
      const int row = i / q4, col = 4 * (i % q4);
      const bool in = row < c && col < D;
      const size_t gi = in ? off + (size_t)row * D + col : off;
      const int sw = swz(row, col);
      cp_async16(R + row * kLdA + sw, r + gi, in);
      cp_async16(LW + row * kLdA + sw, logw + gi, in);
      cp_async16(K + row * kLdB + sw, k + gi, in);
      cp_async16(V + row * kLdB + col, v + gi, in);
    }
  } else {
    for (int i = threadIdx.x; i < cp * dp; i += kThreads) {
      const int row = i / dp, col = i % dp;
      const bool in = row < c && col < D;
      const size_t gi = in ? off + (size_t)row * D + col : off;
      const int sw = swz(row, col);
      cp_async4(R + row * kLdA + sw, r + gi, in);
      cp_async4(LW + row * kLdA + sw, logw + gi, in);
      cp_async4(K + row * kLdB + sw, k + gi, in);
      cp_async4(V + row * kLdB + col, v + gi, in);
    }
  }
}

// kStates: also write the state entering each chunk to states (B, H, S/c,
// D, D), for the backward; y and the final state are the same bits.
template <bool kStates>
__global__ void __launch_bounds__(kThreads, 2)
    rwkv6_scan_kernel(const float* __restrict__ r,  // (B, H, S, D)
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ logw,
                      const float* __restrict__ u,  // (H, D)
                      const float* __restrict__ state0,  // (B, H, D, D) or null
                      float* __restrict__ y,  // (B, H, S, D)
                      float* __restrict__ state_out,  // (B, H, D, D)
                      float* __restrict__ states,  // (B, H, S/c, D, D)
                      int H, int S, int D, int c, int vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* st = smem + kStageFloats;  // S, st[d·kLdB + e]
  float* ab = st + kMaxD * kLdB;  // A, ab[i·kLdA + j]
  float* diagp = ab + kMaxC * kLdA;  // Σ over a warp's 8 columns, per row
  float* diag = diagp + kWarps * kMaxC;
  float* pend = diag + kMaxC;
  float* us = pend + kMaxD;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row group, column pair
  const int bh = blockIdx.x, h = bh % H;
  const int cp = (c + 15) & ~15, dp = (D + 15) & ~15;  // padded to the tile
  const size_t seq_base = (size_t)bh * S * D;
  const size_t st_base = (size_t)bh * D * D;
  const int n_chunks = S / c;

  for (int i = tid; i < dp * dp; i += kThreads) {
    const int d = i / dp, e = i % dp;
    st[d * kLdB + e] = (state0 && d < D && e < D)
                           ? state0[st_base + (size_t)d * D + e]
                           : 0.f;
  }
  if (tid < kMaxD) us[tid] = tid < D ? u[(size_t)h * D + tid] : 0.f;

  // The scan pass: column sd = 8·warp + g, rows 16·sq .. 16·sq + 15.
  const int sd = warp * 8 + g, sq = t;
  const bool scan_on = sd < dp && 16 * sq < cp;
  // The products: y rows in the 16-row blocks {p, 3 - p} (A·v then costs
  // every warp the same), y and S' columns in n-tiles 2·ng and 2·ng + 1,
  // S' rows in the blocks 2p and 2p + 1; A tiles (rb, ng) and (rb, ng + 4)
  // for the warp's two row blocks, where they reach the diagonal.
  const int p = warp & 1, ng = warp >> 1;

  for (int n = 0; n < n_chunks; ++n) {
    __syncthreads();  // chunk n - 1 is done with the stage, S and A
    if (kStates) {  // S is written by step 3 only, two barriers on
      float* out = states + ((size_t)bh * n_chunks + n) * D * D;
      for (int i = tid; i < D * D; i += kThreads)
        out[i] = st[(i / D) * kLdB + i % D];
    }
    load_chunk(smem, r, k, v, logw, seq_base + (size_t)n * c * D, c, D, cp,
               dp, vec);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    float* R = smem;  // r, then rq
    float* LW = R + kMaxC * kLdA;  // logw, then kk
    float* K = LW + kMaxC * kLdA;  // k, then k2
    const float* V = K + kMaxC * kLdB;

    // 1. decay scan; rq, kk, k2 in place, p_end, the bonus partials
    {
      float lw[16], lp[16];
      float run = 0.f;
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const int i = 16 * sq + m;
        lw[m] = scan_on ? LW[i * kLdA + swz(i, sd)] : 0.f;
        run += lw[m];
        lp[m] = run;
      }
      const int q0 = lane & ~3;  // this column's quarter 0
      const float t0 = __shfl_sync(kFull, run, q0);
      const float t1 = __shfl_sync(kFull, run, q0 + 1);
      const float t2 = __shfl_sync(kFull, run, q0 + 2);
      const float t3 = __shfl_sync(kFull, run, q0 + 3);
      const float o2 = t0 + t1, o3 = o2 + t2;
      const float total = o3 + t3;  // the last real row's logp
      const float off = sq == 0 ? 0.f : sq == 1 ? t0 : sq == 2 ? o2 : o3;
      if (sq == 0) pend[sd] = expf(total);
      const float uu = us[sd];
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const int i = 16 * sq + m;
        float dg = 0.f;
        if (scan_on) {
          const float l = off + lp[m];
          const int ia = i * kLdA + swz(i, sd), ib = i * kLdB + swz(i, sd);
          const float rv = R[ia], kv = K[ib];
          R[ia] = rv * expf(l - lw[m]);
          LW[ia] = kv * expf(-l);
          K[ib] = kv * expf(total - l);
          dg = rv * uu * kv;
        }
        dg += __shfl_xor_sync(kFull, dg, 4);
        dg += __shfl_xor_sync(kFull, dg, 8);
        dg += __shfl_xor_sync(kFull, dg, 16);
        if (g == 0 && i < cp) diagp[warp * kMaxC + i] = dg;
      }
    }
    __syncthreads();

    // 2. A = tril_strict(rq·kkᵀ) into ab; y = rq·S₀ into registers
    float yacc[2][2][4], aacc[2][2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) yacc[a][j][x] = aacc[a][j][x] = 0.f;
    for (int k0 = 0; k0 < dp; k0 += 8) {
      uint32_t sh[2][2], sl[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = (2 * ng + j) * 8 + g;
        if (e < dp) {
          split(st[(k0 + t) * kLdB + e], sh[j][0], sl[j][0]);
          split(st[(k0 + t + 4) * kLdB + e], sh[j][1], sl[j][1]);
        }
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int rb = a == 0 ? p : 3 - p;
        if (16 * rb >= cp) continue;
        const int i0 = 16 * rb + g;
        const int kc = (k0 ^ (rb << 3)) + t;  // rows of block rb: XOR 8·rb
        uint32_t ah[4], al[4];
        split(R[i0 * kLdA + kc], ah[0], al[0]);
        split(R[(i0 + 8) * kLdA + kc], ah[1], al[1]);
        split(R[i0 * kLdA + kc + 4], ah[2], al[2]);
        split(R[(i0 + 8) * kLdA + kc + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if ((2 * ng + j) * 8 < dp) mma3(yacc[a][j], ah, al, sh[j], sl[j]);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int nt = ng + 4 * jj;
          if (nt >= 2 * (rb + 1)) continue;  // wholly above the diagonal
          const int jr = nt * 8 + g;  // kk's row: B[k][n] = kk[n][k]
          const int kc2 = (k0 ^ ((nt >> 1) << 3)) + t;
          uint32_t bh[2], bl[2];
          split(LW[jr * kLdA + kc2], bh[0], bl[0]);
          split(LW[jr * kLdA + kc2 + 4], bh[1], bl[1]);
          mma3(aacc[a][jj], ah, al, bh, bl);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int rb = a == 0 ? p : 3 - p;
      if (16 * rb >= cp) continue;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int nt = ng + 4 * jj;
        if (nt >= 2 * (rb + 1)) continue;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int i = 16 * rb + g + 8 * (x >> 1), j = nt * 8 + 2 * t + (x & 1);
          ab[i * kLdA + j] = j < i ? aacc[a][jj][x] : 0.f;
        }
      }
    }
    if (tid < cp) {
      float s = diagp[tid];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s += diagp[w * kMaxC + tid];
      diag[tid] = s;
    }
    __syncthreads();

    // 3. y += A·v, written out with the bonus term; S' = S₀·p_end + k2ᵀ·v
    float kacc[2][2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) kacc[a][j][x] = 0.f;
    for (int j0 = 0; j0 < cp; j0 += 8) {
      uint32_t vh[2][2], vl[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = (2 * ng + j) * 8 + g;
        if (e < dp) {
          split(V[(j0 + t) * kLdB + e], vh[j][0], vl[j][0]);
          split(V[(j0 + t + 4) * kLdB + e], vh[j][1], vl[j][1]);
        }
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int rb = a == 0 ? p : 3 - p;
        if (16 * rb >= cp || j0 >= 16 * (rb + 1)) continue;
        const int i0 = 16 * rb + g;
        uint32_t ah[4], al[4];
        split(ab[i0 * kLdA + j0 + t], ah[0], al[0]);
        split(ab[(i0 + 8) * kLdA + j0 + t], ah[1], al[1]);
        split(ab[i0 * kLdA + j0 + t + 4], ah[2], al[2]);
        split(ab[(i0 + 8) * kLdA + j0 + t + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if ((2 * ng + j) * 8 < dp) mma3(yacc[a][j], ah, al, vh[j], vl[j]);
      }
      const int x8 = ((j0 >> 4) & 3) << 3;  // the XOR of rows j0 .. j0 + 7
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int mb = 2 * p + mi;
        if (16 * mb >= dp) continue;
        // A[m][k] = k2[k][m]: rows j0 + t (+4), columns 16·mb + g (+8)
        const int c0 = ((16 * mb) ^ x8) + g, c1 = ((16 * mb + 8) ^ x8) + g;
        uint32_t ah[4], al[4];
        split(K[(j0 + t) * kLdB + c0], ah[0], al[0]);
        split(K[(j0 + t) * kLdB + c1], ah[1], al[1]);
        split(K[(j0 + t + 4) * kLdB + c0], ah[2], al[2]);
        split(K[(j0 + t + 4) * kLdB + c1], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if ((2 * ng + j) * 8 < dp) mma3(kacc[mi][j], ah, al, vh[j], vl[j]);
      }
    }
    const size_t out = seq_base + (size_t)n * c * D;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int rb = a == 0 ? p : 3 - p;
      if (16 * rb >= cp) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nt = 2 * ng + j;
        if (nt * 8 >= dp) continue;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int i = 16 * rb + g + 8 * (x >> 1), e = nt * 8 + 2 * t + (x & 1);
          if (i < c && e < D)
            y[out + (size_t)i * D + e] = yacc[a][j][x] + diag[i] * V[i * kLdB + e];
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int mb = 2 * p + mi;
      if (16 * mb >= dp) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nt = 2 * ng + j;
        if (nt * 8 >= dp) continue;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int d = 16 * mb + g + 8 * (x >> 1), e = nt * 8 + 2 * t + (x & 1);
          float& s = st[d * kLdB + e];  // read by step 2 only, before the barrier
          s = s * pend[d] + kacc[mi][j][x];
        }
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < D * D; i += kThreads) {
    const int d = i / D, e = i % D;
    state_out[st_base + i] = st[d * kLdB + e];
  }
}

// ---------------------------------------------------------------------------
// The backward of the chunked WKV6 above: rwkv6_scan_bwd_ds_kernel, then
// rwkv6_scan_bwd_chunk_kernel, both launched by rwkv6_scan_bwd_launch.
//
// Replaces no Pallas kernel: the JAX package has no backward for
// rwkv6_pallas and trains rwkv6 by differentiating its jnp chunk,
// repro/models/layers.py::_wkv_chunk, so these kernels take the place of the
// VJP that JAX derives from it. Together they compute kernels/rwkv6_scan/
// ref.py::rwkv6_bwd_ref; their plain pieces are rwkv6_bwd_ds_ref (the dS
// pass), rwkv6_bwd_chunks_ref (the chunk pass) and rwkv6_bwd_du_ref.
//
// Only dS, the cotangent of the state leaving a chunk, passes from chunk to
// chunk: dS₀ = rqᵀ·dy + diag(p_end)·dS. Given the dS leaving a chunk and
// the state S₀ entering it (saved by the forward's rwkv6_scan_kernel<true>),
// a chunk's dr, dk, dv and dlogw need nothing from another chunk. So the
// recurrence is split from the chunk work:
//   - the dS pass, one CTA of 16 warps per (b, h), walks the chunks in
//     reverse doing only what the recurrence needs (the decay scan for rq
//     and p_end, rounded as the forward rounds logp, and rqᵀ·dy), writes the
//     dS leaving each chunk to a (B, H, S/c, D, D) scratch that the wrapper
//     allocates, dstate0, du's sum over each batch row's steps, and each
//     step's row sums Σ_e dy·v and Σ_d r·u·k (its warps have the rows
//     staged anyway; the chunk pass then needs no row pass);
//   - the chunk pass, one CTA per (b, h, chunk) (1,024 at the training
//     shape), two a SM, does the other eight products and the epilogues and
//     sums du's batch rows in order.
// Two launches rather than one with a look-back over published dS: no CTA
// ever waits on another, whatever order the card schedules them in. No
// atomics; every sum runs in a fixed order, so two calls give the same
// bits.
//
// What bounds it on an H100, at the training path's B=2, H=64, S=512, D=64,
// c=64: the function's bytes (r, k, v, logw, dy and the saved states in;
// dr, dk, dv, dlogw, dstate0 out; ~172 MB: 0.051 ms at 3.35 TB/s) and its
// float32 operations (3.47 GFLOP, the five triangular products counted as
// triangles: 0.052 ms at 67 TFLOP/s). The split adds the scratch and the
// dS pass's reread of five inputs: ~0.085 ms of bytes over the two
// launches. The design:
//   - Tensor cores at float32 accuracy: mma.sync.m16n8k8 in 3xTF32, a =
//     hi + lo split by truncation (split_t), ~1e-6 of each product's size.
//     wgmma would need K-major, swizzled hi and lo copies of every operand.
//   - Intermediates in registers: an accumulator tile is the next mma's A
//     operand (frag_c_as_a), so Aᵀ = triu(kk·rqᵀ) and dAᵀ = triu(v·dyᵀ)
//     never reach memory; dA for drq is stored once, packed (dap), by the
//     warps that made dAᵀ. dS' = diag(p_end)·dS turns k2·dS into kk·dS'
//     and dk2·k2 into (v·dS'ᵀ)·kk, so k2 is never formed.
//   - Staging: cp.async, 16 B a thread, into unpadded 64 × 64 tiles whose
//     columns are XOR-swizzled by row (rsw): every fragment read, column
//     scan and row pass touches 32 banks. At c < 64 only the 16-row blocks
//     that hold rows are staged and multiplied.
//   - Code kept small: the k-loops stay loops and the chained products
//     walk their tiles by rotating register arrays; fully unrolled, the
//     chunk kernel was more than twice its size and instruction fetch set
//     its pace. With full tiles (c and D above 48) the products need no
//     range checks, so a k-step is one block of independent loads and
//     HMMAs; there the triangles' tiles left of the diagonal are computed
//     and zeroed rather than branched around, which measured faster.
// Measured (PERF.md, NVIDIA H100 80GB HBM3 at 700 W): 0.21 ms for both
// passes at the training shape (dS pass 0.046, chunk pass 0.164) against
// 0.460 for the single-launch CUDA-core kernel it replaces, 4.1× the bound.
// What sets the pace now: latency, not a pipe. Two chunk CTAs of 8 warps
// (128 registers, 110 KB each) are all a SM holds, and a warp's 3xTF32
// step (load, split, three dependent HMMAs) and the scans' chains stall
// more than 16 warps hide: the chunk pass's 5,280 HMMAs a CTA come to
// ~67 TFLOP/s of TF32, under a seventh of the card's 495. The dS pass is a
// serial walk of 8 chunks a sequence, ~5.8 µs each.
// Padding: rows past c and columns past D are staged as zeros, so a padded
// row's logw (0) adds nothing to the cumsum and every padded entry of rq,
// kk, A, dA and G is 0.

constexpr int kT = 64;  // rows and columns of a staged tile
constexpr int kTileF = kT * kT;  // 16 KB: rows unpadded, columns XOR-swizzled
// The dS pass: 16 warps, two stages of a chunk's r, logw, dy, k and v, the
// tile of rq, p_end, ddiag and u; one CTA a SM.
constexpr int kDsThreads = 512;
constexpr int kDsTiles = 5;
constexpr int kDsSmemBytes = 4 * ((2 * kDsTiles + 1) * kTileF + 3 * kT);
// The chunk pass: six tiles; u, diag, ddiag, xs, the column sums of the 4
// row blocks (4 × 64) and dA's 10 lower 16 × 16 blocks; two CTAs a SM.
constexpr int kChunkTiles = 6;
constexpr int kChunkSmemBytes =
    4 * (kChunkTiles * kTileF + 4 * kT + 4 * kT + 10 * 256);

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 4·f(r) for a row r mod 8 = 4q + 2p + s: f = 4(p^q) + 2(s^q) + q.
__device__ __forceinline__ int fmask(int r) {
  const int q = (r >> 2) & 1, p = (r >> 1) & 1, s = r & 1;
  return 4 * (4 * (p ^ q) + 2 * (s ^ q) + q);
}
// The XOR mask of row r's columns, a multiple of 4 below 32: 4·f(r mod 8)
// XOR 8·(r/16 mod 4). f gives the 8 rows of an aligned 8 distinct groups
// of 4 banks, and the 4 rows of an aligned quad, or the even or the odd
// rows of an aligned 8, distinct pairs of groups; the XOR with the 16-row
// block separates the scan's four quarters. So the fragment reads of every
// operand layout below (8 rows × 4 columns, 4 rows × 8 columns, rows 2t
// and 2t + 1 × 8 columns), the column scans and the row passes (a warp on
// 32 columns of a row, or on 8 rows × 4 columns) touch 32 banks; a 4-column
// group stays contiguous, so cp.async copies 16 bytes at a time.
__device__ __forceinline__ int rsw(int r) {
  return fmask(r & 7) ^ (8 * ((r >> 4) & 3));
}
__device__ __forceinline__ int at(int r, int c) {
  return r * kT + (c ^ rsw(r));
}

// dA's strictly lower part in its 16 × 16 blocks (ib, jb), jb <= ib, packed
// at (ib(ib + 1)/2 + jb)·256, row r's 16 columns XOR 4·f'(r mod 8) with
// f'(r) = 2·((r >> 1) & 1) + ((r >> 2) & 1): the A-operand reads (8 rows ×
// 4 columns) touch 32 banks, the transposed writes two a bank.
__device__ __forceinline__ int fpk(int r) {
  return 4 * (2 * ((r >> 1) & 1) + ((r >> 2) & 1));
}
__device__ __forceinline__ int dap(int i, int j) {
  const int ib = i >> 4, jb = j >> 4, r = i & 15;
  return (ib * (ib + 1) / 2 + jb) * 256 + r * 16 + ((j & 15) ^ fpk(r));
}

// Stage rows [0, rp) × columns [0, dp) of the N row-major (·, D) blocks at
// src[j] + off into the tiles T + j·kTileF, NT threads; entries at row >=
// nrow or column >= D are zero.
template <int NT, int N>
__device__ __forceinline__ void stage(float* T, const float* const (&src)[N],
                                      size_t off, int nrow, int D, int rp,
                                      int dp, bool vec) {
  if (vec) {  // D % 4 == 0 and 16-byte aligned operands
    for (int i = threadIdx.x; i < rp * 16; i += NT) {
      const int row = i >> 4, col = 4 * (i & 15);
      if (col >= dp) continue;
      const bool in = row < nrow && col < D;
      const size_t gi = in ? off + (size_t)row * D + col : off;
      float* dst = T + at(row, col);
#pragma unroll
      for (int j = 0; j < N; ++j) cp_async16(dst + j * kTileF, src[j] + gi, in);
    }
  } else {
    for (int i = threadIdx.x; i < rp * kT; i += NT) {
      const int row = i >> 6, col = i & 63;
      if (col >= dp) continue;
      const bool in = row < nrow && col < D;
      const size_t gi = in ? off + (size_t)row * D + col : off;
      float* dst = T + at(row, col);
#pragma unroll
      for (int j = 0; j < N; ++j) cp_async4(dst + j * kTileF, src[j] + gi, in);
    }
  }
}

// a = hi + lo for the 3xTF32 products, by truncation: hi is a with its low
// 13 bits cleared, lo = a − hi exactly, and the mma reads lo's top 19
// bits. Two instructions a value (rna rounding of both took five); the
// dropped lo·lo term and lo's truncation each stay below 2^-20 of a
// product.
__device__ __forceinline__ void split_t(float a, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(a) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

// A lane's constants for the fragment reads of mma.m16n8k8 (g = lane / 4,
// t = lane % 4; A (16 × 8): (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4);
// B (8 × 8): (t, g), (t + 4, g)): the swizzles of rows ≡ g, t, t + 4, 2t
// and 2t + 1 (mod 8) in the first 16-row block, XORed with g where the
// lane's column is g. All tile offsets below are multiples of 8, so a
// column c0 + t is (c0 ^ mask) + t and c0 + g is c0 ^ (g ^ mask).
struct Lane {
  int g, t, fg, gt0, gt1, gp0, gp1, c0, c1;
};
__device__ __forceinline__ Lane lane_consts(int lane) {
  Lane L;
  L.g = lane / 4;
  L.t = lane % 4;
  L.fg = fmask(L.g);
  L.gt0 = L.g ^ fmask(L.t);
  L.gt1 = L.g ^ fmask(L.t + 4);
  L.gp0 = L.g ^ fmask(2 * L.t);
  L.gp1 = L.g ^ fmask(2 * L.t + 1);
  L.c0 = (2 * L.t) ^ L.fg;  // accumulator columns 2t and 2t + 1
  L.c1 = (2 * L.t + 1) ^ L.fg;
  return L;
}
__device__ __forceinline__ int blk8(int r0) { return 8 * ((r0 >> 4) & 3); }

// A read transposed, A[m][k] = X[k][m]: rows k0 + t (+4), columns m0 + g
// (+8); k0 % 8 == 0.
__device__ __forceinline__ void frag_at(const float* X, int m0, int k0,
                                        const Lane& L, uint32_t (&h)[4],
                                        uint32_t (&l)[4]) {
  const int b = blk8(k0);
  const float* p0 = X + (k0 + L.t) * kT;
  const float* p1 = p0 + 4 * kT;
  split_t(p0[(m0 ^ b) ^ L.gt0], h[0], l[0]);
  split_t(p0[((m0 + 8) ^ b) ^ L.gt0], h[1], l[1]);
  split_t(p1[(m0 ^ b) ^ L.gt1], h[2], l[2]);
  split_t(p1[((m0 + 8) ^ b) ^ L.gt1], h[3], l[3]);
}
// B from X[k][n]: rows k0 + t (+4), column n0 + g.
__device__ __forceinline__ void frag_b_kn(const float* X, int k0, int n0,
                                          const Lane& L, uint32_t (&h)[2],
                                          uint32_t (&l)[2]) {
  const int b = blk8(k0);
  const float* p0 = X + (k0 + L.t) * kT;
  split_t(p0[(n0 ^ b) ^ L.gt0], h[0], l[0]);
  split_t(p0[4 * kT + ((n0 ^ b) ^ L.gt1)], h[1], l[1]);
}
// An accumulator tile as the A operand over its own 8 columns: an
// accumulator holds (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1), so
// k = t stands for column 2t and k = t + 4 for column 2t + 1, and B takes
// rows k0 + 2t and k0 + 2t + 1 of X[k][n].
__device__ __forceinline__ void frag_c_as_a(const float (&c)[4],
                                            uint32_t (&h)[4],
                                            uint32_t (&l)[4]) {
  split_t(c[0], h[0], l[0]);
  split_t(c[2], h[1], l[1]);
  split_t(c[1], h[2], l[2]);
  split_t(c[3], h[3], l[3]);
}
// The tile offset of accumulator entry x of the tile at rows m0 (+g, +8),
// columns n0 (+2t, +1).
__device__ __forceinline__ int cpos(int m0, int n0, int x, const Lane& L) {
  return (m0 + L.g + 8 * (x >> 1)) * kT +
         (n0 ^ blk8(m0) ^ ((x & 1) ? L.c1 : L.c0));
}

// Zero the accumulator tiles of a 16-row block (rows m0 + g (+8), columns
// n0 + 8·lt + 2t (+1)) where the column is not above the row.
__device__ __forceinline__ void strict_upper(float (&a)[8][4], int m0, int n0,
                                             const Lane& L) {
#pragma unroll
  for (int lt = 0; lt < 8; ++lt)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int row = m0 + L.g + 8 * (x >> 1);
      const int col = n0 + 8 * lt + 2 * L.t + (x & 1);
      if (col <= row) a[lt][x] = 0.f;
    }
}

template <int M, int N>
__device__ __forceinline__ void zero(float (&a)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) a[i][j] = 0.f;
}

// The decay scan of one staged chunk as rwkv6_scan_kernel rounds it:
// column sd, rows 16·sq .. 16·sq + 15 in order, then the quarters' totals
// (lanes 4g .. 4g + 3) in order. Leaves logw and logp of the 16 rows in lw
// and l; returns the column's total, the last real row's logp.
__device__ __forceinline__ float decay_scan(const float* LW, int sd, int sq,
                                            bool on, int lane,
                                            float (&lw)[16], float (&l)[16]) {
  float run = 0.f;
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    lw[m] = on ? LW[at(16 * sq + m, sd)] : 0.f;
    run += lw[m];
    l[m] = run;
  }
  const int q0 = lane & ~3;
  const float t0 = __shfl_sync(kFull, run, q0);
  const float t1 = __shfl_sync(kFull, run, q0 + 1);
  const float t2 = __shfl_sync(kFull, run, q0 + 2);
  const float t3 = __shfl_sync(kFull, run, q0 + 3);
  const float o2 = t0 + t1, o3 = o2 + t2;
  const float off = sq == 0 ? 0.f : sq == 1 ? t0 : sq == 2 ? o2 : o3;
#pragma unroll
  for (int m = 0; m < 16; ++m) l[m] = off + l[m];
  return o3 + t3;
}

// Σ_e X[row][e]·Y[row][e] over e < dp, four threads a row (lanes 4ρ ..
// 4ρ + 3), thread qq taking columns qq, qq + 4, ... in order, then the four
// partials in a fixed butterfly; every lane of the four gets the sum.
__device__ __forceinline__ float row_dot(const float* X, const float* Y,
                                         int row, int qq, int dp) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 4 * j + qq;
    if (4 * j < dp) {
      const int a = at(row, col);
      s += X[a] * Y[a];
    }
  }
  s += __shfl_xor_sync(kFull, s, 1);
  s += __shfl_xor_sync(kFull, s, 2);
  return s;
}

// The dS pass. One CTA of 16 warps per (b, h) walks the chunks in reverse
// with dS, the cotangent of the state leaving the chunk, in registers
// (warp w: rows 16·(w % 4), columns 16·(w / 4)), writes it to ds before
// each chunk and updates dS ← diag(p_end)·dS + rqᵀ·dy; the next chunk's r,
// logw, dy, k and v arrive by cp.async during this one. Per chunk, warps
// 0-7 run the decay scan (rq into a tile of its own, p_end) and then form
// the row sums diag = Σ_d r·u·k, while warps 8-15 form ddiag = Σ_e dy·v
// (both written to rows, for the chunk pass) and add ddiag·r·k into du's
// partial of the row (a column and 16 rows a thread; the four 16-row sums
// added in order at the end) for du_part.
template <bool kFull>
__global__ void __launch_bounds__(kDsThreads, 1)
    rwkv6_scan_bwd_ds_kernel(const float* __restrict__ r,  // (B, H, S, D)
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ logw,
                             const float* __restrict__ dy,
                             const float* __restrict__ u,  // (H, D)
                             const float* __restrict__ d_state,  // or null
                             float* __restrict__ ds,  // (B, H, S/c, D, D)
                             float* __restrict__ dstate0,  // or null
                             float* __restrict__ du_part,  // (B, H, D)
                             float* __restrict__ rows,  // (B, H, S, 2)
                             int H, int S, int D, int c, int vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* RQ = smem + 2 * kDsTiles * kTileF;
  float* pend = RQ + kTileF;
  float* dd = pend + kT;
  float* us = dd + kT;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Lane L = lane_consts(lane);
  const int bh = blockIdx.x;
  const int cp = (c + 15) & ~15, dp = (D + 15) & ~15;
  const int n_chunks = S / c;
  const size_t seq_base = (size_t)bh * S * D;
  const size_t seq_row = (size_t)bh * S;  // the sequence's first step
  const size_t st_base = (size_t)bh * D * D;
  const int m0 = 16 * (warp & 3), n0 = 16 * (warp >> 2);  // this warp's dS
  const bool m_on = m0 < dp;
  const bool pair = D % 2 == 0;  // dS rows and columns stored two at a time

  float acc[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int d = m0 + L.g + 8 * (x >> 1), e = n0 + 8 * j + 2 * L.t + (x & 1);
      acc[j][x] = (d_state && d < D && e < D)
                      ? d_state[st_base + (size_t)d * D + e] : 0.f;
    }
  const float* const src[kDsTiles] = {r, logw, dy, k, v};
  const auto stage_chunk = [&](int s, int n) {
    stage<kDsThreads, kDsTiles>(smem + s * kDsTiles * kTileF, src,
                                seq_base + (size_t)n * c * D, c, D, cp, dp,
                                vec);
    cp_async_commit();
  };
  const auto store = [&](float* out) {  // acc → out (D × D)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int x = 0; x < 4; x += 2) {
        const int d = m0 + L.g + 8 * (x >> 1), e = n0 + 8 * j + 2 * L.t;
        if (d >= D || e >= D) continue;
        float* o = out + (size_t)d * D + e;
        if (pair) {
          *reinterpret_cast<float2*>(o) = make_float2(acc[j][x], acc[j][x + 1]);
        } else {
          o[0] = acc[j][x];
          if (e + 1 < D) o[1] = acc[j][x + 1];
        }
      }
  };
  stage_chunk(0, n_chunks - 1);
  float du_acc = 0.f;
  const int ut = tid - 256;  // warps 8-15: ddiag and du
  if (tid < kT) us[tid] = tid < D ? u[(size_t)(bh % H) * D + tid] : 0.f;

  for (int it = 0; it < n_chunks; ++it) {
    const int n = n_chunks - 1 - it, s = it & 1;
    if (it + 1 < n_chunks) stage_chunk(s ^ 1, n - 1);
    store(ds + ((size_t)bh * n_chunks + n) * D * D);  // dS leaving chunk n
    if (it + 1 < n_chunks) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();
    const float* R = smem + s * kDsTiles * kTileF;
    const float* LW = R + kTileF;
    const float* DY = LW + kTileF;
    const float* K = DY + kTileF;
    const float* V = K + kTileF;

    if (warp < 8) {  // the decay scan: rq, p_end
      const int sd = warp * 8 + L.g, sq = L.t;
      const bool on = sd < dp && 16 * sq < cp;
      float lw[16], l[16];
      const float total = decay_scan(LW, sd, sq, on, lane, lw, l);
      if (sq == 0) pend[sd] = expf(total);
#pragma unroll
      for (int m = 0; m < 16; ++m)
        if (on) {
          const int a = at(16 * sq + m, sd);
          RQ[a] = R[a] * expf(l[m] - lw[m]);
        }
      const int row = tid >> 2, qq = tid & 3;  // diag, four threads a row
      const int x = rsw(row);
      float b_ = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (4 * j < dp) {
          const int a = row * kT + ((4 * j + qq) ^ x);
          b_ += R[a] * us[4 * j + qq] * K[a];
        }
      b_ += __shfl_xor_sync(kFull, b_, 1);
      b_ += __shfl_xor_sync(kFull, b_, 2);
      if (qq == 0 && row < c)
        rows[2 * (seq_row + (size_t)n * c + row) + 1] = b_;
    } else {  // ddiag = Σ_e dy·v, then du's partial Σ ddiag·r·k
      const int row = ut >> 2, qq = ut & 3;
      const float s_ = row_dot(DY, V, row, qq, dp);
      if (qq == 0 && row < cp) dd[row] = s_;
      if (qq == 0 && row < c) rows[2 * (seq_row + (size_t)n * c + row)] = s_;
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      const int col = ut & 63, seg = ut >> 6;
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const int i = 16 * seg + m;
        if (i < cp && col < dp) {
          const int a = at(i, col);
          du_acc += dd[i] * R[a] * K[a];
        }
      }
    }
    __syncthreads();

    // dS ← diag(p_end)·dS + rqᵀ·dy
    if (m_on) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float p = pend[m0 + L.g + 8 * (x >> 1)];
        acc[0][x] *= p;
        acc[1][x] *= p;
      }
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        if (!kFull && 8 * ks >= cp) break;
        uint32_t ah[4], al[4];
        frag_at(RQ, m0, 8 * ks, L, ah, al);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (!kFull && n0 + 8 * j >= dp) continue;
          uint32_t bh_[2], bl_[2];
          frag_b_kn(DY, 8 * ks, n0 + 8 * j, L, bh_, bl_);
          mma3(acc[j], ah, al, bh_, bl_);
        }
      }
    }
    __syncthreads();  // the next prefetch reuses this stage, and RQ
  }

  if (dstate0) store(dstate0 + st_base);
  if (warp >= 8) RQ[ut] = du_acc;  // (seg, col), seg = ut / 64
  __syncthreads();
  if (tid < D)
    du_part[(size_t)bh * D + tid] =
        ((RQ[tid] + RQ[64 + tid]) + RQ[128 + tid]) + RQ[192 + tid];
}

// The chunk pass. One CTA per (b, h, chunk), two a SM. It takes S₀ from
// states and the dS leaving the chunk from ds, and with dS' = diag(p_end)·dS
// (so k2·dS = kk·dS' and dk2·e^{logp_c−logp} = (v·dS'ᵀ)·e^{−logp}):
//   group A (warps 0-3, a 16-row block each): dv = Aᵀ·dy + kk·dS' + diag·dy,
//     Aᵀ = triu_strict(kk·rqᵀ) kept in registers as the next A operand;
//   group B (warps 4-7): dkk' = dAᵀ·rq + v·dS'ᵀ, dAᵀ = triu_strict(v·dyᵀ)
//     in registers; dk = dkk'·e^{−logp} + ddiag·u·r; dlogw ← −dkk'·kk;
//     the column sums Σ_j (v·dS'ᵀ)·kk;
//   all warps (a row block and half the columns each): drq = dA·kk + dy·S₀ᵀ,
//     dA = tril_strict(dy·vᵀ) in registers, S₀ staged in dS's tile;
//     dr = drq·e^{logp−logw} + ddiag·u·k; G = drq·rq − dkk'·kk into the
//     tile of rq;
// then dlogw = (G's exclusive reverse cumsum) − dkk'·kk, plus at the last
// row Σ_j dk2·k2 + dp_end·p_end. The k-loops stay loops and the chained
// products walk their 16 × 8 tiles by rotating the register arrays, so a
// warp's code stays small: unrolled, this kernel was 19,192 instructions,
// and instruction fetch, not the tensor pipe, set its pace.

// Group A (kA) or B of step 4: the row block at m0, all columns. kFull:
// cp = dp = 64, so no tile is out of range, and the triangle's tiles left
// of the diagonal are computed too (then zeroed): a k-step's products form
// one block of independent HMMAs and loads that the compiler can
// interleave, where a branch around each tile left every HMMA waiting on
// its own load and on the HMMA before it. (Four copies of the k-loop, one
// for each row block's tile count, spilled and ran slower.)
template <bool kA, bool kFull>
__device__ __forceinline__ void group_pass(
    const float* T0, const float* T1, float* T2, const float* T3,
    const float* T4, const float* T5, const float* ddiag, const float* diag,
    const float* us, float* cs, float* dAp, float* KP,
    const float* __restrict__ r,
    const float* __restrict__ logw, float* __restrict__ dv,
    float* __restrict__ dk, float* __restrict__ dlogw, size_t off, int m0,
    int rb, int c, int D, int cp, int dp, const Lane& L) {
  const float* XA = kA ? T1 : T3;  // the A operand: kk or v, rows j
  const float* XB = kA ? T0 : T4;  // the triangle's B: rq or dy, rows i
  const float* XC = kA ? T4 : T0;  // the chained B: dy or rq, rows i
  const int nt_lo = 2 * rb, nt_hi = cp / 8, ne_hi = dp / 8;
  float it_[8][4], acc[8][4];
  zero(it_);
  zero(acc);
  // The triangle's tiles nt = t0 + lt, lt < na, in it_[lt], two at a time
  // (the tile pair of 16-row block t0/2 + p). The tiles left of the
  // diagonal block (nt < nt_lo) are zero: with full tiles (t0 = 0) they are
  // computed anyway, branch-free, and zeroed; otherwise skipped.
  const int t0 = kFull ? 0 : nt_lo, na = nt_hi - t0;
  const float* pA = XA + (m0 + L.g) * kT + L.t;
  const int sA = L.fg ^ blk8(m0);
  const float* pB = XB + (8 * t0 + L.g) * kT + L.t;  // rows 8nt + g
  const float* pS = kA ? T5 + L.t * kT : T5 + L.g * kT + L.t;
  int mt[4];  // the swizzle of rows ≡ g in 16-row block t0/2 + p
#pragma unroll
  for (int p = 0; p < 4; ++p) mt[p] = L.fg ^ (8 * (((t0 >> 1) + p) & 3));
#pragma unroll 1
  for (int k0 = 0; k0 < dp; k0 += 8) {
    uint32_t ah[4], al[4];
    {
      const int c0 = k0 ^ sA, c1 = (k0 + 4) ^ sA;
      split_t(pA[c0], ah[0], al[0]);
      split_t(pA[8 * kT + c0], ah[1], al[1]);
      split_t(pA[c1], ah[2], al[2]);
      split_t(pA[8 * kT + c1], ah[3], al[3]);
    }
    int cb[4], cb4[4];  // columns k0 + t (+4) of rows ≡ g in 16-row block b
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      cb[b] = k0 ^ (L.fg ^ (8 * b));
      cb4[b] = (k0 + 4) ^ (L.fg ^ (8 * b));
    }
#pragma unroll
    for (int pr = 0; pr < 4; ++pr) {
      if (!kFull && pr > 0 && 2 * pr >= na) continue;
      const int c0 = k0 ^ mt[pr], c1 = (k0 + 4) ^ mt[pr];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lt = 2 * pr + h;
        const float* p = pB + 8 * lt * kT;
        uint32_t bh_[2], bl_[2];
        split_t(p[c0], bh_[0], bl_[0]);
        split_t(p[c1], bh_[1], bl_[1]);
        mma3(it_[lt], ah, al, bh_, bl_);
      }
    }
    const int y0 = blk8(k0) ^ L.gt0, y1 = blk8(k0) ^ L.gt1;
    const float* pk = pS + k0 * kT;  // group A: rows k0 + t (+4) of dS'
#pragma unroll
    for (int ne = 0; ne < 8; ++ne) {
      if (!kFull && ne >= ne_hi) continue;
      uint32_t bh_[2], bl_[2];
      if (kA) {  // B[d][e] = dS'[d][e]: rows k0 + t (+4), column 8ne + g
        split_t(pk[(8 * ne) ^ y0], bh_[0], bl_[0]);
        split_t(pk[4 * kT + ((8 * ne) ^ y1)], bh_[1], bl_[1]);
      } else {  // B[e][d] = dS'[d][e]: row 8ne + g, columns k0 + t (+4)
        const float* p = pS + 8 * ne * kT;
        split_t(p[cb[ne >> 1]], bh_[0], bl_[0]);
        split_t(p[cb4[ne >> 1]], bh_[1], bl_[1]);
      }
      mma3(acc[ne], ah, al, bh_, bl_);
    }
  }
  // With full tiles group B keeps −dkk'·kk in v's tile once its four warps
  // are past their last read of v (group A never reads it); otherwise in
  // dlogw, where step 5 reads it back.
  if (kFull && !kA) asm volatile("bar.sync 2, 128;\n" ::: "memory");
  if (!kA) {  // Σ_j (v·dS'ᵀ)·kk over the block's rows, a column each
#pragma unroll
    for (int nd = 0; nd < 8; ++nd) {
      if (nd >= ne_hi) continue;
      float s0 = acc[nd][0] * T1[cpos(m0, 8 * nd, 0, L)] +
                 acc[nd][2] * T1[cpos(m0, 8 * nd, 2, L)];
      float s1 = acc[nd][1] * T1[cpos(m0, 8 * nd, 1, L)] +
                 acc[nd][3] * T1[cpos(m0, 8 * nd, 3, L)];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(kFull, s0, o);
        s1 += __shfl_xor_sync(kFull, s1, o);
      }
      if (L.g == 0) {
        cs[rb * kT + 8 * nd + 2 * L.t] = s0;
        cs[rb * kT + 8 * nd + 2 * L.t + 1] = s1;
      }
    }
  }
  strict_upper(it_, m0, 8 * t0, L);  // Aᵀ or dAᵀ: column i > row j
  if (!kA) {  // dA = (dAᵀ)ᵀ into its packed blocks, for step 5
#pragma unroll
    for (int lt = 0; lt < 8; ++lt) {
      if (lt >= na || t0 + lt < nt_lo) continue;
#pragma unroll
      for (int x = 0; x < 4; ++x)
        dAp[dap(8 * (t0 + lt) + 2 * L.t + (x & 1),
                m0 + L.g + 8 * (x >> 1))] = it_[lt][x];
    }
  }
  // acc += it_·XC over the triangle's tiles; it_[0] holds tile t0 + lt
#pragma unroll 1
  for (int lt = 0; lt < na; ++lt) {
    const int nt = t0 + lt;
    if (nt >= nt_lo) {
      uint32_t ah[4], al[4];
      frag_c_as_a(it_[0], ah, al);
      const float* p0 = XC + (8 * nt + 2 * L.t) * kT;  // rows 8nt + 2t, +1
      const int b = blk8(8 * nt), z0 = b ^ L.gp0, z1 = b ^ L.gp1;
#pragma unroll
      for (int ne = 0; ne < 8; ++ne) {
        if (!kFull && ne >= ne_hi) continue;
        uint32_t bh_[2], bl_[2];
        split_t(p0[(8 * ne) ^ z0], bh_[0], bl_[0]);
        split_t(p0[kT + ((8 * ne) ^ z1)], bh_[1], bl_[1]);
        mma3(acc[ne], ah, al, bh_, bl_);
      }
    }
#pragma unroll
    for (int j = 0; j < 7; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) it_[j][x] = it_[j + 1][x];
  }
  // the epilogue, a column tile at a time; acc[0] holds tile ne
  const int jr = m0 + L.g;
  float rn[4] = {0.f, 0.f, 0.f, 0.f}, ln[4] = {0.f, 0.f, 0.f, 0.f};
  // group B: r and logw of the next column tile, from global
  const auto fetch = [&](int ne) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int j = jr + 8 * (x >> 1), e = 8 * ne + 2 * L.t + (x & 1);
      const bool in = j < c && e < D;
      const size_t gi = off + (size_t)j * D + e;
      rn[x] = in ? __ldg(r + gi) : 0.f;
      ln[x] = in ? __ldg(logw + gi) : 0.f;
    }
  };
  if (!kA) fetch(0);
#pragma unroll 1
  for (int ne = 0; ne < ne_hi; ++ne) {
    float rv[4], lwv[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      rv[x] = rn[x];
      lwv[x] = ln[x];
    }
    if (!kA && ne + 1 < ne_hi) fetch(ne + 1);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int j = jr + 8 * (x >> 1), e = 8 * ne + 2 * L.t + (x & 1);
      if (j >= c || e >= D) continue;
      const size_t gi = off + (size_t)j * D + e;
      const int a = cpos(m0, 8 * ne, x, L);
      const float y = acc[0][x];
      if (kA) {
        dv[gi] = y + diag[j] * T4[a];
      } else {
        const float l = T2[a];
        dk[gi] = y * expf(-l) + ddiag[j] * us[e] * rv[x];
        if (kFull) KP[a] = -(y * T1[a]);
        else dlogw[gi] = -(y * T1[a]);
        T2[a] = expf(l - lwv[x]);
      }
    }
#pragma unroll
    for (int j = 0; j < 7; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[j][x] = acc[j + 1][x];
  }
}

template <bool kFull>
__global__ void __launch_bounds__(kThreads, 2)
    rwkv6_scan_bwd_chunk_kernel(const float* __restrict__ r,  // (B, H, S, D)
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const float* __restrict__ logw,
                                const float* __restrict__ u,  // (H, D)
                                // (B, H, n, D, D): the state entering each
                                // chunk, the cotangent of the one leaving it
                                const float* __restrict__ states,
                                const float* __restrict__ ds,
                                const float* __restrict__ dy,
                                const float* __restrict__ du_part,  // (B, H, D)
                                const float* __restrict__ rows,  // (B, H, S, 2)
                                float* __restrict__ dr, float* __restrict__ dk,
                                float* __restrict__ dv,
                                float* __restrict__ dlogw,
                                float* __restrict__ du,  // (H, D)
                                int B, int H, int S, int D, int c, int vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* T0 = smem;  // r, then rq, then G
  float* T1 = T0 + kTileF;  // k, then kk
  float* T2 = T1 + kTileF;  // logw, then logp, then e^{logp − logw}
  float* T3 = T2 + kTileF;  // v, then −dkk'·kk (full tiles)
  float* T4 = T3 + kTileF;  // dy
  float* T5 = T4 + kTileF;  // dS, then dS' = diag(p_end)·dS, then S₀
  float* us = T5 + kTileF;
  float* diag = us + kT;
  float* ddiag = diag + kT;
  float* xs = ddiag + kT;  // Σ_e S₀·dS' = dp_end·p_end
  float* cs = xs + kT;  // (4 row blocks, 64): Σ_j dk2·k2
  float* dAp = cs + 4 * kT;  // dA, packed (dap)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Lane L = lane_consts(lane);
  const int n_chunks = S / c;
  const int bh = blockIdx.x / n_chunks, n = blockIdx.x % n_chunks;
  const int h = bh % H;
  const int cp = (c + 15) & ~15, dp = (D + 15) & ~15;
  const int nt_hi = cp / 8, ne_hi = dp / 8;
  const size_t off = (size_t)bh * S * D + (size_t)n * c * D;
  const size_t soff = ((size_t)bh * n_chunks + n) * D * D;
  const float* S0 = states + soff;

  {
    const float* const src[5] = {r, k, logw, v, dy};
    stage<kThreads, 5>(T0, src, off, c, D, cp, dp, vec);
    const float* const sds[1] = {ds};
    stage<kThreads, 1>(T5, sds, soff, D, D, dp, dp, vec);
    cp_async_commit();
  }
  if (tid < kT) us[tid] = tid < D ? u[(size_t)h * D + tid] : 0.f;
  if (tid < kT) {  // the chunk's row sums, from the dS pass
    const float2 rs =
        tid < c ? *reinterpret_cast<const float2*>(
                      rows + 2 * ((size_t)bh * S + (size_t)n * c + tid))
                : make_float2(0.f, 0.f);
    ddiag[tid] = rs.x;
    diag[tid] = rs.y;
  }
  if (n == 0 && bh < H && tid < D) {  // du of head bh: the batch rows in order
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += du_part[((size_t)b * H + bh) * D + tid];
    du[(size_t)bh * D + tid] = s;
  }
  // a row of S₀ for xs (step 3): row tid / 4, columns tid % 4 + 4j, loaded
  // while the chunk is staged
  const int prow = tid >> 2, pq = tid & 3;
  float s0v[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 4 * j + pq;
    s0v[j] = prow < D && col < D ? __ldg(S0 + (size_t)prow * D + col) : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  // 1. the decay scan: rq, kk and logp in place of r, k and logw; then
  //    row sd of dS times p_end[sd] in place (dS'), and xs = Σ_e S₀·dS',
  //    the column's four threads taking columns 4j + sq
  {
    const int sd = warp * 8 + L.g, sq = L.t;
    const bool on = sd < dp && 16 * sq < cp;
    float lw[16], l[16];
    const float p = expf(decay_scan(T2, sd, sq, on, lane, lw, l));
    if (on) {
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const int a = at(16 * sq + m, sd);
        const float rv = T0[a], kv = T1[a];
        T0[a] = rv * expf(l[m] - lw[m]);
        T1[a] = kv * expf(-l[m]);
        T2[a] = l[m];
      }
    }
    float s = 0.f;
    if (sd < dp) {
      const int x = rsw(sd);
      float* row5 = T5 + sd * kT;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (4 * j >= dp) continue;
        const int a = (4 * j + sq) ^ x;
        const float y = row5[a] * p;
        row5[a] = y;
        s += s0v[j] * y;
      }
    }
    s += __shfl_xor_sync(kFull, s, 1);
    s += __shfl_xor_sync(kFull, s, 2);
    if (sq == 0) xs[sd] = s;
  }
  __syncthreads();

  // A warp's row block: w for warps 0-3, 7 − w for warps 4-7, so the two
  // warps that share a SM sub-partition (w and w + 4) hold row blocks b and
  // 3 − b, whose triangles together cost every sub-partition the same.
  const int rb = warp < 4 ? warp : 7 - warp, m0 = 16 * rb;
  const bool rows_on = m0 < cp;
  // 4. group A: dv; group B: dk, −dkk'·kk into dlogw, Σ_j dk2·k2, and
  //    e^{logp − logw} in place of logp
  if (rows_on) {
    if (warp < 4)
      group_pass<true, kFull>(T0, T1, T2, T3, T4, T5, ddiag, diag, us, cs, dAp,
                              T3, r, logw, dv, dk, dlogw, off, m0, rb, c, D,
                              cp, dp, L);
    else
      group_pass<false, kFull>(T0, T1, T2, T3, T4, T5, ddiag, diag, us, cs, dAp,
                               T3, r, logw, dv, dk, dlogw, off, m0, rb, c, D,
                               cp, dp, L);
  }
  __syncthreads();  // dS' is done with: S₀ takes its tile
  {
    const float* const src[1] = {states};
    stage<kThreads, 1>(T5, src, soff, D, D, dp, dp, vec);
    cp_async_commit();
  }

  // 5. all warps, a row block and half the columns each: dr and G
  const int hf = warp >> 2;
  float acc[4][4];
  zero(acc);
  // k from global, fetched first, and dlogw's partial (−dkk'·kk, written
  // by group B before the barrier)
  float kv[4][4], pv[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int nd = 4 * hf + q;
      const int i = m0 + L.g + 8 * (x >> 1), d = 8 * nd + 2 * L.t + (x & 1);
      const bool in = rows_on && nd < ne_hi && i < c && d < D;
      const size_t gi = off + (size_t)i * D + d;
      kv[q][x] = in ? __ldg(k + gi) : 0.f;
      pv[q][x] = !in ? 0.f : kFull ? T3[cpos(m0, 8 * nd, x, L)] : dlogw[gi];
    }
  const float* pA = T4 + (m0 + L.g) * kT + L.t;  // dy rows i
  const int sA = L.fg ^ blk8(m0);
  if (rows_on) {  // drq = dA·kk over dA's blocks (rb, jb), jb <= rb
    const float* pD = dAp + (rb * (rb + 1) / 2) * 256 + L.g * 16 + L.t;
    const int sD = fpk(L.g);  // rows g and g + 8
    const float* pK = T1 + L.t * kT;  // kk rows k0 + t (+4)
#pragma unroll 1
    for (int jb = 0; jb <= rb; ++jb) {
#pragma unroll
      for (int kh = 0; kh < 16; kh += 8) {
        const float* pb = pD + jb * 256;
        uint32_t ah[4], al[4];
        const int c0 = kh ^ sD, c1 = (kh + 4) ^ sD;
        split_t(pb[c0], ah[0], al[0]);
        split_t(pb[128 + c0], ah[1], al[1]);
        split_t(pb[c1], ah[2], al[2]);
        split_t(pb[128 + c1], ah[3], al[3]);
        const int k0 = 16 * jb + kh;
        const float* pk = pK + k0 * kT;
        const int y0 = blk8(k0) ^ L.gt0, y1 = blk8(k0) ^ L.gt1;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int nd = 4 * hf + q;
          if (!kFull && nd >= ne_hi) continue;
          uint32_t bh_[2], bl_[2];
          split_t(pk[(8 * nd) ^ y0], bh_[0], bl_[0]);
          split_t(pk[4 * kT + ((8 * nd) ^ y1)], bh_[1], bl_[1]);
          mma3(acc[q], ah, al, bh_, bl_);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (rows_on) {
    const float* pS = T5 + L.g * kT + L.t;  // S₀ rows 8nd + g
#pragma unroll 1
    for (int k0 = 0; k0 < dp; k0 += 8) {
      uint32_t ah[4], al[4];
      const int c0 = k0 ^ sA, c1 = (k0 + 4) ^ sA;
      split_t(pA[c0], ah[0], al[0]);
      split_t(pA[8 * kT + c0], ah[1], al[1]);
      split_t(pA[c1], ah[2], al[2]);
      split_t(pA[8 * kT + c1], ah[3], al[3]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int nd = 4 * hf + q;
        if (!kFull && nd >= ne_hi) continue;
        const int s = L.fg ^ (8 * (nd >> 1));
        const float* p = pS + 8 * nd * kT;
        uint32_t bh_[2], bl_[2];
        split_t(p[k0 ^ s], bh_[0], bl_[0]);
        split_t(p[(k0 + 4) ^ s], bh_[1], bl_[1]);
        mma3(acc[q], ah, al, bh_, bl_);
      }
    }
    // dr, G into rq's tile, and the partial into e^{logp − logw}'s
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int nd = 4 * hf + q;
      if (nd >= ne_hi) continue;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = m0 + L.g + 8 * (x >> 1), d = 8 * nd + 2 * L.t + (x & 1);
        const int a = cpos(m0, 8 * nd, x, L);
        float gv = 0.f;
        if (i < c && d < D) {
          dr[off + (size_t)i * D + d] =
              acc[q][x] * T2[a] + ddiag[i] * us[d] * kv[q][x];
          gv = acc[q][x] * T0[a] + pv[q][x];
        }
        T0[a] = gv;
        T2[a] = pv[q][x];
      }
    }
  }
  __syncthreads();

  // 6. dlogw: column sd, rows 16·sq + 15 down to 16·sq, the later
  //    quarters' totals in order; the extra term at the chunk's last row
  {
    const int sd = warp * 8 + L.g, sq = L.t;
    const bool on = sd < dp && 16 * sq < cp;
    float pv[16];  // dlogw's partials of the column's 16 rows (step 5)
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const int i = 16 * sq + m;
      pv[m] = on && i < c && sd < D ? T2[at(i, sd)] : 0.f;
    }
    float extra = 0.f;
    for (int q = 0; 16 * q < cp; ++q) extra += cs[q * kT + sd];
    extra += xs[sd];
    float ex_[16], run = 0.f;
#pragma unroll
    for (int m = 15; m >= 0; --m) {
      const int i = 16 * sq + m;
      const float gv =
          on ? T0[at(i, sd)] + (i == c - 1 ? extra : 0.f) : 0.f;
      ex_[m] = run;
      run += gv;
    }
    const int q0 = lane & ~3;
    const float t1 = __shfl_sync(kFull, run, q0 + 1);
    const float t2 = __shfl_sync(kFull, run, q0 + 2);
    const float t3 = __shfl_sync(kFull, run, q0 + 3);
    const float o2 = t3 + t2, o1 = o2 + t1;
    const float offq = sq == 3 ? 0.f : sq == 2 ? t3 : sq == 1 ? o2 : o1;
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const int i = 16 * sq + m;
      if (on && i < c && sd < D)
        dlogw[off + (size_t)i * D + sd] =
            (offq + ex_[m]) + pv[m] + (i == c - 1 ? extra : 0.f);
    }
  }
}

}  // namespace

extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* logw, const void* u,
                                 const void* state0, void* y, void* state_out,
                                 void* states, int B, int H, int S, int D,
                                 int c, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || D <= 0 || D > kMaxD || c <= 0 ||
      c > kMaxC || S % c != 0 || (long long)B * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;  // opt in to > 48 KB of shared memory once
  if (!configured) {
    for (const void* f : {reinterpret_cast<const void*>(rwkv6_scan_kernel<false>),
                          reinterpret_cast<const void*>(rwkv6_scan_kernel<true>)}) {
      const cudaError_t e = cudaFuncSetAttribute(
          f, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    configured = true;
  }
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = D % 4 == 0 && aligned(r) && aligned(k) && aligned(v) &&
                  aligned(logw);
  const auto kernel = states ? rwkv6_scan_kernel<true>
                             : rwkv6_scan_kernel<false>;
  kernel<<<B * H, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(state0),
      static_cast<float*>(y), static_cast<float*>(state_out),
      static_cast<float*>(states), H, S, D, c, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rwkv6_scan_bwd_launch(
    const void* r, const void* k, const void* v, const void* logw,
    const void* u, const void* states, const void* dy, const void* d_state,
    void* dr, void* dk, void* dv, void* dlogw, void* du, void* dstate0,
    void* ds, void* du_part, void* rows, int B, int H, int S, int D, int c,
    void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || D <= 0 || D > kMaxD || c <= 0 ||
      c > kMaxC || S % c != 0 || (long long)B * H * (S / c) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    for (const void* f :
         {reinterpret_cast<const void*>(rwkv6_scan_bwd_ds_kernel<false>),
          reinterpret_cast<const void*>(rwkv6_scan_bwd_ds_kernel<true>)}) {
      const cudaError_t e = cudaFuncSetAttribute(
          f, cudaFuncAttributeMaxDynamicSharedMemorySize, kDsSmemBytes);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    for (const void* f :
         {reinterpret_cast<const void*>(rwkv6_scan_bwd_chunk_kernel<false>),
          reinterpret_cast<const void*>(rwkv6_scan_bwd_chunk_kernel<true>)}) {
      const cudaError_t e = cudaFuncSetAttribute(
          f, cudaFuncAttributeMaxDynamicSharedMemorySize, kChunkSmemBytes);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    configured = true;
  }
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = D % 4 == 0 && aligned(r) && aligned(k) && aligned(v) &&
                  aligned(logw) && aligned(dy) && aligned(states) &&
                  aligned(ds);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  // full tiles (c and D above 48): the products need no range checks
  const bool full = c > 48 && D > 48;
  const auto ds_kernel = full ? rwkv6_scan_bwd_ds_kernel<true>
                              : rwkv6_scan_bwd_ds_kernel<false>;
  const auto chunk_kernel = full ? rwkv6_scan_bwd_chunk_kernel<true>
                                 : rwkv6_scan_bwd_chunk_kernel<false>;
  ds_kernel<<<B * H, kDsThreads, kDsSmemBytes, st>>>(
      f(r), f(k), f(v), f(logw), f(dy), f(u), f(d_state),
      static_cast<float*>(ds), static_cast<float*>(dstate0),
      static_cast<float*>(du_part), static_cast<float*>(rows), H, S, D, c,
      vec);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  chunk_kernel<<<B * H * (S / c), kThreads, kChunkSmemBytes, st>>>(
      f(r), f(k), f(v), f(logw), f(u), f(states), f(ds), f(dy), f(du_part),
      f(rows), static_cast<float*>(dr), static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<float*>(dlogw),
      static_cast<float*>(du), B, H, S, D, c, vec);
  return static_cast<int>(cudaGetLastError());
}
