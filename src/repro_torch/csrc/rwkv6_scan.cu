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
// rwkv6_scan_bwd_kernel — the backward of the chunked WKV6 above.
//
// Replaces no Pallas kernel: the JAX package has no backward for
// rwkv6_pallas and trains rwkv6 by differentiating its jnp chunk,
// repro/models/layers.py::_wkv_chunk, so this kernel takes the place of the
// VJP that JAX derives from it. It computes kernels/rwkv6_scan/ref.py::
// rwkv6_bwd_ref: for batch row b and head h it walks the chunks in reverse
// with dS (the cotangent of the state leaving the chunk, from d_state or 0)
// in shared memory, and per chunk, from the state S₀ entering it (written
// by the forward's rwkv6_scan_kernel<true>, so nothing is recomputed by a
// forward sweep here), forms the decay scan as the forward does (rq, kk,
// k2, p_end; logp rounded as the forward rounds it), then
//   A = tril_strict(rq·kkᵀ), dA = tril_strict(dy·vᵀ),
//   dv = Aᵀ·dy + diag·dy + k2·dS,  drq = dA·kk + dy·S₀ᵀ,  dkk = dAᵀ·rq,
//   dk2 = v·dSᵀ,  dS₀ = rqᵀ·dy + diag(p_end)·dS (the next chunk's dS),
// dr and dk through the exp factors and the bonus, and dlogw as the reverse
// cumulative sum of G = drq·rq − dkk·kk − dk2·k2 (plus Σ_j dk2·k2 and
// dp_end·p_end at the chunk's last row) minus drq·rq, four threads a column
// as the forward's scan. du = Σ_{b,t} (Σ_e dy·v)·r·k needs no recurrence:
// the first H CTAs of the grid each sum one head's over its batch rows and
// steps, in order, so du comes out of the same launch with no atomics and
// no cross-CTA dependency; dstate0 is dS after chunk 0.
//
// What bounds it on an H100, at the training path's B=2, H=64, S=512,
// D=64, c=64: bytes in (r, k, v, logw, dy; the saved states, 16.8 MB) and
// out (dr, dk, dv, dlogw; dstate0), ~172 MB: 0.051 ms at 3.35 TB/s; and
// float32 operations on the CUDA cores, counted as the function needs them
// (the five triangular products as triangles), 3.47 GFLOP: 0.052 ms at 67
// TFLOP/s. Nearly balanced. The design here is the simple one, right
// first: each 64 × 64 tile of a chunk sits in shared memory with rows
// padded to 65 floats, so every product reads its operands from shared
// memory without bank conflicts in any of the four transposition cases;
// each of the 256 threads keeps a 4 × 4 block of the output (rows ty + 16m,
// columns tx + 16n) in registers, one FMA chain a value, over the full 64
// of the reduced dimension (padding is zero; the triangles are not
// skipped). Thirteen such tiles take 218 KB, so one CTA of 8 warps runs a
// SM and the path's 128 (b, h) CTAs plus the 64 du CTAs take two partial
// waves. It does ~1.4× the needed FMAs (full squares), loading two shared
// operands for every four FMAs a thread, so shared-memory issue, not bytes
// or the FMA pipe, should set its pace: it measured 0.461 ms, 8.9× the
// bound (PERF.md). Skipping the triangles, the tensor cores (the
// forward's 3xTF32 mma.sync) and staging the next chunk during this one
// are the steps after it.
// Padding as the forward: rows past c and columns past D are zero, so a
// padded row's logw (0) adds nothing to the cumsum and every padded entry
// of rq, kk, k2, A, dA, G is 0. Every sum runs in a fixed order: two calls
// give the same bits.

constexpr int kBwdThreads = 256;
constexpr int kLdT = 65;  // row stride of every staged 64 × 64 tile
constexpr int kTileF = 64 * kLdT;
constexpr int kBwdTiles = 13;
// tiles, then u, diag, ddiag, p_end, logp_c, dp_end (64 each) and the
// (16 × 64) column partials
constexpr int kBwdSmemFloats = kBwdTiles * kTileF + 6 * 64 + 16 * 64;
constexpr int kBwdSmemBytes = 4 * kBwdSmemFloats;

// acc[m][n] += Σ_{q<64} X(ty + 16m, q)·Y(q, tx + 16n), where X(i, q) is
// X[q][i] if TX else X[i][q], and Y(q, j) is Y[j][q] if TY else Y[q][j].
template <bool TX, bool TY>
__device__ __forceinline__ void tile_mm(float (&acc)[4][4],
                                        const float* __restrict__ X,
                                        const float* __restrict__ Y, int tx,
                                        int ty) {
#pragma unroll 4
  for (int q = 0; q < 64; ++q) {
    float xa[4], yb[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = ty + 16 * m;
      xa[m] = TX ? X[q * kLdT + i] : X[i * kLdT + q];
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int j = tx + 16 * n;
      yb[n] = TY ? Y[j * kLdT + q] : Y[q * kLdT + j];
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(xa[m], yb[n], acc[m][n]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;
}

// du for head h: Σ over batch rows and steps, in order, of ddiag·r·k, 64
// rows (b, t) at a time.
__device__ void du_head(const float* __restrict__ r,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dy, float* __restrict__ du,
                        float* smem, int h, int B, int H, int S, int D) {
  float* R = smem;
  float* K = R + kTileF;
  float* V = K + kTileF;
  float* DY = V + kTileF;
  float* dd = DY + kTileF;
  const int tid = threadIdx.x;
  const long long rows = (long long)B * S;
  float acc = 0.f;
  for (long long base = 0; base < rows; base += 64) {
    __syncthreads();
    for (int i = tid; i < 64 * 64; i += kBwdThreads) {
      const int row = i / 64, col = i % 64;
      const long long gr = base + row;
      const bool in = gr < rows && col < D;
      const size_t gi =
          in ? (((size_t)(gr / S) * H + h) * S + gr % S) * D + col : 0;
      R[row * kLdT + col] = in ? r[gi] : 0.f;
      K[row * kLdT + col] = in ? k[gi] : 0.f;
      V[row * kLdT + col] = in ? v[gi] : 0.f;
      DY[row * kLdT + col] = in ? dy[gi] : 0.f;
    }
    __syncthreads();
    if (tid < 64) {
      float s = 0.f;
      for (int e = 0; e < 64; ++e) s += DY[tid * kLdT + e] * V[tid * kLdT + e];
      dd[tid] = s;
    }
    __syncthreads();
    if (tid < 64)
      for (int row = 0; row < 64; ++row)
        acc += dd[row] * R[row * kLdT + tid] * K[row * kLdT + tid];
  }
  if (tid < D) du[(size_t)h * D + tid] = acc;
}

__global__ void __launch_bounds__(kBwdThreads, 1)
    rwkv6_scan_bwd_kernel(const float* __restrict__ r,  // (B, H, S, D)
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ logw,
                          const float* __restrict__ u,  // (H, D)
                          const float* __restrict__ states,  // (B, H, n, D, D)
                          const float* __restrict__ dy,  // (B, H, S, D)
                          const float* __restrict__ d_state,  // or null
                          float* __restrict__ dr, float* __restrict__ dk,
                          float* __restrict__ dv, float* __restrict__ dlogw,
                          float* __restrict__ du,  // (H, D)
                          float* __restrict__ dstate0,  // or null
                          int B, int H, int S, int D, int c) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  if (blockIdx.x < H) {  // the first H CTAs: du, one head each
    du_head(r, k, v, dy, du, smem, blockIdx.x, B, H, S, D);
    return;
  }
  float* R = smem;
  float* K = R + kTileF;
  float* V = K + kTileF;
  float* DY = V + kTileF;
  float* EX = DY + kTileF;  // logw, then exp(logp - logw)
  float* LP = EX + kTileF;  // logp
  float* RQ = LP + kTileF;
  float* KK = RQ + kTileF;
  float* K2 = KK + kTileF;
  float* S0 = K2 + kTileF;
  float* DS = S0 + kTileF;
  float* A = DS + kTileF;  // A, then G
  float* DA = A + kTileF;  // dA, then drq·rq
  float* us = DA + kTileF;
  float* diag = us + 64;
  float* ddiag = diag + 64;
  float* pend = ddiag + 64;
  float* lpc = pend + 64;
  float* dpend = lpc + 64;
  float* colp = dpend + 64;  // (16, 64): scan totals, then Σ dk2·k2 partials

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int sd = tid & 63, sq = tid >> 6;  // scan column and 16-row quarter
  const int bh = blockIdx.x - H, h = bh % H;
  const size_t seq_base = (size_t)bh * S * D;
  const size_t st_base = (size_t)bh * D * D;
  const int n_chunks = S / c;

  if (tid < 64) us[tid] = tid < D ? u[(size_t)h * D + tid] : 0.f;
  for (int i = tid; i < 64 * 64; i += kBwdThreads) {
    const int d = i / 64, e = i % 64;
    DS[d * kLdT + e] = (d_state && d < D && e < D)
                           ? d_state[st_base + (size_t)d * D + e]
                           : 0.f;
  }

  for (int n = n_chunks - 1; n >= 0; --n) {
    __syncthreads();  // chunk n + 1 is done with every tile
    const size_t off = seq_base + (size_t)n * c * D;
    const float* s0g = states + ((size_t)bh * n_chunks + n) * D * D;
    for (int i = tid; i < 64 * 64; i += kBwdThreads) {
      const int row = i / 64, col = i % 64, at = row * kLdT + col;
      const bool in = row < c && col < D;
      const size_t gi = off + (size_t)row * D + col;
      R[at] = in ? r[gi] : 0.f;
      K[at] = in ? k[gi] : 0.f;
      V[at] = in ? v[gi] : 0.f;
      DY[at] = in ? dy[gi] : 0.f;
      EX[at] = in ? logw[gi] : 0.f;
      S0[at] = (row < D && col < D) ? s0g[(size_t)row * D + col] : 0.f;
    }
    __syncthreads();

    // 1. the decay scan, rounded as the forward's: column sd, rows
    //    16·sq .. 16·sq + 15, then the quarters' offsets in order
    {
      float lw[16], lp[16], run = 0.f;
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        lw[m] = EX[(16 * sq + m) * kLdT + sd];
        run += lw[m];
        lp[m] = run;
      }
      colp[sq * 64 + sd] = run;
      __syncthreads();
      float o = 0.f, offq = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q == sq) offq = o;
        o = q == 0 ? colp[sd] : o + colp[q * 64 + sd];
      }
      const float total = o;  // the last real row's logp
      if (sq == 0) {
        pend[sd] = expf(total);
        lpc[sd] = total;
      }
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const int at = (16 * sq + m) * kLdT + sd;
        const float l = offq + lp[m];
        const float ex = expf(l - lw[m]);
        const float kv = K[at];
        LP[at] = l;
        EX[at] = ex;
        RQ[at] = R[at] * ex;
        KK[at] = kv * expf(-l);
        K2[at] = kv * expf(total - l);
      }
    }
    __syncthreads();

    // 2. A and dA, strictly lower triangular; the bonus diag, ddiag, dp_end
    {
      float acc[4][4];
      zero(acc);
      tile_mm<false, true>(acc, RQ, KK, tx, ty);
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          const int i = ty + 16 * m, j = tx + 16 * nn;
          A[i * kLdT + j] = j < i ? acc[m][nn] : 0.f;
        }
      zero(acc);
      tile_mm<false, true>(acc, DY, V, tx, ty);
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          const int i = ty + 16 * m, j = tx + 16 * nn;
          DA[i * kLdT + j] = j < i ? acc[m][nn] : 0.f;
        }
      const int row = tid & 63;
      float s = 0.f;
      if (tid < 64) {
        for (int d = 0; d < 64; ++d)
          s += R[row * kLdT + d] * us[d] * K[row * kLdT + d];
        diag[row] = s;
      } else if (tid < 128) {
        for (int e = 0; e < 64; ++e)
          s += DY[row * kLdT + e] * V[row * kLdT + e];
        ddiag[row] = s;
      } else if (tid < 192) {
        for (int e = 0; e < 64; ++e)
          s += S0[row * kLdT + e] * DS[row * kLdT + e];
        dpend[row] = s;
      }
    }
    __syncthreads();

    // 3. dv out; drq, dkk, dk2 → dr, dk out, G and drq·rq; dS₀
    float g[4][4], x[4][4], ds0[4][4];
    {
      float a1[4][4], a2[4][4];
      zero(a1);
      zero(a2);
      tile_mm<true, false>(a1, A, DY, tx, ty);  // Aᵀ·dy
      tile_mm<false, false>(a2, K2, DS, tx, ty);  // k2·dS
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          const int j = ty + 16 * m, e = tx + 16 * nn;
          if (j < c && e < D)
            dv[off + (size_t)j * D + e] =
                a1[m][nn] + diag[j] * DY[j * kLdT + e] + a2[m][nn];
        }
    }
    {
      float drq[4][4], dkk[4][4], dk2[4][4];
      zero(drq);
      tile_mm<false, false>(drq, DA, KK, tx, ty);  // dA·kk
      float t2[4][4];
      zero(t2);
      tile_mm<false, true>(t2, DY, S0, tx, ty);  // dy·S₀ᵀ
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) drq[m][nn] += t2[m][nn];
      zero(dkk);
      tile_mm<true, false>(dkk, DA, RQ, tx, ty);  // dAᵀ·rq
      zero(dk2);
      tile_mm<false, true>(dk2, V, DS, tx, ty);  // v·dSᵀ
      zero(ds0);
      tile_mm<true, false>(ds0, RQ, DY, tx, ty);  // rqᵀ·dy
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        const int d = tx + 16 * nn;
        float cs = 0.f;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int i = ty + 16 * m, at = i * kLdT + d;
          const float rq = RQ[at], kk = KK[at], k2 = K2[at], l = LP[at];
          const float bonus = ddiag[i] * us[d];
          if (i < c && d < D) {
            const size_t gi = off + (size_t)i * D + d;
            dr[gi] = drq[m][nn] * EX[at] + bonus * K[at];
            dk[gi] = dkk[m][nn] * expf(-l) + dk2[m][nn] * expf(lpc[d] - l) +
                     bonus * R[at];
          }
          x[m][nn] = drq[m][nn] * rq;
          g[m][nn] = x[m][nn] - dkk[m][nn] * kk - dk2[m][nn] * k2;
          cs += dk2[m][nn] * k2;
          const int dd = ty + 16 * m;  // dS₀ row
          ds0[m][nn] += pend[dd] * DS[dd * kLdT + d];
        }
        colp[ty * 64 + d] = cs;
      }
    }
    __syncthreads();  // every read of A, dA and dS is done
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        const int at = (ty + 16 * m) * kLdT + tx + 16 * nn;
        A[at] = g[m][nn];
        DA[at] = x[m][nn];
        DS[at] = ds0[m][nn];
      }
    __syncthreads();

    // 4. dlogw = revcumsum(G) − drq·rq: column sd, rows 16·sq + 15 down to
    //    16·sq, then the later quarters' totals in order
    {
      float extra = 0.f;
      for (int t = 0; t < 16; ++t) extra += colp[t * 64 + sd];
      extra += dpend[sd] * pend[sd];
      float gs[16], run = 0.f;
#pragma unroll
      for (int m = 15; m >= 0; --m) {
        const int i = 16 * sq + m;
        float gv = A[i * kLdT + sd];
        if (i == c - 1) gv += extra;
        run += gv;
        gs[m] = run;
      }
      __syncthreads();  // the totals reuse colp
      colp[sq * 64 + sd] = run;
      __syncthreads();
      float o = 0.f, offq = 0.f;
#pragma unroll
      for (int q = 3; q >= 0; --q) {
        if (q == sq) offq = o;
        o = q == 3 ? colp[3 * 64 + sd] : o + colp[q * 64 + sd];
      }
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const int i = 16 * sq + m;
        if (i < c && sd < D)
          dlogw[off + (size_t)i * D + sd] =
              (offq + gs[m]) - DA[i * kLdT + sd];
      }
    }
  }
  __syncthreads();
  if (dstate0)
    for (int i = tid; i < D * D; i += kBwdThreads)
      dstate0[st_base + i] = DS[(i / D) * kLdT + i % D];
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
    void* dr, void* dk, void* dv, void* dlogw, void* du, void* dstate0, int B,
    int H, int S, int D, int c, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || D <= 0 || D > kMaxD || c <= 0 ||
      c > kMaxC || S % c != 0 || (long long)B * H + H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        rwkv6_scan_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kBwdSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  rwkv6_scan_bwd_kernel<<<H + B * H, kBwdThreads, kBwdSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(states),
      static_cast<const float*>(dy), static_cast<const float*>(d_state),
      static_cast<float*>(dr), static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<float*>(dlogw),
      static_cast<float*>(du), static_cast<float*>(dstate0), B, H, S, D, c);
  return static_cast<int>(cudaGetLastError());
}
