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

__global__ void __launch_bounds__(kThreads, 2)
    rwkv6_scan_kernel(const float* __restrict__ r,  // (B, H, S, D)
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ logw,
                      const float* __restrict__ u,  // (H, D)
                      const float* __restrict__ state0,  // (B, H, D, D) or null
                      float* __restrict__ y,  // (B, H, S, D)
                      float* __restrict__ state_out,  // (B, H, D, D)
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

}  // namespace

extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* logw, const void* u,
                                 const void* state0, void* y, void* state_out,
                                 int B, int H, int S, int D, int c,
                                 void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || D <= 0 || D > kMaxD || c <= 0 ||
      c > kMaxC || S % c != 0 || (long long)B * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;  // opt in to > 48 KB of shared memory once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        rwkv6_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = D % 4 == 0 && aligned(r) && aligned(k) && aligned(v) &&
                  aligned(logw);
  rwkv6_scan_kernel<<<B * H, kThreads, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(state0),
      static_cast<float*>(y), static_cast<float*>(state_out), H, S, D, c, vec);
  return static_cast<int>(cudaGetLastError());
}
