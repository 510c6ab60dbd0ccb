// rglru_scan.cu — the RG-LRU linear recurrence over a sequence.
//
// Replaces the TPU kernel repro/kernels/rglru_scan/kernel.py (rglru_pallas,
// its pallas_call at kernel.py:61).
//
// For every batch row b and channel c it runs h_t = exp(log_a_t)·h_{t-1} +
// b_t from h_0 (zeros, or the h0 operand) over t = 0..S-1 in float32, and
// writes y[b, t, c] = h_t and h_last[b, c] = h_{S-1} — the function of
// kernels/rglru_scan/ref.py, with the same operations in the same order:
// expf (no fast math), one rounded multiply and one rounded add per step
// (__fmul_rn/__fadd_rn keep nvcc from contracting them into an FMA).
//
// The TPU kernel uses a closed form over each chunk, h_i = e^{cumA_i}(h_0 +
// Σ_j b_j e^{-cumA_j}); e^{-cumA} overflows float32 once a chunk's summed
// log-decay passes about -88, which the model's own gates reach within a few
// dozen steps (log a ≈ -5 per step). This kernel computes the recurrence
// itself and never forms e^{-cumA}.
//
// What bounds it on an H100: bytes — log_a and b read once, y written once
// (3·B·S·C·4 bytes, ~135 us at the serving path's B=4, S=2304, C=4096).
// One thread per (b, c) walks the sequence; neighbouring threads take
// neighbouring channels, so every step's loads and stores are coalesced, and
// the loads of kUnroll steps are issued before their updates so that the
// memory latency of one step overlaps the others. A chunked parallel scan
// (per-chunk (A, B) pairs combined across chunks) is left to a later change.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;  // channels per CTA: B·C/64 CTAs spread the SMs
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads) rglru_scan_kernel(
    const float* __restrict__ log_a,  // (B, S, C)
    const float* __restrict__ bx,  // (B, S, C)
    const float* __restrict__ h0,  // (B, C) or null
    float* __restrict__ y,  // (B, S, C)
    float* __restrict__ h_last,  // (B, C)
    int S, int C) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= C) return;
  const size_t base = (size_t)b * S * C + c;
  float h = h0 ? h0[(size_t)b * C + c] : 0.f;
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
    float a[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < S) {
        const size_t i = base + (size_t)(t0 + u) * C;
        a[u] = log_a[i];
        bv[u] = bx[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < S) {
        h = __fadd_rn(__fmul_rn(expf(a[u]), h), bv[u]);
        y[base + (size_t)(t0 + u) * C] = h;
      }
    }
  }
  h_last[(size_t)b * C + c] = h;
}

}  // namespace

extern "C" int rglru_scan_launch(const void* log_a, const void* bx,
                                 const void* h0, void* y, void* h_last, int B,
                                 int S, int C, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((C + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(bx),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_last), S, C);
  return static_cast<int>(cudaGetLastError());
}
