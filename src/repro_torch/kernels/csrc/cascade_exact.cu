// The bit-accurate CASCADE matmul (the paper's Table 6 dataflow), Hopper
// (sm_90a): out[m, n] = the FP8 E4M3 sum, in order over k, of the FP5 E3M1
// products x4[m, k] * w4[k, n]:
//   acc = fp8(bias[n]) (or 0);  for k in 0..K-1:  acc = fp8(acc + fp5(x * w))
// fp5(p): the f32 product with its mantissa cut to 1 bit (sign-magnitude
// bits masked); fp8(s): s saturated to +/-448 (a NaN passes, as jnp.clip
// passes it), then below 2^-6 truncated to a multiple of 2^-9, else its
// mantissa cut to 3 bits. x4 and w4 are FP4-valued f32 (core/cascade.py's
// precision_sim path rounds them onto the grid first).
//
// No TPU kernel: the reference's cascade_matmul_exact
// (src/repro/core/quant.py:180) is an XLA fori_loop over K on a (..., K, N)
// product tensor. The port's plain version is core/quant.py,
// cascade_matmul_exact: K dependent steps of a few eager launches each.
//
// What bounds it on an H100: by the count, the bytes of w (at M = 8) and
// some 8 operations a (row, column, k) step; in fact the order of the FP8
// truncations, which is the semantics, so nothing is split along K: the
// only parallelism is across outputs, and each output is a K-long chain.
// Each thread owns one column n and up to kRows rows, walks K once, reads
// w[k, n] once for all its rows (coalesced across the warp) and x[m, k] as
// a broadcast, and keeps kRows independent sums in registers, so their
// dependent chains overlap. Every step is one
// IEEE f32 operation (__fmul_rn, __fadd_rn) or a bit mask; the saturation is
// written as comparisons (fminf / fmaxf would drop a NaN), and
// trunc(s * 2^9) * 2^-9 is exact.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;

__device__ __forceinline__ float truncate_mantissa(float x, uint32_t mask) {
  return __uint_as_float(__float_as_uint(x) & mask);
}

__device__ __forceinline__ float fp8_e4m3_truncate(float x) {
  const float sat = x > 448.0f ? 448.0f : (x < -448.0f ? -448.0f : x);
  if (fabsf(sat) < 0.015625f)                                        // 2^-6
    return __fmul_rn(truncf(__fmul_rn(sat, 512.0f)), 0.001953125f);  // 2^-9 steps
  return truncate_mantissa(sat, 0xFFF00000u);                        // 3 mantissa bits
}

__global__ void __launch_bounds__(kThreads)
cascade_matmul_exact_kernel(const float* __restrict__ x, const float* __restrict__ w,
                            const float* __restrict__ bias, float* __restrict__ out, int m,
                            int k, int n) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  const int row0 = blockIdx.y * kRows;
  if (col >= n) return;
  const int rows = min(kRows, m - row0);
  float acc[kRows];
  const float init = bias != nullptr ? fp8_e4m3_truncate(bias[col]) : 0.0f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = init;
  const float* xr = x + static_cast<long long>(row0) * k;
  for (int i = 0; i < k; ++i) {
    const float wv = w[static_cast<long long>(i) * n + col];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {
        const float p = truncate_mantissa(__fmul_rn(__ldg(xr + static_cast<long long>(r) * k + i),
                                                     wv), 0xFFC00000u);   // 1 mantissa bit
        acc[r] = fp8_e4m3_truncate(__fadd_rn(acc[r], p));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (r < rows) out[static_cast<long long>(row0 + r) * n + col] = acc[r];
}

}  // namespace

// x: (m, k) f32, w: (k, n) f32, bias: (n,) f32 or null, out: (m, n) f32, all
// contiguous. Grid (ceil(n / 256), ceil(m / 8)), 256 threads. Returns
// cudaGetLastError().
extern "C" int cascade_exact_launch(const void* x, const void* w, const void* bias, void* out,
                                    int m, int k, int n, void* stream) {
  if (m < 1 || k < 1 || n < 1 || (m + kRows - 1) / kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kThreads - 1) / kThreads, (m + kRows - 1) / kRows);
  cascade_matmul_exact_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), m, k, n);
  return static_cast<int>(cudaGetLastError());
}
