// Row normalisation for Hopper (sm_90a), one launch for the whole norm:
//   rmsnorm:   out = x * rsqrt(mean(x^2) + eps) * scale
//   layernorm: out = (x - mu) * rsqrt(var + eps) * scale + bias,
//              mu = mean(x), var = mean((x - mu)^2)
// over the last axis of (rows, d) rows of bf16 or f32, computed in f32 and
// written in x's dtype; scale and bias are f32 (d,).
//
// No TPU kernel: the reference computes the norm as plain XLA ops
// (src/repro/models/layers.py, norm_apply). The port's plain version is
// kernels/norm.py, norm_plain, whose eager PyTorch reduction takes a row's
// sum in an order set by the number of rows (ATen sizes a reduction's block
// by its row count). That makes a Mamba-2 verify pass (B * s rows) round a
// token's norm otherwise than a decode step (B rows), so a speculative
// greedy stream could depart from plain greedy. This kernel fixes the order.
//
// What bounds it on an H100: bytes. A row is read once and written once
// (2 * d * 2 bytes in bf16) for ~4 operations an element. The design:
//   * one block per row, its thread count a function of d alone (a warp
//     multiple, at most 256); each thread owns the fixed 16-byte columns
//     c = tid + i * blockDim of the row and keeps them in registers, so x is
//     read from memory once, also for layernorm's second pass;
//   * each f32 sum is one fixed tree: the thread's own elements in column
//     order, then a butterfly of warp shuffles, then the warps' partials in
//     warp order by thread 0. Nothing in the order depends on the number of
//     rows, the row's place in the grid or the leading shape, so a row gives
//     the same bits in a one-row call as in a 40-row call;
//   * the elementwise tail is written without FMA contraction, in the plain
//     version's order ((x * r) * scale [+ bias]).
// Widths that are not a multiple of 16 bytes take a one-element-a-column
// variant of the same kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxVecs = 8;                // columns (of E elements) a thread holds

__device__ __forceinline__ void load(const float* p, float* f, int n) {
  if (n == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  } else {
    for (int e = 0; e < n; ++e) f[e] = p[e];
  }
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float* f, int n) {
  if (n == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  } else {
    for (int e = 0; e < n; ++e) f[e] = __bfloat162float(p[e]);
  }
}
__device__ __forceinline__ void store(float* p, const float* f, int n) {
  if (n == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
    for (int e = 0; e < n; ++e) p[e] = f[e];
  }
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* f, int n) {
  if (n == 8) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    for (int e = 0; e < n; ++e) p[e] = __float2bfloat16_rn(f[e]);
  }
}

// The block's sum of v in one fixed order: a shuffle butterfly in each warp
// (every lane ends with the same bits), then thread 0 adds the warps'
// partials in warp order. Two barriers: the next call's writes to red come
// after every thread has read this call's total.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = red[0];
    for (int w = 1; w < static_cast<int>(blockDim.x / 32); ++w) s += red[w];
    red[kMaxWarps] = s;
  }
  __syncthreads();
  return red[kMaxWarps];
}

// E: elements a column (16 bytes' worth, or 1 for a width that is not a
// multiple of 16 bytes); VPT: columns a thread holds at most
template <typename T, int E, int VPT>
__global__ void __launch_bounds__(kMaxThreads)
norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
            const float* __restrict__ bias, T* __restrict__ out, int d, float eps) {
  __shared__ float red[kMaxWarps + 1];
  const int ncol = d / E;
  const size_t row = static_cast<size_t>(blockIdx.x) * d;
  const T* xr = x + row;
  float v[VPT][E];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < ncol) {
      load(xr + c * E, v[i], E);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) v[i][e] = 0.f;
    }
  }
  float mu = 0.f;
  if (bias != nullptr) {                   // layernorm: the mean first
#pragma unroll
    for (int i = 0; i < VPT; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e) s = __fadd_rn(s, v[i][e]);
    mu = __fdiv_rn(block_sum(s, red), static_cast<float>(d));
    s = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = threadIdx.x + i * blockDim.x;
      if (c < ncol) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float t = __fsub_rn(v[i][e], mu);
          s = __fmaf_rn(t, t, s);
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < VPT; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e) s = __fmaf_rn(v[i][e], v[i][e], s);
  }
  const float ms = __fdiv_rn(block_sum(s, red), static_cast<float>(d));
  const float r = rsqrtf(__fadd_rn(ms, eps));
  T* orow = out + row;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c >= ncol) continue;
    float sc[E], y[E];
    load(scale + c * E, sc, E);
    if (bias != nullptr) {
      float bi[E];
      load(bias + c * E, bi, E);
#pragma unroll
      for (int e = 0; e < E; ++e)
        y[e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[i][e], mu), r), sc[e]), bi[e]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) y[e] = __fmul_rn(__fmul_rn(v[i][e], r), sc[e]);
    }
    store(orow + c * E, y, E);
  }
}

// threads a row: a warp multiple covering the columns, at most 256
int threads_for(int ncol) {
  const int t = (ncol + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

template <typename T, int E>
int launch(const void* x, const void* scale, const void* bias, void* out, long long rows, int d,
           float eps, cudaStream_t stream) {
  const int ncol = d / E;
  const int threads = threads_for(ncol);
  const int vpt = (ncol + threads - 1) / threads;
  const T* xp = static_cast<const T*>(x);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  T* op = static_cast<T*>(out);
  const dim3 grid(static_cast<unsigned>(rows));
  if (vpt <= 1) norm_kernel<T, E, 1><<<grid, threads, 0, stream>>>(xp, sp, bp, op, d, eps);
  else if (vpt <= 2) norm_kernel<T, E, 2><<<grid, threads, 0, stream>>>(xp, sp, bp, op, d, eps);
  else if (vpt <= 4) norm_kernel<T, E, 4><<<grid, threads, 0, stream>>>(xp, sp, bp, op, d, eps);
  else if (vpt <= kMaxVecs)
    norm_kernel<T, E, kMaxVecs><<<grid, threads, 0, stream>>>(xp, sp, bp, op, d, eps);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (rows, d) contiguous, bf16 (is_bf16 = 1) or f32, 16-byte aligned;
// scale: f32 (d,); bias: f32 (d,) for layernorm, null for rmsnorm. rows
// >= 1; 1 <= d <= 256 * 8 columns of 16 bytes (16,384 bf16, 8,192 f32), or
// 2,048 elements when d is not a multiple of 16 bytes. Returns
// cudaGetLastError().
extern "C" int norm_launch(const void* x, const void* scale, const void* bias, void* out,
                           long long rows, int d, float eps, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || rows > 0x7fffffffLL || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return d % 8 == 0 ? launch<__nv_bfloat16, 8>(x, scale, bias, out, rows, d, eps, s)
                      : launch<__nv_bfloat16, 1>(x, scale, bias, out, rows, d, eps, s);
  return d % 4 == 0 ? launch<float, 4>(x, scale, bias, out, rows, d, eps, s)
                    : launch<float, 1>(x, scale, bias, out, rows, d, eps, s);
}
