// Row normalisation for Hopper (sm_90a), one launch for the norm and the
// elementwise step before it:
//   rmsnorm:   out = v * rsqrt(mean(v^2) + eps) * scale
//   layernorm: out = (v - mu) * rsqrt(var + eps) * scale + bias,
//              mu = mean(v), var = mean((v - mu)^2)
// over the last axis of (rows, d) rows of bf16 or f32, computed in f32 and
// written in the rows' dtype; scale and bias are f32 (d,). Three forms,
// chosen by which pointers are set:
//   norm:       v = x;
//   add-norm:   v = round(x + r), also written to `sum` (the new residual
//               stream): the f32 add and the round to the rows' dtype of
//               eager `x + r`;
//   gated norm: v = round(x * silu(z)), silu(z) = z / (1 + expf(-z)) as
//               ATen writes it, z in f32 from bf16 or f32 whatever x's
//               dtype: Mamba-2's gate before its gated norm.
// In every form the norm is taken over the rounded v, so a fused call gives
// the bits of the eager step followed by the plain norm form.
//
// No TPU kernel: the reference computes the norm, the residual add and the
// gate as plain XLA ops (src/repro/models/layers.py, norm_apply;
// models/transformer.py, _block; models/ssm.py, _mixer). The port's plain
// versions are kernels/norm.py, norm_plain / add_norm_plain /
// gated_norm_plain, whose eager PyTorch reduction takes a row's sum in an
// order set by the number of rows (ATen sizes a reduction's block by its
// row count). That makes a Mamba-2 verify pass (B * s rows) round a token's
// norm otherwise than a decode step (B rows), so a speculative greedy
// stream could depart from plain greedy. This kernel fixes the order.
//
// What bounds it on an H100: bytes, and at the served sizes (8-40 rows) the
// launch itself: a norm moves 2 * d * 2 bytes a row in bf16 for ~4
// operations an element, tens of nanoseconds of device memory time against
// microseconds of launch. So the design fuses the launches next to the norm
// (the residual add, the gate: 1 and 4 eager launches) into it. The design:
//   * one block per row, its thread count a function of d alone (a warp
//     multiple, at most 256); each thread owns the fixed 16-byte columns
//     c = tid + i * blockDim of the row and keeps them in registers, so the
//     inputs are read from memory once, also for layernorm's second pass;
//     rows are read through a row stride (z is a column slice of Mamba-2's
//     in_proj output and is not copied first; where its offset or row
//     stride breaks the wide load, z is read one element a load, with the
//     same arithmetic and so the same bits);
//   * each f32 sum is one fixed tree: the thread's own elements in column
//     order, then a butterfly of warp shuffles, then the warps' partials in
//     warp order by thread 0. Nothing in the order depends on the number of
//     rows, the row's place in the grid or the leading shape, so a row gives
//     the same bits in a one-row call as in a 40-row call;
//   * all arithmetic is written without FMA contraction where the plain
//     version rounds each step ((v * r) * scale [+ bias]; the add; the
//     gate's product and quotient).
// Widths that are not a multiple of 16 bytes take a one-element-a-column
// variant of the same kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxVecs = 8;                // columns (of E elements) a thread holds

enum Form { kNorm = 0, kAddNorm = 1, kGatedNorm = 2 };

// n elements from p into f, 16 bytes a load where n fills them (the gate's
// z may be of another dtype than the rows: 8 f32 take two loads, 4 bf16 one
// 8-byte load), or one element a load where `wide` is false (a z whose
// offset or row stride is not aligned to the wide load)
__device__ __forceinline__ void load(const float* p, float* f, int n, bool wide = true) {
  if (wide && (n == 4 || n == 8)) {
#pragma unroll
    for (int i = 0; i < n / 4; ++i) {
      const float4 u = reinterpret_cast<const float4*>(p)[i];
      f[4 * i] = u.x; f[4 * i + 1] = u.y; f[4 * i + 2] = u.z; f[4 * i + 3] = u.w;
    }
  } else {
    for (int e = 0; e < n; ++e) f[e] = p[e];
  }
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float* f, int n,
                                     bool wide = true) {
  if (wide && (n == 8 || n == 4)) {
    __nv_bfloat162 h[4];
    if (n == 8) *reinterpret_cast<uint4*>(h) = *reinterpret_cast<const uint4*>(p);
    else *reinterpret_cast<uint2*>(h) = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
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

// an f32 value rounded to T (round to nearest even), back in f32
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ATen's silu in f32: x / (1 + exp(-x)), each step rounded
__device__ __forceinline__ float silu(float z) {
  return __fdiv_rn(z, __fadd_rn(1.0f, expf(-z)));
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

// E: elements a column (16 bytes of T, or 1 for a width that is not a
// multiple of 16 bytes); VPT: columns a thread holds at most; F: the form;
// R: the dtype of r (add-norm: T) or z (gated: bf16 or f32, whatever T is:
// Mamba-2's dual form hands over f32 y beside bf16 z). x, r: row strides
// xs, rs (elements); out and sum are contiguous. rwide: r's loads are as
// wide as x's (else one element a load: the same arithmetic, the same bits).
template <typename T, typename R, int E, int VPT, int F>
__global__ void __launch_bounds__(kMaxThreads)
norm_kernel(const T* __restrict__ x, long long xs, const R* __restrict__ r, long long rs,
            const float* __restrict__ scale, const float* __restrict__ bias,
            T* __restrict__ out, T* __restrict__ sum, int d, float eps, bool rwide) {
  __shared__ float red[kMaxWarps + 1];
  const int ncol = d / E;
  const T* xr = x + static_cast<size_t>(blockIdx.x) * xs;
  const R* rr = r + static_cast<size_t>(blockIdx.x) * rs;      // unused by the norm form
  float v[VPT][E];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < ncol) {
      load(xr + c * E, v[i], E);
      if (F != kNorm) {
        float w[E];
        load(rr + c * E, w, E, rwide);
#pragma unroll
        for (int e = 0; e < E; ++e)
          v[i][e] = round_to(F == kAddNorm ? __fadd_rn(v[i][e], w[e])
                                           : __fmul_rn(v[i][e], silu(w[e])), xr);
        if (F == kAddNorm) store(sum + static_cast<size_t>(blockIdx.x) * d + c * E, v[i], E);
      }
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
  const float rstd = rsqrtf(__fadd_rn(ms, eps));
  T* orow = out + static_cast<size_t>(blockIdx.x) * d;
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
        y[e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[i][e], mu), rstd), sc[e]), bi[e]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) y[e] = __fmul_rn(__fmul_rn(v[i][e], rstd), sc[e]);
    }
    store(orow + c * E, y, E);
  }
}

// threads a row: a warp multiple covering the columns, at most 256
int threads_for(int ncol) {
  const int t = (ncol + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

template <typename T, typename R, int E, int F>
int launch_form(const void* x, long long xs, const void* r, long long rs, bool rwide,
                const void* scale, const void* bias, void* out, void* sum, long long rows, int d,
                float eps, cudaStream_t stream) {
  const int ncol = d / E;
  const int threads = threads_for(ncol);
  const int vpt = (ncol + threads - 1) / threads;
  const T* xp = static_cast<const T*>(x);
  const R* rp = static_cast<const R*>(r);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  T* op = static_cast<T*>(out);
  T* mp = static_cast<T*>(sum);
  const dim3 grid(static_cast<unsigned>(rows));
  if (vpt <= 1)
    norm_kernel<T, R, E, 1, F><<<grid, threads, 0, stream>>>(xp, xs, rp, rs, sp, bp, op, mp, d,
                                                             eps, rwide);
  else if (vpt <= 2)
    norm_kernel<T, R, E, 2, F><<<grid, threads, 0, stream>>>(xp, xs, rp, rs, sp, bp, op, mp, d,
                                                             eps, rwide);
  else if (vpt <= 4)
    norm_kernel<T, R, E, 4, F><<<grid, threads, 0, stream>>>(xp, xs, rp, rs, sp, bp, op, mp, d,
                                                             eps, rwide);
  else if (vpt <= kMaxVecs)
    norm_kernel<T, R, E, kMaxVecs, F><<<grid, threads, 0, stream>>>(xp, xs, rp, rs, sp, bp, op,
                                                                    mp, d, eps, rwide);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int E>
int launch(const void* x, long long xs, const void* r, long long rs, const void* z,
           long long zs, int z_is_bf16, bool zwide, const void* scale, const void* bias,
           void* out, void* sum, long long rows, int d, float eps, cudaStream_t s) {
  if (r != nullptr)
    return launch_form<T, T, E, kAddNorm>(x, xs, r, rs, true, scale, bias, out, sum, rows, d,
                                          eps, s);
  if (z != nullptr && z_is_bf16)
    return launch_form<T, __nv_bfloat16, E, kGatedNorm>(x, xs, z, zs, zwide, scale, bias, out,
                                                        sum, rows, d, eps, s);
  if (z != nullptr)
    return launch_form<T, float, E, kGatedNorm>(x, xs, z, zs, zwide, scale, bias, out, sum,
                                                rows, d, eps, s);
  return launch_form<T, T, E, kNorm>(x, xs, nullptr, 0, true, scale, bias, out, sum, rows, d,
                                     eps, s);
}

}  // namespace

// x: (rows, d) with row stride xs (elements), bf16 (is_bf16 = 1) or f32;
// add-norm: r (rows, d) of x's dtype, row stride rs, and sum (rows, d)
// contiguous, which receives round(x + r); gated norm: z (rows, d), bf16
// (z_is_bf16 = 1) or f32, row stride zs, read E elements a load where
// z_wide is set (E = 16 bytes of x's dtype; at most 16 bytes a load), else
// one; the norm form: r, z and sum null (r and z never both set). out:
// (rows, d) contiguous. With d a multiple of 16 bytes of x's dtype, every
// row start of x, r and out is 16-byte aligned, and with z_wide z's is
// aligned to its wide load. scale: f32 (d,); bias: f32 (d,) for layernorm,
// null for rmsnorm. rows >= 1; 1 <= d <= 256 * 8 columns of 16 bytes
// (16,384 bf16, 8,192 f32), or 2,048 elements when d is not a multiple of
// 16 bytes. Returns cudaGetLastError().
extern "C" int norm_launch(const void* x, long long xs, const void* r, long long rs,
                           const void* z, long long zs, int z_is_bf16, int z_wide,
                           const void* scale, const void* bias, void* out, void* sum,
                           long long rows, int d, float eps, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || rows > 0x7fffffffLL || d < 1 || (r != nullptr && z != nullptr)
      || ((r != nullptr) != (sum != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool zw = z_wide != 0;
  if (is_bf16)
    return d % 8 == 0 ? launch<__nv_bfloat16, 8>(x, xs, r, rs, z, zs, z_is_bf16, zw, scale,
                                                 bias, out, sum, rows, d, eps, s)
                      : launch<__nv_bfloat16, 1>(x, xs, r, rs, z, zs, z_is_bf16, zw, scale,
                                                 bias, out, sum, rows, d, eps, s);
  return d % 4 == 0 ? launch<float, 4>(x, xs, r, rs, z, zs, z_is_bf16, zw, scale, bias, out,
                                       sum, rows, d, eps, s)
                    : launch<float, 1>(x, xs, r, rs, z, zs, z_is_bf16, zw, scale, bias, out,
                                       sum, rows, d, eps, s);
}
