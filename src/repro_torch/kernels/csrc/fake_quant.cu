// FP4 fake quantization for quantization-aware training, Hopper (sm_90a):
//   out = w + round(qdq(w) - w),  qdq(w) = fp4_round(w / scale) * scale,
//   scale = absmax / 6 over the weight's (group, column), 1 where that is 0,
// every step one IEEE f32 operation, `round` to w's dtype (bf16 or f32), the
// add in f32 and rounded once to w's dtype as ATen's bf16 add rounds it.
// fp4_round is the E2M1 grid {0, .5, 1, 1.5, 2, 3, 4, 6}: round to nearest,
// ties to the even code, saturating at 6, NaN to -0 (core/quant.py,
// fp4_round). Rows of a group are contiguous K rows (group_size rows, or all
// of K); a weight (B, K, N) holds B matrices (an MoE layer's experts), each
// with its own scales.
//
// No TPU kernel: the reference's fake_quant_fp4 (src/repro/core/quant.py:257)
// is plain XLA, and its training path reaches no Pallas kernel. The port's
// plain version is kernels/fake_quant.py, fake_quant_fp4_plain (about ten
// eager passes over f32 copies of the weight). Under QAT it runs on every
// weight in every forward of every step, and again in each recompute.
//
// What bounds it on an H100: bytes. A call reads the weight and writes it
// back, 4 bytes an element in bf16, with some 20 operations an element.
// The design:
//   * one launch for a whole weight: grid (column strips, groups, matrices);
//     an expert stack is one launch with a grid layer per expert;
//   * a block of 256 threads owns a strip of C columns (32, 16 or 8, chosen
//     by the wrapper so that the grid fills the card) of one group; thread t
//     holds column t % C and every (256 / C)-th row of the group, so each
//     row's strip is one coalesced load of a warp;
//   * pass 1: each thread's absmax as the largest |w| bit pattern (unsigned
//     compare of the sign-cleared bits: a NaN beats every number, as the
//     reference's max keeps a NaN, and then `absmax > 0` is false, so the
//     scale is 1), reduced over the strip's row lanes in shared memory;
//   * pass 2 over the same rows (mostly from L2): the arithmetic above with
//     __fdiv_rn / __fmul_rn / __fsub_rn / __fadd_rn, so no FMA contraction
//     and IEEE division (the build has no --use_fast_math).
// The second read of the weight is the cost of one launch; two launches (a
// reduction, then an elementwise pass) would read it twice too.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// an f32 value rounded to T (round to nearest even), back in f32
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// onto the FP4 E2M1 grid: the index of the nearest value is the count of
// midpoints below |x| (ties: below or at, whichever count is even)
__device__ __forceinline__ float fp4_round(float x) {
  if (isnan(x)) return -0.0f;
  const float mag = fabsf(x);
  const float mids[7] = {0.25f, 0.75f, 1.25f, 1.75f, 2.5f, 3.5f, 5.0f};
  int lo = 0, hi = 0;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    lo += mids[i] < mag;
    hi += mids[i] <= mag;
  }
  const int idx = (lo & 1) ? hi : lo;         // never past 7
  const float m4 = idx < 2 ? 0.5f * idx
                           : ldexpf(1.0f + 0.5f * (idx & 1), (idx >> 1) - 1);
  return signbit(x) ? -m4 : m4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fake_quant_fp4_kernel(const T* __restrict__ w, T* __restrict__ out, int k, int n, int g,
                      int cols) {
  __shared__ uint32_t red[kThreads];
  const int tid = threadIdx.x;
  const int c = tid % cols;
  const int lanes = kThreads / cols;           // row lanes of the strip
  const int r = tid / cols;
  const int col = blockIdx.x * cols + c;
  const int row0 = blockIdx.y * g;
  const long long base = static_cast<long long>(blockIdx.z) * k * n;
  const bool live = col < n;

  uint32_t m = 0u;
  if (live) {
#pragma unroll 4
    for (int i = row0 + r; i < row0 + g; i += lanes) {
      const uint32_t bits = __float_as_uint(load(w + base + static_cast<long long>(i) * n + col))
                            & 0x7fffffffu;
      m = bits > m ? bits : m;
    }
  }
  red[tid] = m;
  __syncthreads();
  for (int s = lanes / 2; s > 0; s /= 2) {
    if (r < s) {
      const uint32_t o = red[tid + s * cols];
      if (o > red[tid]) red[tid] = o;
    }
    __syncthreads();
  }
  if (!live) return;
  const float absmax = __uint_as_float(red[c]);
  const float scale = absmax > 0.0f ? __fdiv_rn(absmax, 6.0f) : 1.0f;
#pragma unroll 4
  for (int i = row0 + r; i < row0 + g; i += lanes) {
    const long long off = base + static_cast<long long>(i) * n + col;
    const float v = load(w + off);
    const float q = fp4_round(__fdiv_rn(v, scale));
    const float d = round_to(__fsub_rn(__fmul_rn(q, scale), v), w);
    store(out + off, __fadd_rn(v, d));
  }
}

}  // namespace

// w, out: (b, k, n) contiguous, bf16 (is_bf16 = 1) or f32, out not aliasing
// w; g: rows per scale group, dividing k; cols: the strip width, 8, 16 or
// 32. Grid (ceil(n / cols), k / g, b), 256 threads. Returns
// cudaGetLastError().
extern "C" int fake_quant_fp4_launch(const void* w, void* out, int b, int k, int n, int g,
                                     int cols, int is_bf16, void* stream) {
  if (b < 1 || b > 65535 || k < 1 || n < 1 || g < 1 || k % g || k / g > 65535
      || (cols != 8 && cols != 16 && cols != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + cols - 1) / cols, k / g, b);
  if (is_bf16)
    fake_quant_fp4_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out), k, n, g, cols);
  else
    fake_quant_fp4_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(w), static_cast<float*>(out), k, n, g, cols);
  return static_cast<int>(cudaGetLastError());
}
