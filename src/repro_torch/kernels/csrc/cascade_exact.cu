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
// What bounds it on an H100: the order of the FP8 truncations is the
// semantics, so nothing is split along K: each output is a K-long chain of
// dependent steps, and the only parallelism is across the M * N outputs. A
// call takes at least K steps of at least two dependent operations each
// (the add, then one that cuts the sum to FP8: no instruction of the card
// does both) at one operation's latency (few outputs), or the M * N * K
// steps' instructions at the card's issue rate (many), or the bytes. The
// design (the launch plan is kernels/cascade_exact.py, `plan`):
//   * a thread owns one column and R consecutive rows (R = 1, 2, 4 or 8, by
//     M): R independent chains, each in order over K in one thread; a warp
//     is 32 columns of the same rows, a block `warps` such row groups over
//     the same 32 columns, so every w element a block stages serves all of
//     its rows;
//   * w's (KT k x 32 columns) tiles and the block's x rows (rows x KT k)
//     are staged in shared memory through a ring of 4 stages filled by
//     cp.async (4-byte copies, zero-filled past the edges, so any K, N and
//     alignment): three tiles are in flight while the chains walk the
//     fourth; w is read as a conflict-free row of the tile, x as a 16-byte
//     broadcast of 4 k a row; KT is 64 k where a block holds at most 16
//     rows (few chains: fewer barriers a step), else 32 (CE_KT_FEW,
//     CE_KT_MANY and CE_STAGES set them at build time);
//   * the step has no branch: the saturation is max.NaN / min.NaN (a NaN
//     comes out as the card's canonical NaN, as the step's add already made
//     it), and of the two candidates, the 2^-9-step truncation and the
//     3-bit mantissa cut, the one of smaller magnitude is the right one on
//     either side of 2^-6 (the coarser grid truncates further), which for
//     two values of one sign is the smaller bit pattern: one unsigned min.
//     Every other operation is one IEEE f32 operation (__fmul_rn, __fadd_rn,
//     truncf) or a bit mask, so no FMA contraction; trunc(s * 2^9) * 2^-9
//     is exact.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the tile geometry (scripts/qat_kernels_sweep.py --ce-tiles rebuilds with
// others): k steps a tile where a block holds at most 16 rows, and above;
// tiles in the ring
#ifndef CE_KT_FEW
#define CE_KT_FEW 64
#endif
#ifndef CE_KT_MANY
#define CE_KT_MANY 32
#endif
#ifndef CE_STAGES
#define CE_STAGES 4
#endif

constexpr int kCols = 32;      // columns a block: one a lane
constexpr int kStages = CE_STAGES;
constexpr int kMaxWarps = 8;

__device__ __forceinline__ float truncate_mantissa(float x, uint32_t mask) {
  return __uint_as_float(__float_as_uint(x) & mask);
}

// the bias's FP8 value, once a column (the input's NaN payload kept as
// jnp.clip keeps it)
__device__ __forceinline__ float fp8_e4m3_truncate(float x) {
  const float sat = x > 448.0f ? 448.0f : (x < -448.0f ? -448.0f : x);
  if (fabsf(sat) < 0.015625f)                                        // 2^-6
    return __fmul_rn(truncf(__fmul_rn(sat, 512.0f)), 0.001953125f);  // 2^-9 steps
  return truncate_mantissa(sat, 0xFFF00000u);                        // 3 mantissa bits
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// one step of a chain: acc = fp8(acc + fp5(x * w)), branch-free
__device__ __forceinline__ float cascade_step(float acc, float x, float w) {
  const float p = truncate_mantissa(__fmul_rn(x, w), 0xFFC00000u);   // 1 mantissa bit
  const float s = min_nan(max_nan(__fadd_rn(acc, p), -448.0f), 448.0f);
  const uint32_t sub = __float_as_uint(__fmul_rn(truncf(__fmul_rn(s, 512.0f)), 0.001953125f));
  return __uint_as_float(min(sub, __float_as_uint(s) & 0xFFF00000u));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// grid (ceil(n / 32), ceil(m / (warps * R))), block 32 * warps threads;
// dynamic shared memory: kStages x [w tile (KT x kCols), x tile
// (warps * R rows x KT)]; KT k steps a tile
template <int R, int KT>
__global__ void __launch_bounds__(kMaxWarps * 32)
cascade_matmul_exact_kernel(const float* __restrict__ x, const float* __restrict__ w,
                            const float* __restrict__ bias, float* __restrict__ out, int m,
                            int k, int n) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int warps = blockDim.x / 32;
  const int bm = warps * R;                      // the block's rows
  const int stage_floats = KT * kCols + bm * KT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * kCols + lane;
  const int row0 = blockIdx.y * bm;
  const int tiles = (k + KT - 1) / KT;

  // a warp copies tile rows warp, warp + warps, ...: of w 32 columns (one a
  // lane), of x 32 k steps (one a lane) at a time
  auto load_tile = [&](int t) {
    float* const ws = smem + (t % kStages) * stage_floats;
    float* const xs = ws + KT * kCols;
    const int k0 = t * KT;
    for (int kk = warp; kk < KT; kk += warps) {
      const bool ok = col < n && k0 + kk < k;
      cp_async4(ws + kk * kCols + lane, ok ? w + static_cast<long long>(k0 + kk) * n + col : w,
                ok);
    }
    for (int rr = warp; rr < bm; rr += warps) {
      const float* const xr = x + static_cast<long long>(row0 + rr) * k + k0;
#pragma unroll
      for (int kk = lane; kk < KT; kk += 32) {
        const bool ok = row0 + rr < m && k0 + kk < k;
        cp_async4(xs + rr * KT + kk, ok ? xr + kk : x, ok);
      }
    }
  };

  float acc[R];
  const float init = (bias != nullptr && col < n) ? fp8_e4m3_truncate(bias[col]) : 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = init;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < tiles) load_tile(t);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();                // tile t has landed (this thread's copies)
    __syncthreads();                             // ... everyone's; and tile t - 1 is done
    if (t + kStages - 1 < tiles) load_tile(t + kStages - 1);
    cp_async_commit();
    const float* ws = smem + (t % kStages) * stage_floats + lane;
    const float* xs = smem + (t % kStages) * stage_floats + KT * kCols + warp * R * KT;
    const int steps = min(KT, k - t * KT);
    if (steps == KT) {
#pragma unroll
      for (int kk = 0; kk < KT; kk += 4) {
        float4 xv[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          xv[r] = *reinterpret_cast<const float4*>(xs + r * KT + kk);
        const float w0 = ws[(kk + 0) * kCols], w1 = ws[(kk + 1) * kCols];
        const float w2 = ws[(kk + 2) * kCols], w3 = ws[(kk + 3) * kCols];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = cascade_step(acc[r], xv[r].x, w0);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = cascade_step(acc[r], xv[r].y, w1);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = cascade_step(acc[r], xv[r].z, w2);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = cascade_step(acc[r], xv[r].w, w3);
      }
    } else {
      for (int kk = 0; kk < steps; ++kk) {
        const float wv = ws[kk * kCols];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = cascade_step(acc[r], xs[r * KT + kk], wv);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + warp * R + r;
    if (row < m && col < n) out[static_cast<long long>(row) * n + col] = acc[r];
  }
}

// one thread walks `steps` dependent steps from registers (4 operands in
// turn), timing itself with clock64: with ADD false, steps of this kernel's
// chain (one step's latency as compiled); with ADD true, plain f32 adds
// (one operation's latency, the floor of any step)
template <bool ADD>
__global__ void cascade_exact_chain_kernel(const float* __restrict__ x,
                                           const float* __restrict__ w, float* __restrict__ out,
                                           long long* __restrict__ cycles, int steps) {
  const float x0 = x[0], x1 = x[1], x2 = x[2], x3 = x[3];
  const float w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3];
  float acc = 0.0f;
  const long long t0 = clock64();
  if constexpr (ADD) {
#pragma unroll 16
    for (int i = 0; i < steps; i += 4)     // unrolled: the loop's own count hides in the adds
      acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, x0), x1), x2), x3);
  } else {
    for (int i = 0; i < steps; i += 4) {
      acc = cascade_step(acc, x0, w0);
      acc = cascade_step(acc, x1, w1);
      acc = cascade_step(acc, x2, w2);
      acc = cascade_step(acc, x3, w3);
    }
  }
  const long long t1 = clock64();
  out[0] = acc;
  cycles[0] = t1 - t0;
}

// k steps a tile: CE_KT_FEW where a block holds at most 16 rows (the chains
// are few and latency-bound: fewer barriers and copies a step), CE_KT_MANY
// above
template <int R>
int launch(const float* x, const float* w, const float* bias, float* out, int m, int k, int n,
           int warps, cudaStream_t stream) {
  constexpr int kt = R <= 2 ? CE_KT_FEW : CE_KT_MANY;
  const int bm = warps * R;
  const dim3 grid((n + kCols - 1) / kCols, (m + bm - 1) / bm);
  const size_t smem = kStages * (kt * kCols + bm * kt) * sizeof(float);
  static bool attr_set = false;
  if (!attr_set && smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(cascade_matmul_exact_kernel<R, kt>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kStages * (kt * kCols + kMaxWarps * R * kt) * 4);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  cascade_matmul_exact_kernel<R, kt><<<grid, warps * 32, smem, stream>>>(x, w, bias, out, m, k,
                                                                         n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (m, k) f32, w: (k, n) f32, bias: (n,) f32 or null, out: (m, n) f32, all
// contiguous. The plan (kernels/cascade_exact.py): `rows` (R) rows a thread,
// 1, 2, 4 or 8, and `warps` (1-8) row groups a block. Returns
// cudaGetLastError().
extern "C" int cascade_exact_launch(const void* x, const void* w, const void* bias, void* out,
                                    int m, int k, int n, int rows, int warps, void* stream) {
  if (m < 1 || k < 1 || n < 1 || warps < 1 || warps > kMaxWarps
      || (m + warps * rows - 1) / (warps * rows) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 1: return launch<1>(xf, wf, bf, of, m, k, n, warps, s);
    case 2: return launch<2>(xf, wf, bf, of, m, k, n, warps, s);
    case 4: return launch<4>(xf, wf, bf, of, m, k, n, warps, s);
    case 8: return launch<8>(xf, wf, bf, of, m, k, n, warps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// One thread, `steps` (a multiple of 4) dependent steps over x[0..3] and
// w[0..3]: the chain's steps, or with `add` nonzero plain f32 adds of x;
// out[0] the sum, cycles[0] the clock64 cycles the steps took.
extern "C" int cascade_exact_chain_launch(const void* x, const void* w, void* out, void* cycles,
                                          int steps, int add, void* stream) {
  if (steps < 4 || steps % 4) return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  long long* cy = static_cast<long long*>(cycles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (add)
    cascade_exact_chain_kernel<true><<<1, 1, 0, st>>>(xf, wf, of, cy, steps);
  else
    cascade_exact_chain_kernel<false><<<1, 1, 0, st>>>(xf, wf, of, cy, steps);
  return static_cast<int>(cudaGetLastError());
}
