// CASCADE FP4 matmul for Hopper (sm_90a):
//   y (M, N) = x (M, K) bf16 @ dequant(packed E2M1 (K/2, N) uint8, scales (G, N) f32) + bias
//
// Replaces the TPU kernel cascade_matmul_pallas (src/repro/kernels/
// cascade_matmul.py, body _kernel, nibble decode _decode_fp4_block), in its
// fast mode: FP4 codes are decoded to their exact values, products with the
// bf16 activations are summed in f32, each (group, column) scale multiplies
// that group's partial sum, the bias is added in f32 and the result is cast
// once. Any group size works, odd ones included (a packed byte may straddle
// two groups); the caller gives odd-K weights a zero activation column.
//
// What bounds it on an H100: on the serving path M is the number of live
// slots (8 on decode, 32 on a prefill chunk), far below the ~295 FLOP/byte
// ridge, so the least time is the packed weight stream, K*N/2 bytes per
// call. But at M = 8 the 2*M*K*N f32 FMAs on CUDA cores (67 TFLOP/s) take
// longer than that stream (a first CUDA-core version measured 13x its
// bound), so the kernel runs on tensor cores. Hopper has no FP4 tensor-core
// path; FP4 values are exact in bf16, so:
//   * mma.sync m16n8k16 bf16 with f32 accumulators; packed bytes go straight
//     from a 32-bit load through a 256-entry shared-memory table to the
//     mma's B registers (one byte = one column's two K rows), so weights
//     stay packed in device memory and are never made dense;
//   * each warp issues the loads of 8 k16 steps before it multiplies; 8
//     warps split K and meet in shared memory; rows past M (decode has 8 of
//     the mma's 16) are zeros;
//   * a block owns 32 columns and all K (N = 4096 gives 128 blocks);
//   * the group scale multiplies each group's partial sum; when the group
//     size is no multiple of 16 (kEdges), a k16 step that holds a group edge
//     is issued once per group it touches, with the other groups'
//     activations masked to zero; the serving path (one group) compiles
//     without that code;
//   * M, N and K tails are masked in the kernel.
// wgmma, TMA and split-K are left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                // K slices per block
constexpr int kThreads = 32 * kWarps;
constexpr int kBN = 32;                  // 4 mma n-tiles of 8 per warp
constexpr int kBM = 16;                  // the mma's M
constexpr int kBatch = 8;                // k16 steps whose loads a warp issues together

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// E2M1 code -> exact f32 value: s = bit 3, e = bits 2..1, m = bit 0;
// e > 0 is (1 + m/2) * 2^(e-1), e == 0 is m/2.
__device__ __forceinline__ float fp4_value(uint32_t c) {
  const uint32_t s = (c >> 3) & 1u, e = (c >> 1) & 3u, m = c & 1u;
  const uint32_t mag = e ? (((126u + e) << 23) | (m << 22)) : (m ? (126u << 23) : 0u);
  return __uint_as_float(mag | (s << 31));
}

// Every FP4 value is exact in bf16: the top half of its f32 pattern.
__device__ __forceinline__ uint32_t fp4_bf16_bits(uint32_t c) {
  return __float_as_uint(fp4_value(c)) >> 16;
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Keeps the bf16 halves of an activation pair (K rows k, k + 1) that lie in
// [lo, hi).
__device__ __forceinline__ uint32_t pair_mask(int k, int lo, int hi) {
  return (k >= lo && k < hi ? 0x0000FFFFu : 0u) | (k + 1 >= lo && k + 1 < hi ? 0xFFFF0000u : 0u);
}

// One warp owns 32 columns and every 8th k16 step of K. For mma.m16n8k16 a
// lane (group gid = lane / 4, tig = lane % 4) must supply B rows k0 + 2 tig
// (+1) and k0 + 8 + 2 tig (+1) of one column: exactly one packed byte each.
// The lane loads one 32-bit word (4 adjacent columns) of packed rows
// k0/2 + tig and k0/2 + 4 + tig, so a warp reads 8 whole 32-byte row
// segments, and n-tile j takes byte j of each word: its B column gid is
// weight column n0 + 4 gid + j. A byte maps to its two bf16 values (even
// row low) through a 256-entry table in shared memory.
template <typename TO, bool kEdges>
__global__ void __launch_bounds__(kThreads)
cascade_matmul_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
                      const float* __restrict__ scales, const float* __restrict__ bias,
                      TO* __restrict__ out, int M, int K, int N, int group, int vec) {
  __shared__ uint32_t lut[256];
  __shared__ float red[kWarps][kBM * kBN];   // 16 KB
  for (int i = threadIdx.x; i < 256; i += kThreads)
    lut[i] = fp4_bf16_bits(i & 0xFu) | (fp4_bf16_bits(i >> 4) << 16);
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int kp_total = K / 2;
  const int steps = (K + 15) / 16;
  const int wcol = n0 + 4 * gid;                    // this lane's 4 weight columns
  const bool full_word = vec && (wcol + 4 <= N);
  const int ra = m0 + gid;                          // this lane's two A rows
  const int rb = m0 + gid + 8;

  float acc[4][4];
  float part[4][4];                                 // the partial sum of group g
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = part[j][e] = 0.f;
  int g = 0;
  int g_end = group;

  auto load_word = [&](int r) -> uint32_t {
    if (r >= kp_total) return 0u;
    const uint8_t* row = packed + (size_t)r * N + wcol;
    if (full_word) return __ldg(reinterpret_cast<const uint32_t*>(row));
    uint32_t w = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (wcol + c < N) w |= (uint32_t)__ldg(row + c) << (8 * c);
    return w;
  };
  // two adjacent bf16 activations (K is even, so a pair is all in or all out)
  auto load_x = [&](int row, int k) -> uint32_t {
    if (row >= M || k >= K) return 0u;
    return __ldg(reinterpret_cast<const uint32_t*>(x + (size_t)row * K + k));
  };
  auto flush = [&]() {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + 4 * (2 * tig + e) + j;
        const float sc = col < N ? scales[(size_t)g * N + col] : 0.f;
        acc[j][e] = fmaf(part[j][e], sc, acc[j][e]);
        acc[j][2 + e] = fmaf(part[j][2 + e], sc, acc[j][2 + e]);
        part[j][e] = part[j][2 + e] = 0.f;
      }
  };
  auto step = [&](uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint32_t wa,
                  uint32_t wb) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      mma_bf16_16816(part[j], a0, a1, a2, a3, lut[(wa >> (8 * j)) & 0xFFu],
                     lut[(wb >> (8 * j)) & 0xFFu]);
  };

  for (int s0 = warp; s0 < steps; s0 += kWarps * kBatch) {
    uint32_t wa[kBatch], wb[kBatch], a0[kBatch], a1[kBatch], a2[kBatch], a3[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k0 = 16 * (s0 + u * kWarps);
      const bool live = s0 + u * kWarps < steps;
      wa[u] = live ? load_word(k0 / 2 + tig) : 0u;
      wb[u] = live ? load_word(k0 / 2 + 4 + tig) : 0u;
      a0[u] = live ? load_x(ra, k0 + 2 * tig) : 0u;
      a1[u] = live ? load_x(rb, k0 + 2 * tig) : 0u;
      a2[u] = live ? load_x(ra, k0 + 8 + 2 * tig) : 0u;
      a3[u] = live ? load_x(rb, k0 + 8 + 2 * tig) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k0 = 16 * (s0 + u * kWarps);
      if (k0 >= K) break;
      if constexpr (!kEdges) {           // a step lies in one group
        if (k0 >= g_end) {
          flush();
          g = k0 / group;
          g_end = (g + 1) * group;
        }
        step(a0[u], a1[u], a2[u], a3[u], wa[u], wb[u]);
      } else {
        const int k_last = min(k0 + 15, K - 1);
        if (k_last < g_end) {            // the step lies in group g (steps only go up in K)
          step(a0[u], a1[u], a2[u], a3[u], wa[u], wb[u]);
          continue;
        }
        for (int gg = k0 / group; gg <= k_last / group; ++gg) {
          if (gg != g) {
            flush();
            g = gg;
          }
          const uint32_t m01 = pair_mask(k0 + 2 * tig, gg * group, (gg + 1) * group);
          const uint32_t m23 = pair_mask(k0 + 8 + 2 * tig, gg * group, (gg + 1) * group);
          step(a0[u] & m01, a1[u] & m01, a2[u] & m23, a3[u] & m23, wa[u], wb[u]);
        }
        g_end = (g + 1) * group;
      }
    }
  }
  flush();

#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cl = 4 * (2 * tig + e) + j;
      red[warp][gid * kBN + cl] = acc[j][e];
      red[warp][(gid + 8) * kBN + cl] = acc[j][2 + e];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int m = m0 + i / kBN;
    const int n = n0 + i % kBN;
    if (m >= M || n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][i];
    if (bias != nullptr) s += bias[n];
    out[(size_t)m * N + n] = from_f32<TO>(s);
  }
}

template <typename TO, bool kEdges>
void launch(const void* x, const void* packed, const void* scales, const void* bias,
            void* out, int M, int K, int N, int group, int vec, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  cascade_matmul_kernel<TO, kEdges><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scales), static_cast<const float*>(bias),
      static_cast<TO*>(out), M, K, N, group, vec);
}

}  // namespace

// x: (M, K) row-major bf16; packed: (K/2, N) uint8; scales: (K/group, N)
// f32; bias: (N,) f32 or null; out: (M, N), bf16 (out_bf16 = 1) or f32.
// K is even and group divides it. Returns cudaGetLastError().
extern "C" int cascade_matmul_launch(const void* x, const void* packed, const void* scales,
                                     const void* bias, void* out, int M, int K, int N,
                                     int group, int out_bf16, void* stream) {
  const int vec = (N % 4 == 0) && ((reinterpret_cast<uintptr_t>(packed) & 3u) == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool edges = group % 16 != 0 && group != K;
  if (out_bf16 && !edges)
    launch<__nv_bfloat16, false>(x, packed, scales, bias, out, M, K, N, group, vec, s);
  else if (out_bf16)
    launch<__nv_bfloat16, true>(x, packed, scales, bias, out, M, K, N, group, vec, s);
  else if (!edges)
    launch<float, false>(x, packed, scales, bias, out, M, K, N, group, vec, s);
  else
    launch<float, true>(x, packed, scales, bias, out, M, K, N, group, vec, s);
  return static_cast<int>(cudaGetLastError());
}
