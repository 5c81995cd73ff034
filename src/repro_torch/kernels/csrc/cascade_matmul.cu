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
// What bounds it on an H100: on the serving path M is the number of rows a
// step feeds a layer (8 on decode, 32 on an admission chunk, 40 on a
// speculative verify pass), far below the ~295 FLOP/byte ridge, so the least
// time is the packed weight stream, K*N/2 bytes per call. But at M = 8 the
// 2*M*K*N f32 FMAs on CUDA cores (67 TFLOP/s) take longer than that stream (a
// first CUDA-core version measured 13x its bound), so the kernel runs on
// tensor cores. Hopper has no FP4 tensor-core path; FP4 values are exact in
// bf16, so:
//   * mma.sync m16n8k16 bf16 with f32 accumulators; packed bytes go straight
//     from a 32-bit load through a 256-entry shared-memory table to the
//     mma's B registers (one byte = one column's two K rows), so weights
//     stay packed in device memory and are never made dense;
//   * a block owns 32 columns, all K and up to 64 rows: MT m-tiles of 16
//     rows (a template parameter, chosen by the caller's plan from M alone).
//     Each packed word is loaded and mapped through the table once, then
//     feeds MT products, one per m-tile, so a call with M <= 64 reads each
//     packed byte once (an earlier version took 16 rows a block and streamed
//     the weights once per 16 rows: three times at verify's M = 40). M > 64
//     takes one block row per 64 rows. Weights with more than one scale
//     group keep two sets of sums a row and take at most 2 m-tiles;
//   * each warp issues the loads of a batch of k16 steps before it
//     multiplies (CM_KBATCH<MT> steps, set per MT from an H100 sweep,
//     scripts/cascade_matmul_sweep.py; every step holds 16 bytes of x a
//     lane per m-tile); 8 warps split K and meet in shared memory one m-tile
//     at a time; rows past M are zeros, and an m-tile wholly past M is
//     skipped;
//   * x comes in as one 16-byte load a lane per (step, m-tile), each
//     warp-wide load 16 whole rows of 32 bytes, and reaches the mma's A
//     registers through a per-warp shared-memory slot and ldmatrix.x4 (its
//     two 16-byte halves a row swap places every 4 rows, so the 8 row
//     reads of each ldmatrix phase hit distinct banks). The A values are
//     those of four 4-byte loads a lane, in half the L1 requests;
//   * the group scale multiplies each group's partial sum; when the group
//     size is no multiple of 16 (kEdges), a k16 step that holds a group edge
//     is issued once per group it touches, with the other groups'
//     activations masked to zero; the serving path (one group) compiles
//     without that code;
//   * M, N and K tails are masked in the kernel.
// Every row is summed in one order, fixed by K, N and the group size alone:
// warp w sums k16 steps w, w + 8, w + 16, ... (the batch only groups their
// loads), then the 8 warps are added in order. So a row's bits do not depend
// on M, on its place in the block or on MT: a verify pass's rows round as a
// decode step's.
// Past the weight stream, each block re-reads its rows of x from L2 for every
// 32 columns (x is M*K*2 bytes, read N/32 times), and each k16 step's MT
// products and loads lengthen the block, so a call at M = 40 takes well
// over its M = 8 time (PERF.md), and a grid of few column blocks (N = 1024:
// 32 blocks) leaves most SMs idle. wgmma, TMA, cp.async pipelining, split-K and a
// wider column tile are left for later work.
// The MoE family's grouped expert matmuls have a kernel of their own, over
// the same helpers (fp4_mma.cuh) and the same sum order:
// cascade_matmul_grouped.cu.
#include "fp4_mma.cuh"

// m-tiles of 16 rows a block holds at most (1-4)
#ifndef CM_MAX_MT
#define CM_MAX_MT 4
#endif
// k16 steps whose loads a warp issues together, by the block's m-tiles
#ifndef CM_KBATCH1
#define CM_KBATCH1 4
#endif
#ifndef CM_KBATCH2
#define CM_KBATCH2 6
#endif
#ifndef CM_KBATCH3
#define CM_KBATCH3 4
#endif
#ifndef CM_KBATCH4
#define CM_KBATCH4 4
#endif

namespace {

constexpr int kWarps = 8;                // K slices per block
constexpr int kThreads = 32 * kWarps;
constexpr int kBN = 32;                  // 4 mma n-tiles of 8 per warp
constexpr int kBM = 16;                  // the mma's M: rows of one m-tile
constexpr int kMaxMT = CM_MAX_MT;
constexpr int kMaxMTGroups = kMaxMT < 2 ? kMaxMT : 2;   // more than one scale group
static_assert(kMaxMT >= 1 && kMaxMT <= 4, "CM_MAX_MT must be 1-4");

template <int MT>
__host__ __device__ constexpr int batch_steps() {
  return MT == 1 ? CM_KBATCH1 : MT == 2 ? CM_KBATCH2 : MT == 3 ? CM_KBATCH3 : CM_KBATCH4;
}

using namespace fp4mma;

// One warp owns 32 columns and every 8th k16 step of K. For mma.m16n8k16 a
// lane (group gid = lane / 4, tig = lane % 4) must supply B rows k0 + 2 tig
// (+1) and k0 + 8 + 2 tig (+1) of one column: exactly one packed byte each.
// The lane loads one 32-bit word (4 adjacent columns) of packed rows
// k0/2 + tig and k0/2 + 4 + tig, so a warp reads 8 whole 32-byte row
// segments, and n-tile j takes byte j of each word: its B column gid is
// weight column n0 + 4 gid + j. A byte maps to its two bf16 values (even
// row low) through a 256-entry table in shared memory. The lane's A rows in
// m-tile t (as ldmatrix hands them over) are m0 + 16 t + gid and that + 8.
template <typename TO, int kMode, int MT>
__device__ __forceinline__ void matmul_block(const __nv_bfloat16* __restrict__ x,
                                             const uint8_t* __restrict__ packed,
                                             const float* __restrict__ scales,
                                             const float* __restrict__ bias,
                                             TO* __restrict__ out, int M, int K, int N,
                                             int group, int vec) {
  constexpr int kBatch = batch_steps<MT>();
  constexpr bool kMulti = kMode != kOneGroup;
  __shared__ uint32_t lut[256];
  __shared__ float red[kWarps][kBM * kBN];   // 16 KB: one m-tile's sums at a time
  __shared__ __align__(16) uint32_t xs[kWarps][MT][kBM * 8];   // a warp's x of one k16 step
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * (kBM * MT);
  for (int i = threadIdx.x; i < 256; i += kThreads) lut[i] = fp4_pair_bits(i);
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int live_mt = min(MT, (M - m0 + kBM - 1) / kBM);   // m-tiles with a row below M
  const int kp_total = K / 2;
  const int steps = (K + 15) / 16;
  const int wcol = n0 + 4 * gid;                    // this lane's 4 weight columns
  const bool full_word = vec && (wcol + 4 <= N);
  const bool vec_x = (K % 8 == 0) && ((reinterpret_cast<uintptr_t>(x) & 15u) == 0);
  const int xr = lane >> 1, xc = lane & 1;          // the row and 16-byte half this lane loads
  const int lr = ((lane >> 3) & 1) * 8 + (lane & 7), lc = lane >> 4;   // ldmatrix row address

  float part[MT][4][4];                             // the partial sums of group g
  float acc[kMulti ? MT : 1][4][4];                 // the scaled sums of groups before g
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[t][j][e] = 0.f;
#pragma unroll
  for (int t = 0; t < (kMulti ? MT : 1); ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;
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
  // eight adjacent bf16 activations (K is even, so a pair is all in or all out)
  auto load_x16 = [&](int row, int k) -> uint4 {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row >= M || k >= K) return v;
    const __nv_bfloat16* p = x + (size_t)row * K + k;
    if (vec_x) return __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
    v.x = __ldg(q);
    if (k + 2 < K) v.y = __ldg(q + 1);
    if (k + 4 < K) v.z = __ldg(q + 2);
    if (k + 6 < K) v.w = __ldg(q + 3);
    return v;
  };
  // the column scales of group g multiply its partial sums into acc
  // (kMulti), or, with one group, the whole sums in place: fmaf(part, sc, 0)
  // either way for the first group, as the sums of one row always were
  auto flush = [&]() {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + 4 * (2 * tig + e) + j;
        const float sc = col < N ? scales[(size_t)g * N + col] : 0.f;
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          if constexpr (kMulti) {
            acc[t][j][e] = fmaf(part[t][j][e], sc, acc[t][j][e]);
            acc[t][j][2 + e] = fmaf(part[t][j][2 + e], sc, acc[t][j][2 + e]);
            part[t][j][e] = part[t][j][2 + e] = 0.f;
          } else {
            part[t][j][e] = fmaf(part[t][j][e], sc, 0.f);
            part[t][j][2 + e] = fmaf(part[t][j][2 + e], sc, 0.f);
          }
        }
      }
  };
  // one k16 step: each B fragment is made once and feeds every live m-tile
  auto step = [&](const uint32_t (&a)[MT][4], uint32_t wa, uint32_t wb, uint32_t m01,
                  uint32_t m23) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t b0 = lut[(wa >> (8 * j)) & 0xFFu];
      const uint32_t b1 = lut[(wb >> (8 * j)) & 0xFFu];
#pragma unroll
      for (int t = 0; t < MT; ++t)
        if (MT == 1 || t < live_mt)
          mma_bf16_16816(part[t][j], a[t][0] & m01, a[t][1] & m01, a[t][2] & m23,
                         a[t][3] & m23, b0, b1);
    }
  };

  for (int s0 = warp; s0 < steps; s0 += kWarps * kBatch) {
    uint32_t wa[kBatch], wb[kBatch];
    uint4 xv[kBatch][MT];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k0 = 16 * (s0 + u * kWarps);
      const bool live = s0 + u * kWarps < steps;
      wa[u] = live ? load_word(k0 / 2 + tig) : 0u;
      wb[u] = live ? load_word(k0 / 2 + 4 + tig) : 0u;
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        const bool on = live && (MT == 1 || t < live_mt);
        xv[u][t] = on ? load_x16(m0 + kBM * t + xr, k0 + 8 * xc) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k0 = 16 * (s0 + u * kWarps);
      if (k0 >= K) break;
      uint32_t a[MT][4];
#pragma unroll
      for (int t = 0; t < MT; ++t)
        if (MT == 1 || t < live_mt)
          *reinterpret_cast<uint4*>(&xs[warp][t][xr * 8 + 4 * (xc ^ ((xr >> 2) & 1))]) = xv[u][t];
      __syncwarp();
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        a[t][0] = a[t][1] = a[t][2] = a[t][3] = 0u;
        if (MT == 1 || t < live_mt)
          ldmatrix_x4(a[t], &xs[warp][t][lr * 8 + 4 * (lc ^ ((lr >> 2) & 1))]);
      }
      __syncwarp();
      if constexpr (kMode != kEdges) {   // a step lies in one group
        if constexpr (kMode == kGroups) {
          if (k0 >= g_end) {
            flush();
            g = k0 / group;
            g_end = (g + 1) * group;
          }
        }
        step(a, wa[u], wb[u], ~0u, ~0u);
      } else {
        const int k_last = min(k0 + 15, K - 1);
        if (k_last < g_end) {            // the step lies in group g (steps only go up in K)
          step(a, wa[u], wb[u], ~0u, ~0u);
          continue;
        }
        for (int gg = k0 / group; gg <= k_last / group; ++gg) {
          if (gg != g) {
            flush();
            g = gg;
          }
          const uint32_t m01 = pair_mask(k0 + 2 * tig, gg * group, (gg + 1) * group);
          const uint32_t m23 = pair_mask(k0 + 8 + 2 * tig, gg * group, (gg + 1) * group);
          step(a, wa[u], wb[u], m01, m23);
        }
        g_end = (g + 1) * group;
      }
    }
  }
  flush();

  // the 8 warps' sums of each m-tile meet in shared memory and are added in
  // warp order, one m-tile at a time
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    if (MT > 1 && t >= live_mt) break;   // the same for the whole block
    if (t > 0) __syncthreads();          // the last m-tile's sums are read
    auto store = [&](const float (&sum)[4][4]) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = 4 * (2 * tig + e) + j;
          red[warp][gid * kBN + cl] = sum[j][e];
          red[warp][(gid + 8) * kBN + cl] = sum[j][2 + e];
        }
    };
    if constexpr (kMulti) store(acc[t]);
    else store(part[t]);
    __syncthreads();
    for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
      const int m = m0 + kBM * t + i / kBN;
      const int n = n0 + i % kBN;
      if (m >= M || n >= N) continue;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][i];
      if (bias != nullptr) s += bias[n];
      out[(size_t)m * N + n] = from_f32<TO>(s);
    }
  }
}

template <typename TO, int kMode, int MT>
__global__ void __launch_bounds__(kThreads)
cascade_matmul_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
                      const float* __restrict__ scales, const float* __restrict__ bias,
                      TO* __restrict__ out, int M, int K, int N, int group, int vec) {
  matmul_block<TO, kMode, MT>(x, packed, scales, bias, out, M, K, N, group, vec);
}

template <typename TO, int kMode, int MT>
void launch(const void* x, const void* packed, const void* scales, const void* bias,
            void* out, int M, int K, int N, int group, int vec, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM * MT - 1) / (kBM * MT));
  cascade_matmul_kernel<TO, kMode, MT><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scales), static_cast<const float*>(bias), static_cast<TO*>(out),
      M, K, N, group, vec);
}

template <typename TO, int kMode>
void launch_mt(int mt, const void* x, const void* packed, const void* scales,
               const void* bias, void* out, int M, int K, int N, int group, int vec,
               cudaStream_t s) {
  constexpr int cap = kMode == kOneGroup ? kMaxMT : kMaxMTGroups;
  if (mt == 1) launch<TO, kMode, 1>(x, packed, scales, bias, out, M, K, N, group, vec, s);
  if constexpr (cap >= 2)
    if (mt == 2) launch<TO, kMode, 2>(x, packed, scales, bias, out, M, K, N, group, vec, s);
  if constexpr (cap >= 3)
    if (mt == 3) launch<TO, kMode, 3>(x, packed, scales, bias, out, M, K, N, group, vec, s);
  if constexpr (cap >= 4)
    if (mt == 4) launch<TO, kMode, 4>(x, packed, scales, bias, out, M, K, N, group, vec, s);
}

template <typename TO>
void launch_mode(int mode, int mt, const void* x, const void* packed, const void* scales,
                 const void* bias, void* out, int M, int K, int N, int group, int vec,
                 cudaStream_t s) {
  if (mode == kOneGroup)
    launch_mt<TO, kOneGroup>(mt, x, packed, scales, bias, out, M, K, N, group, vec, s);
  else if (mode == kGroups)
    launch_mt<TO, kGroups>(mt, x, packed, scales, bias, out, M, K, N, group, vec, s);
  else
    launch_mt<TO, kEdges>(mt, x, packed, scales, bias, out, M, K, N, group, vec, s);
}

}  // namespace

// The m-tiles a block holds for M rows: all of M up to the cap (4 m-tiles,
// 64 rows; 2 with more than one scale group).
static int m_tiles_for(int M, int K, int group) {
  const int cap = group == K ? kMaxMT : kMaxMTGroups;
  const int need = (M + kBM - 1) / kBM;
  return need < 1 ? 1 : (need < cap ? need : cap);
}

// x: (M, K) row-major bf16; packed: (K/2, N) uint8; scales: (K/group, N)
// f32; bias: (N,) f32 or null; out: (M, N), bf16 (out_bf16 = 1) or f32.
// K is even and group divides it. m_tiles is the caller's plan of m-tiles a
// block; one that is not m_tiles_for(M, K, group) is refused with
// cudaErrorInvalidValue before anything is launched. Returns
// cudaGetLastError() otherwise.
extern "C" int cascade_matmul_launch(const void* x, const void* packed, const void* scales,
                                     const void* bias, void* out, int M, int K, int N,
                                     int group, int out_bf16, int m_tiles, void* stream) {
  if (m_tiles != m_tiles_for(M, K, group)) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (N % 4 == 0) && ((reinterpret_cast<uintptr_t>(packed) & 3u) == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mode = mode_for(K, group);
  if (out_bf16)
    launch_mode<__nv_bfloat16>(mode, m_tiles, x, packed, scales, bias, out, M, K, N, group,
                               vec, s);
  else
    launch_mode<float>(mode, m_tiles, x, packed, scales, bias, out, M, K, N, group, vec, s);
  return static_cast<int>(cudaGetLastError());
}

// The build's geometry: m-tiles a block at most (one group, more than one),
// then the k16 steps a warp batches at 1, 2, 3 and 4 m-tiles.
extern "C" void cascade_matmul_geometry(int* out) {
  const int g[6] = {kMaxMT, kMaxMTGroups, CM_KBATCH1, CM_KBATCH2, CM_KBATCH3, CM_KBATCH4};
  for (int i = 0; i < 6; ++i) out[i] = g[i];
}
