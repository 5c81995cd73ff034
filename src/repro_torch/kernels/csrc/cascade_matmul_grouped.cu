// CASCADE FP4 matmul over E experts at once, for Hopper (sm_90a):
//   out_s[e] (C, N) = x[e] (C, K) bf16 @ dequant(packed_s[e] (K/2, N) uint8,
//                                             scales_s[e] (G, N) f32)
// for the rows below rows[e] (a device int32 per expert: the rows a step
// routed to it); every row at or past rows[e] is an exact zero, whatever x
// holds there. One or two weight stacks s over the same x: the MoE family's
// gate and up projections read one dispatch buffer, in one launch.
//
// Replaces no TPU kernel: the reference's expert_linear_apply
// (src/repro/core/cascade.py) dequantizes every expert and runs one einsum.
//
// What bounds it on an H100: the packed weights of the experts with rows.
// A decode step routes 64 rows over olmoe's 64 experts (about 42 of them get
// one), so x and the outputs are small beside the 1 MB of codes an expert,
// and the least time is those codes over the 3.35 TB/s of device memory. To
// reach it an SM needs some 20-30 KB of loads in flight, on every SM at once,
// and few instructions a weight byte.
//
// The design:
//   * Work only for routed rows. Every block scans rows into a prefix of
//     the experts' m-tiles (16 rows each) in shared memory. An item is
//     (m-tile, stack, 128-column tile); the persistent blocks (as many as
//     fit on the card, two an SM) walk the items with a grid stride. An
//     expert with no row gives no item and reads no byte of its weights; the
//     rows at or past rows[e] are written as zeros, 16 bytes a store where
//     the rows allow, by warps of the same launch.
//   * Bytes in flight. An item streams its weight tile (128 whole columns:
//     128-byte row segments) and its rows of x through a ring of 3 stages
//     of 16 KB of weights in shared memory, by 16-byte cp.async (zero-filled
//     past the edges); the copies of the next 2 stages fly while the warps
//     run one. The ring runs on across items, so a block never drains
//     between them; an item's first group scales are prefetched into L1
//     when it starts, so the flushes at the slice ends find them there.
//   * The sum order of the plain entry (cascade_matmul.cu), so every live
//     row has the bits a per-expert cascade_matmul call gives it: k16 step s
//     goes to K slice s mod 8; a slice sums its steps in increasing s through
//     mma.sync m16n8k16 bf16 with f32 accumulators; its sum is scaled by the
//     column's group scale as the plain entry scales it; the 8 slice sums
//     are added in order from 0.f. The stream runs two slices at a time (a
//     stage holds 8 steps of slices 2p and 2p + 1): warps 0-3 run the even
//     slice, warps 4-7 the odd one, each warp 32 of the 128 columns. At the
//     end of a pair the odd warps hand their sums over through shared
//     memory and the even warps add both, in slice order, to the running
//     sums they carry in registers; so no block-wide reduction is left, and
//     two blocks fit an SM.
//   * The decode: a packed byte (one column's two K rows) is one mma B
//     register, read through a 256-entry table of bf16 pairs built once per
//     block, one copy per lane (a lane reads only its own bank). A lane reads
//     its four columns' bytes as one 32-bit word of the staged tile, whose
//     16-byte chunks are XOR-swizzled by row so the rows a warp reads at once
//     lie in distinct banks; x reaches the A registers by ldmatrix, its
//     16-byte halves swapped every 4 rows, as in the plain entry.
#include "fp4_mma.cuh"

namespace {

using namespace fp4mma;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBN = 128;                 // columns of an item: 32 a warp (4 n-tiles of 8)
constexpr int kBM = 16;                  // the mma's M: the rows of an item
constexpr int kSlices = 8;               // K slices: step s is slice s mod 8
constexpr int kPairs = kSlices / 2;      // slices run two at a time
constexpr int kStages = 3;               // the ring's stages
constexpr int kSteps = 8;                // k16 steps of each of a pair's slices a stage holds
constexpr int kLutBytes = 256 * 32 * 4;  // 256 bf16 pairs, one copy per lane
constexpr int kWStage = 2 * kSteps * 8 * kBN;    // a step is 8 packed rows
constexpr int kXStage = 2 * kSteps * kBM * 32;   // a step is 16 rows of 32 bytes
constexpr int kXchBytes = 4 * 4 * 32 * 16;       // the odd warps' sums: 4 float4 a lane
constexpr int kFixedSmem = kLutBytes + kStages * (kWStage + kXStage) + kXchBytes;
constexpr int kMaxSmem = 232448;         // the H100's dynamic shared memory a block

// Dynamic shared memory of a launch: the table, the ring, the hand-over and
// the prefix of the E experts' m-tiles (E + 1 ints, to a 16-byte multiple).
int smem_for(int E) {
  const long long b = kFixedSmem + ((4LL * (E + 1) + 15) / 16) * 16;
  return b > kMaxSmem ? -1 : static_cast<int>(b);
}

struct Args {
  const __nv_bfloat16* x;
  const uint8_t* packed[2];
  const float* scales[2];
  void* out[2];
  const int* rows;
  int E, C, K, N, group, stacks;
  int tiles;      // 128-column tiles of N
  int steps;      // k16 steps of K
  int chunks;     // stages a slice pair takes
  int vec_w;      // packed rows 16-byte aligned: cp.async, else byte copies
  int vec_x;      // rows of x 16-byte aligned
  int vec_out;    // output rows 16-byte aligned (zero stores), else elements
};

// One item: an expert's 16 rows from m0 and one stack's 128 columns.
struct Item {
  const __nv_bfloat16* x;
  const uint8_t* packed;
  const float* scales;
  void* out;
  int n0, m0, m_end;
};

__device__ __forceinline__ int live_rows(const Args& a, int e) {
  return min(max(__ldg(a.rows + e), 0), a.C);
}

template <typename TO>
__device__ __forceinline__ Item item_at(const Args& a, const int* pre, int i) {
  const int per_mt = a.stacks * a.tiles;
  const int mt = i / per_mt, rem = i - mt * per_mt;
  const int st = rem / a.tiles, tile = rem - st * a.tiles;
  int lo = 0, hi = a.E;                  // pre[lo] <= mt < pre[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (pre[mid] <= mt) lo = mid;
    else hi = mid;
  }
  const size_t e = lo;
  Item it;
  it.x = a.x + e * a.C * a.K;
  // (a select, not an index: a runtime index into the parameters would copy
  // them to local memory)
  it.packed = (st ? a.packed[1] : a.packed[0]) + e * (a.K / 2) * a.N;
  it.scales = (st ? a.scales[1] : a.scales[0]) + e * (a.K / a.group) * a.N;
  it.out = static_cast<TO*>(st ? a.out[1] : a.out[0]) + e * a.C * a.N;
  it.n0 = tile * kBN;
  it.m0 = (mt - pre[lo]) * kBM;
  it.m_end = min(it.m0 + kBM, live_rows(a, lo));
  return it;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where a packed row's 16-byte chunk c lies in its staged row r: the four
// rows a warp reads at once (r & 3 = 0..3) put one warp's two chunks in
// distinct banks.
__device__ __forceinline__ int wchunk(int c, int r) { return c ^ (2 * (r & 3)); }
// Where a row's 16-byte half h of x lies: swapped every 4 rows, so the 8 rows
// of an ldmatrix phase lie in distinct banks.
__device__ __forceinline__ int xhalf(int h, int row) { return h ^ ((row >> 2) & 1); }

// Stage a chunk of a slice pair of an item: steps 2 pair + h + 8 (chunk *
// kSteps + u), h < 2, u < kSteps, in slot h * kSteps + u. Weights: the
// slot's 8 packed rows of the item's 128 columns; x: the slot's 16 rows of
// 32 bytes. Past K, N or the item's rows, zeros.
__device__ __forceinline__ void stage_copy(const Args& a, const Item& it, int pair, int chunk,
                                           uint8_t* ws, uint8_t* xs) {
  const int tid = threadIdx.x;
  const int kp = a.K / 2;
  const int s0 = 2 * pair + kSlices * kSteps * chunk;    // slot 0's step
  if (a.vec_w) {
#pragma unroll
    for (int q = tid; q < 2 * kSteps * 8 * 8; q += kThreads) {
      const int slot = q >> 6, r = (q >> 3) & 7, c = q & 7;
      const int s = s0 + slot / kSteps + kSlices * (slot % kSteps);
      const int pr = 8 * s + r, col = it.n0 + 16 * c;
      const bool ok = s < a.steps && pr < kp && col < a.N;
      const uint8_t* src = ok ? it.packed + (size_t)pr * a.N + col : it.packed;
      cp_async16(ws + slot * (8 * kBN) + r * kBN + (wchunk(c, r) << 4), src, ok ? 16 : 0);
    }
  } else {
    for (int q = tid; q < 2 * kSteps * 8 * kBN; q += kThreads) {
      const int slot = q / (8 * kBN), r = (q / kBN) & 7, cb = q % kBN;
      const int s = s0 + slot / kSteps + kSlices * (slot % kSteps);
      const int pr = 8 * s + r, col = it.n0 + cb;
      const bool ok = s < a.steps && pr < kp && col < a.N;
      ws[slot * (8 * kBN) + r * kBN + (wchunk(cb >> 4, r) << 4) + (cb & 15)] =
          ok ? it.packed[(size_t)pr * a.N + col] : uint8_t(0);
    }
  }
  if (a.vec_x) {
#pragma unroll
    for (int q = tid; q < 2 * kSteps * kBM * 2; q += kThreads) {
      const int slot = q >> 5, row = (q >> 1) & 15, h = q & 1;
      const int s = s0 + slot / kSteps + kSlices * (slot % kSteps);
      const int m = it.m0 + row, k = 16 * s + 8 * h;
      const bool ok = s < a.steps && m < it.m_end && k < a.K;
      const __nv_bfloat16* src = ok ? it.x + (size_t)m * a.K + k : it.x;
      cp_async16(xs + slot * 512 + row * 32 + 16 * xhalf(h, row), src, ok ? 16 : 0);
    }
  } else {
    for (int q = tid; q < 2 * kSteps * kBM * 16; q += kThreads) {
      const int slot = q >> 8, row = (q >> 4) & 15, kk = q & 15;
      const int s = s0 + slot / kSteps + kSlices * (slot % kSteps);
      const int m = it.m0 + row, k = 16 * s + kk;
      const bool ok = s < a.steps && m < it.m_end && k < a.K;
      reinterpret_cast<__nv_bfloat16*>(xs + slot * 512 + row * 32 +
                                       16 * xhalf(kk >> 3, row))[kk & 7] =
          ok ? it.x[(size_t)m * a.K + k] : __float2bfloat16(0.f);
    }
  }
}

// A walk over the block's stages: item k (the block's k-th), slice pair,
// chunk; advanced one stage at a time.
struct Cursor {
  int k, pair, chunk;
  __device__ __forceinline__ void next(int chunks) {
    if (++chunk == chunks) {
      chunk = 0;
      if (++pair == kPairs) {
        pair = 0;
        ++k;
      }
    }
  }
};

template <typename TO, int kMode>
__global__ void __launch_bounds__(kThreads, 2) cascade_matmul_grouped_kernel(const Args a) {
  constexpr bool kMulti = kMode != kOneGroup;
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* lut = reinterpret_cast<uint32_t*>(smem);
  uint8_t* wbuf = smem + kLutBytes;
  uint8_t* xbuf = wbuf + kStages * kWStage;
  float4* xch = reinterpret_cast<float4*>(xbuf + kStages * kXStage);
  int* pre = reinterpret_cast<int*>(xbuf + kStages * kXStage + kXchBytes);
  // the ring is free until the first copy: the scan's warp sums, the table's entries
  int* warp_sum = reinterpret_cast<int*>(wbuf);
  uint32_t* entry = reinterpret_cast<uint32_t*>(wbuf + 64);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;

  // the prefix of the experts' m-tiles (each thread a run of experts), and
  // the table: each entry computed once, then one copy a lane
  {
    const int per = (a.E + kThreads - 1) / kThreads;
    const int e0 = tid * per;
    int local = 0;
    for (int j = 0; j < per; ++j)
      if (e0 + j < a.E) local += (live_rows(a, e0 + j) + kBM - 1) / kBM;
    int incl = local;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    entry[tid] = fp4_pair_bits(tid);
    __syncthreads();
    for (int i = tid; i < 256 * 32; i += kThreads) lut[i] = entry[i >> 5];
    int run = incl - local;
    for (int w = 0; w < warp; ++w) run += warp_sum[w];
    for (int j = 0; j < per && e0 + j < a.E; ++j) {
      pre[e0 + j] = run;
      run += (live_rows(a, e0 + j) + kBM - 1) / kBM;
    }
    if (tid == 0) {
      int total = 0;
      for (int w = 0; w < kWarps; ++w) total += warp_sum[w];
      pre[a.E] = total;
    }
    __syncthreads();
  }
  const int items = pre[a.E] * a.stacks * a.tiles;
  const int mine = items > (int)blockIdx.x ? (items - 1 - (int)blockIdx.x) / gridDim.x + 1 : 0;
  const int total = mine * kPairs * a.chunks;           // the block's stages

  // the producer: stage t's copies into ring slot t % kStages
  Cursor pc{0, 0, 0};
  Item p_it = mine > 0 ? item_at<TO>(a, pre, blockIdx.x) : Item{};
  Item it = p_it;                                       // the consumer's item
  auto fetch = [&](int t) {
    const int slot = t % kStages;
    stage_copy(a, p_it, pc.pair, pc.chunk, wbuf + slot * kWStage, xbuf + slot * kXStage);
    const int k = pc.k;
    pc.next(a.chunks);
    if (pc.k != k && pc.k < mine) p_it = item_at<TO>(a, pre, blockIdx.x + pc.k * gridDim.x);
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < total) fetch(t);
    cp_async_commit();
  }

  // the exact zeros: rows at or past rows[e], one (expert, row) a warp
  {
    const int nw = gridDim.x * kWarps;
    const size_t row_bytes = (size_t)a.N * sizeof(TO);
    for (int q = blockIdx.x * kWarps + warp; q < a.E * a.C; q += nw) {
      const int e = q / a.C, m = q - e * a.C;
      if (m < live_rows(a, e)) continue;
      for (int st = 0; st < a.stacks; ++st) {
        char* row = static_cast<char*>(st ? a.out[1] : a.out[0])
                    + ((size_t)e * a.C + m) * row_bytes;
        if (a.vec_out) {
          for (size_t c = lane; c < row_bytes / 16; c += 32)
            reinterpret_cast<uint4*>(row)[c] = make_uint4(0u, 0u, 0u, 0u);
        } else {
          for (int c = lane; c < a.N; c += 32) reinterpret_cast<TO*>(row)[c] = from_f32<TO>(0.f);
        }
      }
    }
  }

  const int half = warp >> 2;                    // 0: the even slice of a pair, 1: the odd
  const int quarter = warp & 3;                  // columns [32 quarter, 32 quarter + 32)
  const uint32_t* lut_lane = lut + lane;
  const int lr = ((lane >> 3) & 1) * 8 + (lane & 7), lc = lane >> 4;   // ldmatrix row address
  const int xoff = lr * 32 + 16 * xhalf(lc, lr);
  // this lane's 32-bit word (columns 32 quarter + 4 gid .. + 3) of packed
  // rows tig and tig + 4 of a step's 8; n-tile j's B column gid is the
  // warp's column 4 gid + j, and accumulator element e of n-tile j is
  // column 4 (2 tig + e % 2) + j
  const int wcol = 32 * quarter + 4 * gid;
  const int woff0 = tig * kBN + (wchunk(wcol >> 4, tig) << 4) + (wcol & 15);
  const int woff1 = (tig + 4) * kBN + (wchunk(wcol >> 4, tig + 4) << 4) + (wcol & 15);
  const int ccol = 32 * quarter + 8 * tig;       // the first column of this lane's sums
  float4* xch_lane = xch + quarter * 4 * 32 + lane;

  float tot[4][4];                              // the sum of the slices so far (even warps)
  float part[4][4];                             // this slice's partial sums of group g
  float acc[4][4];                              // this slice's scaled sums of groups before g
  int g = 0, g_end = a.group;
  Cursor cc{0, 0, 0};

  // the column scales of group g multiply this slice's partial sums into
  // acc (kMulti), or, with one group, the whole sums in place: fmaf(part,
  // sc, 0) either way for the first group, as the plain entry scales them
  auto flush = [&]() {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = it.n0 + ccol + 4 * e + j;
        const float sc = col < a.N ? __ldg(it.scales + (size_t)g * a.N + col) : 0.f;
        if constexpr (kMulti) {
          acc[j][e] = fmaf(part[j][e], sc, acc[j][e]);
          acc[j][2 + e] = fmaf(part[j][2 + e], sc, acc[j][2 + e]);
          part[j][e] = part[j][2 + e] = 0.f;
        } else {
          part[j][e] = fmaf(part[j][e], sc, 0.f);
          part[j][2 + e] = fmaf(part[j][2 + e], sc, 0.f);
        }
      }
  };
  // one k16 step over the warp's 4 n-tiles: byte j of the lane's words
  auto step = [&](const uint32_t (&av)[4], uint32_t w0, uint32_t w1, uint32_t m01,
                  uint32_t m23) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t b0 = lut_lane[((w0 >> (8 * j)) & 0xFFu) << 5];
      const uint32_t b1 = lut_lane[((w1 >> (8 * j)) & 0xFFu) << 5];
      mma_bf16_16816(part[j], av[0] & m01, av[1] & m01, av[2] & m23, av[3] & m23, b0, b1);
    }
  };
  // step u of this warp's slice in the stage at ws / xs
  auto run_step = [&](const uint8_t* ws, const uint8_t* xs, int slice, int u) {
    const int k0 = 16 * (slice + kSlices * (cc.chunk * kSteps + u));
    const uint8_t* wr = ws + (half * kSteps + u) * (8 * kBN);
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wr + woff0);
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wr + woff1);
    uint32_t av[4];
    ldmatrix_x4(av, xs + (half * kSteps + u) * 512 + xoff);
    if constexpr (kMode != kEdges) {   // a step lies in one group
      if constexpr (kMode == kGroups) {
        if (k0 >= g_end) {
          flush();
          g = k0 / a.group;
          g_end = (g + 1) * a.group;
        }
      }
      step(av, w0, w1, ~0u, ~0u);
    } else {
      const int k_last = min(k0 + 15, a.K - 1);
      if (k_last < g_end) {            // the step lies in group g (steps only go up in K)
        step(av, w0, w1, ~0u, ~0u);
        return;
      }
      for (int gg = k0 / a.group; gg <= k_last / a.group; ++gg) {
        if (gg != g) {
          flush();
          g = gg;
        }
        const uint32_t m01 = pair_mask(k0 + 2 * tig, gg * a.group, (gg + 1) * a.group);
        const uint32_t m23 = pair_mask(k0 + 8 + 2 * tig, gg * a.group, (gg + 1) * a.group);
        step(av, w0, w1, m01, m23);
      }
      g_end = (g + 1) * a.group;
    }
  };

  for (int t = 0; t < total; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                  // stage t landed; slot (t - 1) % kStages is free
    if (t + kStages - 1 < total) fetch(t + kStages - 1);
    cp_async_commit();

    if (cc.pair == 0 && cc.chunk == 0) {
      if (t > 0) it = item_at<TO>(a, pre, blockIdx.x + cc.k * gridDim.x);
      if (it.n0 + ccol < a.N)           // this lane's 8 columns of the first group's scales
        asm volatile("prefetch.global.L1 [%0];" ::"l"(it.scales + it.n0 + ccol));
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[j][e] = 0.f;
    }
    if (cc.chunk == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][e] = acc[j][e] = 0.f;
      g = 0;
      g_end = a.group;
    }
    const uint8_t* ws = wbuf + (t % kStages) * kWStage;
    const uint8_t* xs = xbuf + (t % kStages) * kXStage;
    const int slice = 2 * cc.pair + half;
    const int in_slice = a.steps > slice ? (a.steps - slice + kSlices - 1) / kSlices : 0;
    const int here = min(kSteps, in_slice - cc.chunk * kSteps);
    if (here == kSteps) {
#pragma unroll
      for (int u = 0; u < kSteps; ++u) run_step(ws, xs, slice, u);
    } else {
      for (int u = 0; u < here; ++u) run_step(ws, xs, slice, u);
    }
    if (cc.chunk == a.chunks - 1) {      // the pair ends: add both sums, in slice order
      flush();
      if (half == 1) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          xch_lane[32 * j] = kMulti ? make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3])
                                    : make_float4(part[j][0], part[j][1], part[j][2], part[j][3]);
      }
      __syncthreads();
      if (half == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 o = xch_lane[32 * j];
#pragma unroll
          for (int e = 0; e < 4; ++e) tot[j][e] += kMulti ? acc[j][e] : part[j][e];
          tot[j][0] += o.x;
          tot[j][1] += o.y;
          tot[j][2] += o.z;
          tot[j][3] += o.w;
        }
        if (cc.pair == kPairs - 1) {     // the item ends: its live rows
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            const int m = it.m0 + gid + 8 * rh;
            if (m >= it.m_end) continue;
            TO* orow = static_cast<TO*>(it.out) + (size_t)m * a.N;
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int col = it.n0 + ccol + 4 * e + j;
                if (col < a.N) orow[col] = from_f32<TO>(tot[j][2 * rh + e]);
              }
          }
        }
      }
    }
    cc.next(a.chunks);
  }
  cp_async_wait<0>();
}

using KernelFn = void (*)(const Args);

template <typename TO>
KernelFn kernel_mode(int mode) {
  return mode == kOneGroup ? cascade_matmul_grouped_kernel<TO, kOneGroup>
         : mode == kGroups ? cascade_matmul_grouped_kernel<TO, kGroups>
                           : cascade_matmul_grouped_kernel<TO, kEdges>;
}

// The blocks of the kernel for (out_bf16, mode) that fit an SM at smem bytes
// (the runtime's occupancy count, cached per instantiation and
// shared-memory size), and the card's SMs; 0 on an error.
int blocks_per_sm(int out_bf16, int mode, int smem, int* sms) {
  struct Fit { bool attr; int smem, blocks; };
  static Fit fit[2][3] = {};
  static int sm_count = 0;
  const KernelFn k = out_bf16 ? kernel_mode<__nv_bfloat16>(mode) : kernel_mode<float>(mode);
  Fit& f = fit[out_bf16 ? 1 : 0][mode];
  if (!f.attr) {
    if (cudaFuncSetAttribute(reinterpret_cast<const void*>(k),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem) != cudaSuccess)
      return 0;
    f.attr = true;
  }
  if (f.smem != smem || f.blocks == 0) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, kThreads, smem) != cudaSuccess)
      return 0;
    f.smem = smem;
    f.blocks = n;
  }
  if (sm_count == 0
      && cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, 0) != cudaSuccess)
    return 0;
  *sms = sm_count;
  return f.blocks;
}

// a CUDA error code for a failed runtime query
int query_error() {
  const cudaError_t e = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
}

// The plan's fields against this build's: column tile, stages, threads and
// shared memory for E; false for any other.
bool plan_ok(int E, int col_tile, int stages, int threads, int smem) {
  return col_tile == kBN && stages == kStages && threads == kThreads && smem == smem_for(E)
         && smem > 0;
}

}  // namespace

// x (E, C, K) row-major bf16; stack s (s < 2; packed1, scales1 and out1 all
// null for one stack): packed_s (E, K/2, N) uint8, scales_s (E, K/group, N)
// f32, out_s (E, C, N), bf16 (out_bf16 = 1) or f32; rows (E,) int32 on the
// device (clamped into [0, C]). K is even and group divides it. The plan
// (kernels/cascade_matmul.py, plan_grouped): col_tile, stages, threads and
// smem_bytes must be this build's for E, and blocks at most the
// blocks that fit on the card at once; any other plan is refused with
// cudaErrorInvalidValue before anything is launched. Returns
// cudaGetLastError() otherwise.
extern "C" int cascade_matmul_grouped_launch(const void* x, const void* packed0,
                                             const void* scales0, void* out0,
                                             const void* packed1, const void* scales1,
                                             void* out1, const void* rows, int E, int C, int K,
                                             int N, int group, int out_bf16, int col_tile,
                                             int stages, int threads, int smem_bytes,
                                             int blocks, void* stream) {
  const bool two = packed1 != nullptr;
  if (x == nullptr || packed0 == nullptr || scales0 == nullptr || out0 == nullptr
      || rows == nullptr || two != (scales1 != nullptr) || two != (out1 != nullptr) || E < 1
      || C < 1 || K < 2 || K % 2 || N < 1 || group < 1 || K % group
      || (long long)E * C > 0x7fffffffLL
      || (long long)E * ((C + kBM - 1) / kBM) * 2 * ((N + kBN - 1) / kBN) > 0x7fffffffLL
      || !plan_ok(E, col_tile, stages, threads, smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  auto al16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; };
  const int esz = out_bf16 ? 2 : 4;
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.packed[0] = static_cast<const uint8_t*>(packed0);
  a.packed[1] = static_cast<const uint8_t*>(two ? packed1 : packed0);
  a.scales[0] = static_cast<const float*>(scales0);
  a.scales[1] = static_cast<const float*>(two ? scales1 : scales0);
  a.out[0] = out0;
  a.out[1] = two ? out1 : out0;
  a.rows = static_cast<const int*>(rows);
  a.E = E;
  a.C = C;
  a.K = K;
  a.N = N;
  a.group = group;
  a.stacks = two ? 2 : 1;
  a.tiles = (N + kBN - 1) / kBN;
  a.steps = (K + 15) / 16;
  a.chunks = ((a.steps + kSlices - 1) / kSlices + kSteps - 1) / kSteps;
  a.vec_w = N % 16 == 0 && al16(packed0) && (!two || al16(packed1));
  a.vec_x = K % 8 == 0 && al16(x);
  a.vec_out = (N * esz) % 16 == 0 && al16(out0) && (!two || al16(out1));
  const int mode = mode_for(K, group);
  int sms = 0;
  const int fit = blocks_per_sm(out_bf16, mode, smem_bytes, &sms);
  if (fit < 1) return query_error();
  if (blocks < 1 || blocks > fit * sms) return static_cast<int>(cudaErrorInvalidValue);
  const KernelFn k = out_bf16 ? kernel_mode<__nv_bfloat16>(mode) : kernel_mode<float>(mode);
  k<<<blocks, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of the kernel for (out_bf16, mode: 0 one scale group, 1 groups
// on the 16-row step, 2 off it) that fit an SM at smem_bytes (the runtime's
// occupancy count), and the card's SMs; returns a CUDA error code (0: both
// written).
extern "C" int cascade_matmul_grouped_occupancy(int out_bf16, int mode, int smem_bytes,
                                                int* blocks_per_sm_out, int* sms_out) {
  if (blocks_per_sm_out == nullptr || sms_out == nullptr || mode < kOneGroup || mode > kEdges
      || smem_bytes < 1 || smem_bytes > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int fit = blocks_per_sm(out_bf16 ? 1 : 0, mode, smem_bytes, sms_out);
  if (fit < 1) return query_error();
  *blocks_per_sm_out = fit;
  return 0;
}
