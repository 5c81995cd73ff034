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
// What bounds it on an H100: bytes. A call must read the weight once and
// write it once, 4 bytes an element in bf16, with some 30 instructions an
// element. The design (the launch plan is kernels/fake_quant.py, `plan`):
//   * an item is a strip of C columns of one group of one matrix; a
//     thread-block cluster of S <= 8 blocks (portable) takes it, each block
//     `rows` consecutive rows of the group (a group taller than one block's
//     slab is split so), and the clusters walk the items persistently, as
//     many clusters as fit on the card at once (an expert stack is one
//     launch: its matrices are more items);
//   * a block's slab of an item is read from device memory once, into
//     shared memory, by 16-byte cp.async copies (8 bf16 or 4 f32 columns;
//     a row that is not 16-byte aligned takes one element a copy), into
//     one of two buffers: the next item's copies are in flight while the
//     block works on this one, so loads, arithmetic and stores overlap;
//   * a group taller than a cluster's slabs hold (over 16,384 rows: the
//     down projections of nemotron4-15b and qwen2.5-32b at group 0) is
//     walked in `chunks` chunks of a block's rows, through the same two
//     buffers: once for the absmax, then again for the output, so such a
//     group alone is read twice;
//   * a thread owns vector column cv of the strip and rows r, r + lanes, ...
//     of the slab, and reads them back from the buffer where it put them;
//   * the absmax is the largest sign-cleared bit pattern (unsigned compare:
//     a NaN beats every number, as the reference's max keeps a NaN, and then
//     `absmax > 0` is false, so the scale is 1), reduced over the warp's
//     row lanes by shuffles, over the block's warps in shared memory and
//     over the cluster's blocks through distributed shared memory: after a
//     cluster barrier each block reads every rank's maxima (two alternating
//     arrays, so the next item's maxima never overwrite ones still read; a
//     group one block holds alone needs no cluster barrier); one thread a
//     column then divides out its scale for the others;
//   * the arithmetic is __fdiv_rn / __fmul_rn / __fsub_rn / __fadd_rn, so no
//     FMA contraction and IEEE division (the build has no --use_fast_math).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 64;        // the widest strip: 8 threads x 8 bf16 columns
constexpr int kMaxCluster = 8;
constexpr int kMaxLoads = 64;       // copies a thread an item: 16 of 16 bytes, 64 of one element
constexpr int kMaxSmem = 2 * 16 * kThreads * 16;   // two buffers at most: 128 KB

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// one V-element segment of a strip row, global -> shared, read once; zero
// where `ok` is false. 16 bytes go by cp.async (bypassing L1; L2 fetches
// the 128-byte line, whose other segments the clusters on the neighbouring
// strips read at about the same time), as does a 4-byte f32; a 2-byte bf16
// has no cp.async and is copied through a register
template <typename T, int V>
__device__ __forceinline__ void copy_in(Vec<T, V>* dst, const T* src, bool ok) {
  if constexpr (sizeof(T) * V == 16 || sizeof(T) * V == 4) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    if constexpr (sizeof(T) * V == 16)
      asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n"
                   :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
  } else {
    dst->v[0] = ok ? src[0] : T(0.0f);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T, int V>
__device__ __forceinline__ void store_once(T* p, const Vec<T, V>& r) {
  if constexpr (sizeof(T) * V == 16) {
    uint4 u;
    memcpy(&u, &r, 16);
    __stcs(reinterpret_cast<uint4*>(p), u);
  } else {
    p[0] = r.v[0];
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float& d, float v) { d = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16& d, float v) { d = __float2bfloat16_rn(v); }

// an f32 value rounded to T (round to nearest even), back in f32
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// onto the FP4 E2M1 grid {0, .5, 1, 1.5, 2, 3, 4, 6}. core/quant.py defines
// it by counting the midpoints below |x| (a tie takes the even code); this is
// the same function in fewer instructions: the grid's step is 1/2 below 2, 1
// in [2, 4) and 2 from 4, its even codes are the even multiples of the step,
// and adding c = step * 2^23 (where the f32 spacing is the step) rounds
// |x| <= 6 to a multiple of the step, ties to the even multiple; subtracting
// c again is exact. c is 2^22 times the binade of max(|x|, 1).
__device__ __forceinline__ float fp4_round(float x) {
  const float m = fminf(fabsf(x), 6.0f);                // NaN: replaced below
  const float c = __uint_as_float((__float_as_uint(fmaxf(m, 1.0f)) & 0x7f800000u)
                                  + (22u << 23));
  const float r = __fsub_rn(__fadd_rn(m, c), c);
  return isnan(x) ? -0.0f : copysignf(r, x);
}

// The launch's geometry: `tpr` threads a strip row of V-element segments,
// lanes = 256 / tpr rows at a time, `loads` segments a thread a chunk (so a
// chunk is at most loads * lanes rows), `chunks` chunks a block's `rows`
// rows; items are (strip, group, matrix), strips fastest, so the clusters at
// work at one time read neighbouring strips of the same rows
struct Geometry {
  int k, n, g, groups, strips, items, tpr, rows, loads, chunks;
};

// the absmax of a segment's columns as sign-cleared bits, packed as the
// segment is: an f32 a word, two bf16 a word (their bits order as their
// magnitudes, so a per-half unsigned max is the max), one bf16 a word
template <typename T, int V>
constexpr int kWords = sizeof(T) == 4 ? V : (V + 1) / 2;

template <typename T>
__device__ __forceinline__ uint32_t word_max(uint32_t a, uint32_t b) {
  if constexpr (sizeof(T) == 4) return max(a, b);
  else return __vmaxu2(a, b);
}

template <typename T, int V>
__device__ __forceinline__ void absmax_update(uint32_t (&m)[kWords<T, V>], const Vec<T, V>& x) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < V; ++j) m[j] = max(m[j], __float_as_uint(x.v[j]) & 0x7fffffffu);
  } else if constexpr (V % 2 == 0) {
    uint32_t wd[V / 2];
    memcpy(wd, &x, sizeof(wd));
#pragma unroll
    for (int i = 0; i < V / 2; ++i) m[i] = __vmaxu2(m[i], wd[i] & 0x7fff7fffu);
  } else {
    m[0] = max(m[0], static_cast<uint32_t>(__bfloat16_as_ushort(x.v[0]) & 0x7fffu));
  }
}

// column j's absmax as f32 bits
template <typename T, int V>
__device__ __forceinline__ uint32_t column_bits(const uint32_t (&m)[kWords<T, V>], int j) {
  if constexpr (sizeof(T) == 4) return m[j];
  else return (j & 1) ? (m[j >> 1] & 0xffff0000u) : (m[j >> 1] << 16);
}

// w + round(qdq(w) - w) for one segment; bf16 pairs round through one packed
// conversion (each half rounded to nearest even, as one at a time)
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> fake_quant_segment(const Vec<T, V>& x,
                                                        const float (&scale)[V]) {
  Vec<T, V> o;
  if constexpr (sizeof(T) == 2 && V % 2 == 0) {
#pragma unroll
    for (int j = 0; j < V; j += 2) {
      const float v0 = to_f32(x.v[j]), v1 = to_f32(x.v[j + 1]);
      const float q0 = fp4_round(__fdiv_rn(v0, scale[j]));
      const float q1 = fp4_round(__fdiv_rn(v1, scale[j + 1]));
      const float2 d = __bfloat1622float2(__floats2bfloat162_rn(
          __fsub_rn(__fmul_rn(q0, scale[j]), v0), __fsub_rn(__fmul_rn(q1, scale[j + 1]), v1)));
      const __nv_bfloat162 r = __floats2bfloat162_rn(__fadd_rn(v0, d.x), __fadd_rn(v1, d.y));
      o.v[j] = r.x;
      o.v[j + 1] = r.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float v = to_f32(x.v[j]);
      const float q = fp4_round(__fdiv_rn(v, scale[j]));
      const float d = round_to(__fsub_rn(__fmul_rn(q, scale[j]), v), x.v[j]);
      from_f32(o.v[j], __fadd_rn(v, d));
    }
  }
  return o;
}

// grid (S, clusters), cluster (S, 1, 1): block rank q of cluster c holds
// rows [q * rows, min(g, (q + 1) * rows)) of items c, c + clusters, ...;
// dynamic shared memory: two buffers of loads x 256 segments. A block copies
// each item's slab in one chunk, or, with chunks > 1, in `chunks` chunks
// twice over (the absmax pass, then the output pass): a sequence of copies
// that alternate between the buffers, the next one in flight while the block
// works on this one (CHUNKED is chunks > 1: the one-chunk walk compiles
// without the chunk arithmetic). A cluster's blocks walk the same items, so
// they meet at every cluster barrier
template <typename T, int V, bool CHUNKED>
__global__ void __launch_bounds__(kThreads)
fake_quant_fp4_kernel(const T* __restrict__ w, T* __restrict__ out, const Geometry geo) {
  extern __shared__ uint4 smem4[];
  Vec<T, V>* const buf0 = reinterpret_cast<Vec<T, V>*>(smem4);
  __shared__ uint32_t warp_max[kWarps][kMaxCols];
  __shared__ uint32_t block_max[2][kMaxCols];
  __shared__ float col_scale[kMaxCols];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tpr = geo.tpr, n = geo.n, g = geo.g, loads = geo.loads;
  const int chunks = CHUNKED ? geo.chunks : 1;
  const int cols = tpr * V;
  const int lanes = kThreads / tpr;
  const int chunk_rows = loads * lanes;
  const int cv = tid % tpr;
  const int r = tid / tpr;
  const int lo = blockIdx.x * geo.rows + r;     // this thread's first row of the group
  const int hi = min(g, (blockIdx.x + 1) * geo.rows);
  const int ranks = static_cast<int>(cluster.num_blocks());
  const bool remote = ranks > 1;
  const int stride = gridDim.y;
  // copies of an item's slab: one, or the chunks twice over
  const int copies = CHUNKED ? 2 * chunks : 1;

  // the item's first element for this thread (row lo, column col), and col
  auto locate = [&](int item, int& col) {
    const int strip = item % geo.strips, zb = item / geo.strips;
    col = strip * cols + cv * V;
    return (static_cast<long long>(zb / geo.groups) * geo.k
            + static_cast<long long>(zb % geo.groups) * g + lo) * n + col;
  };
  // chunk c of an item's slab, into buf
  auto issue = [&](int item, int c, Vec<T, V>* buf) {
    int col;
    const T* src = w + locate(item, col) + static_cast<long long>(c) * chunk_rows * n;
    const bool live = col < n;                   // a segment lies wholly in or out
    const int base = lo + c * chunk_rows;
    for (int p = 0; p < loads; ++p) {
      const bool ok = live && base + p * lanes < hi;
      copy_in<T, V>(buf + p * kThreads + tid, ok ? src + static_cast<long long>(p) * lanes * n
                                                 : w, ok);
    }
    cp_async_commit();
  };

  if (blockIdx.y < geo.items) issue(blockIdx.y, 0, buf0);
  uint32_t m[kWords<T, V>];
  int walked = 0;                                // chunked: copies walked
  int it = 0;
  for (int item = blockIdx.y; item < geo.items; item += stride, ++it) {
    for (int j = 0; j < copies; ++j) {
      const int c = j % chunks;
      const int t = CHUNKED ? walked++ : it;       // the buffer's parity
      Vec<T, V>* const buf = buf0 + (t & 1) * loads * kThreads;
      Vec<T, V>* const next = buf0 + ((t + 1) & 1) * loads * kThreads;
      cp_async_wait_all();                       // this copy (this thread's) landed
      __syncthreads();                           // ... everyone's; the last one is done
      if (j + 1 < copies)                        // the next copy flies meanwhile
        issue(item, (j + 1) % chunks, next);
      else if (item + stride < geo.items)
        issue(item + stride, 0, next);

      if (j < chunks) {                          // the absmax pass
        if (j == 0) {
#pragma unroll
          for (int i = 0; i < kWords<T, V>; ++i) m[i] = 0u;
        }
        for (int p = 0; p < loads; ++p) absmax_update<T, V>(m, buf[p * kThreads + tid]);
      }
      if (j == chunks - 1) {
        uint32_t mw[kWords<T, V>];
        // over the warp's row lanes (lanes tpr apart hold the same columns) ...
#pragma unroll
        for (int i = 0; i < kWords<T, V>; ++i) {
          mw[i] = m[i];
          for (int off = tpr; off < 32; off <<= 1)
            mw[i] = word_max<T>(mw[i], __shfl_xor_sync(0xffffffffu, mw[i], off));
        }
        if (lane < tpr) {
#pragma unroll
          for (int jj = 0; jj < V; ++jj)
            warp_max[tid >> 5][cv * V + jj] = column_bits<T, V>(mw, jj);
        }
        __syncthreads();
        // ... over the block's warps ...
        uint32_t* const bmax = block_max[it & 1];
        if (tid < cols) {
          uint32_t b = warp_max[0][tid];
#pragma unroll
          for (int i = 1; i < kWarps; ++i) b = max(b, warp_max[i][tid]);
          bmax[tid] = b;
        }
        // ... and over the cluster's blocks, through distributed shared memory
        if (remote) cluster.sync();
        if (tid < cols) {
          uint32_t b = bmax[tid];
          if (remote)
            for (int q = 0; q < ranks; ++q) b = max(b, *cluster.map_shared_rank(bmax + tid, q));
          const float a = __uint_as_float(b);    // the scale, once a column
          col_scale[tid] = a > 0.0f ? __fdiv_rn(a, 6.0f) : 1.0f;
        }
        __syncthreads();
      }

      if (!CHUNKED || j >= chunks) {             // the output pass
        int col;
        T* const dst = out + locate(item, col) + static_cast<long long>(c) * chunk_rows * n;
        const int base = lo + c * chunk_rows;
        if (col < n) {
          float scale[V];
#pragma unroll
          for (int jj = 0; jj < V; ++jj) scale[jj] = col_scale[cv * V + jj];
          for (int p = 0; p < loads && base + p * lanes < hi; ++p)
            store_once<T, V>(dst + static_cast<long long>(p) * lanes * n,
                             fake_quant_segment<T, V>(buf[p * kThreads + tid], scale));
        }
      }
    }
  }
  if (remote) cluster.sync();                    // none leaves while another reads its maxima
}

// 2 buffers of `loads` segments for each of the 256 threads
template <typename T, int V>
size_t smem_bytes(int loads) {
  return 2 * static_cast<size_t>(loads) * kThreads * sizeof(Vec<T, V>);
}

// the clusters of s blocks that fit on the card at once with this shared
// memory (the runtime's occupancy count, cached per shape of launch)
template <typename T, int V, bool CHUNKED>
int active_clusters(int s, int loads) {
  static int cache[kMaxCluster + 1][kMaxLoads + 1] = {};
  static bool attr_set = false;
  if (!attr_set) {
    if (cudaFuncSetAttribute(fake_quant_fp4_kernel<T, V, CHUNKED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem) != cudaSuccess)
      return 0;
    attr_set = true;
  }
  int& c = cache[s][loads];
  if (c == 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(s, 1, 1);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem_bytes<T, V>(loads);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = s;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int num = 0;
    if (cudaOccupancyMaxActiveClusters(&num, fake_quant_fp4_kernel<T, V, CHUNKED>, &cfg)
            != cudaSuccess || num < 1)
      return 0;
    c = num;
  }
  return c;
}

// launches as many clusters as fit (at most one an item); *fit receives
// that number
template <typename T, int V, bool CHUNKED>
int launch(const void* w, void* out, const Geometry& geo, int s, int* fit, cudaStream_t stream) {
  const int clusters = active_clusters<T, V, CHUNKED>(s, geo.loads);
  if (fit != nullptr) *fit = clusters;
  if (clusters == 0) {
    const cudaError_t e = cudaGetLastError();
    return static_cast<int>(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(s, min(clusters, geo.items), 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes<T, V>(geo.loads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = s;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, fake_quant_fp4_kernel<T, V, CHUNKED>,
                                           static_cast<const T*>(w), static_cast<T*>(out), geo);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T, int V>
int launch_chunked_or_not(const void* w, void* out, const Geometry& geo, int s, int* fit,
                          cudaStream_t stream) {
  return geo.chunks > 1 ? launch<T, V, true>(w, out, geo, s, fit, stream)
                        : launch<T, V, false>(w, out, geo, s, fit, stream);
}

}  // namespace

// w, out: (b, k, n) contiguous, bf16 (is_bf16 = 1) or f32, out not aliasing
// w; g: rows per scale group, dividing k. The plan (kernels/fake_quant.py):
// vec elements a copy (16 bytes' worth, with n * element size and both
// pointers 16-byte aligned, else 1), tpr threads a strip row (strip width
// tpr * vec <= 64 columns; 2, 4 or 8 threads with vec > 1, 8, 16 or 32 with
// vec = 1), a cluster of s <= 8 blocks over each group, `rows` rows a block
// (s * rows >= g > (s - 1) * rows), `loads` copies a thread a chunk and
// `chunks` chunks a block (256 / tpr * loads * chunks >= rows; one chunk
// reads the weight once, more read their groups twice). As many clusters
// are launched as fit on the
// card at once (the runtime's occupancy count), or one an item where there
// are fewer items; *fit, where not null, receives that number. Returns the
// launch's CUDA error code (0: launched).
extern "C" int fake_quant_fp4_launch(const void* w, void* out, int b, int k, int n, int g,
                                     int vec, int tpr, int s, int rows, int loads, int chunks,
                                     int is_bf16, int* fit, void* stream) {
  const int v_full = is_bf16 ? 8 : 4;
  const int cols = tpr * vec;
  if (b < 1 || k < 1 || n < 1 || g < 1 || k % g || (vec != 1 && vec != v_full) || tpr < 1
      || tpr > 32 || 32 % tpr || cols > kMaxCols || (vec > 1 && n % vec) || s < 1
      || s > kMaxCluster || rows < 1 || loads < 1 || loads > (vec > 1 ? 16 : kMaxLoads)
      || chunks < 1 || static_cast<long long>(s) * rows < g
      || static_cast<long long>(s - 1) * rows >= g
      || static_cast<long long>(kThreads / tpr) * loads * chunks < rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long strips = (n + cols - 1) / cols;
  const long long items = strips * (k / g) * b;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry geo{k, n, g, k / g, static_cast<int>(strips), static_cast<int>(items), tpr,
                     rows, loads, chunks};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return vec > 1 ? launch_chunked_or_not<__nv_bfloat16, 8>(w, out, geo, s, fit, st)
                   : launch_chunked_or_not<__nv_bfloat16, 1>(w, out, geo, s, fit, st);
  return vec > 1 ? launch_chunked_or_not<float, 4>(w, out, geo, s, fit, st)
                 : launch_chunked_or_not<float, 1>(w, out, geo, s, fit, st);
}
