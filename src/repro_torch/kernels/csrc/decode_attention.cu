// Decode attention for Hopper (sm_90a): one query token per slot against
// one layer's stacked KV cache,
//   out (B, Hq, D) f32 = softmax(where(live, scale * q . k, -1e30)) @ v
// with GQA (kv head = q head / G, G = Hq / Hkv). Key t of row b is live iff
// t <= q_pos[b] (when q_pos is given) and mask[b, t] != 0 (when a mask is
// given); a row with no live key averages v uniformly over all T, as the
// reference's softmax over T equal -1e30 logits does.
//
// Replaces the TPU kernel decode_attention_pallas (src/repro/kernels/
// flash_attention.py, bodies _decode_kernel and _decode_exact_kernel) and
// computes what ref.decode_attention_ref computes.
//
// What bounds it on an H100: the bytes of the live K/V rows. Each live key
// costs 2 * D * 2 bytes (bf16 K and V) for 4 * G * D FLOPs, far below the
// ~295 FLOP/byte the card needs to be bound by arithmetic, so the only way to
// go faster is to read each live byte once, and to keep enough of them in
// flight to cover the memory latency. The design:
//   1. live keys only: with q_pos, a block reads no K/V row past
//      min(q_pos[b] + 1, T); rows past it are zero-filled in shared memory
//      without a read (cp.async with a source size of 0);
//   2. one block per (slot, KV head, T-split) holds all G query heads of the
//      group (up to 8; a larger G takes several head chunks), so each K/V
//      row is read from memory once per KV head, not once per query head.
//      The products are f32 FMAs on the CUDA cores: the work is bound by
//      bytes and G <= 8 rows would mostly multiply padding in a 16-row mma;
//   3. bytes in flight: 4 warps stage tiles of kKT keys of K and V (rows
//      padded by 16 bytes, so column reads are free of bank conflicts) in a
//      ring of kStages buffers with 16-byte cp.async; K and V of a tile are
//      one commit group, and kStages - 1 tiles stay in flight while the
//      current one is scored. The online max, the denominator and the
//      accumulator stay in f32 registers;
//   4. split T (flash-decoding): the wrapper picks a number of splits from
//      the shapes alone (never from q_pos, so nothing syncs and the call
//      can be captured in a CUDA graph). With one split the block writes the
//      output; with more, each block writes (acc, m, l) partials to a
//      workspace and a second small kernel merges them.
// The scores: 4 lanes share a key, each dotting a quarter of D from shared
// memory against q (f32, in shared memory), then 2 shuffles; the P.V: 16
// lanes split D into 16-byte chunks and 8 key groups split the tile; the 8
// partial accumulators meet in shared memory at the end.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef DA_KT
#define DA_KT 32
#endif
#ifndef DA_STAGES
#define DA_STAGES 3
#endif

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKT = DA_KT;                 // keys per tile
constexpr int kStages = DA_STAGES;         // tiles in the shared-memory ring
constexpr int kMaxD = 256;
constexpr int kMaxHeads = 8;               // query heads per block
constexpr int kMaxSplits = 32;
constexpr int kDChunks = 16;               // P.V: lanes across D (16-byte chunks)
constexpr int kKeyGroups = kThreads / kDChunks;
constexpr int kSubs = 4;                   // scores: lanes per key
constexpr int kQK = kKT / (kThreads / kSubs);   // keys per lane in the scores
constexpr int kPV = kKT / kKeyGroups;           // keys per lane in P.V

static_assert(kKT % 32 == 0 && kStages >= 2, "tile of a multiple of 32 keys, >= 2 stages");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// 16 bytes of T as floats
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// 16 bytes global -> shared, asynchronously; fill = false zero-fills the
// destination without reading the source
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = fill ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the reference's answer for a row with no live key: v averaged over all T
template <typename T>
__device__ float uniform_mean(const T* vb, long long v_st, int T_len, int d) {
  float s = 0.f;
  for (int t = 0; t < T_len; ++t) s += to_f32(vb[t * v_st + d]);
  return s / T_len;
}

template <typename T>
__host__ __device__ constexpr int pipe_bytes(int D) {
  return kStages * 2 * kKT * (D + 16 / static_cast<int>(sizeof(T))) * static_cast<int>(sizeof(T));
}

template <typename T, int HPB>
__host__ __device__ constexpr int smem_bytes(int D) {
  return pipe_bytes<T>(D) + (HPB * D + HPB * kKT + kWarps * HPB) * 4;
}

template <typename T, int HPB>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const uint8_t* __restrict__ mask,
                        const int* __restrict__ q_pos, float* __restrict__ out,
                        float* __restrict__ ws_acc, float* __restrict__ ws_ml, int Hq, int Hkv,
                        int n_hchunks, int T_len, int D, int span, float scale, long long k_sb,
                        long long k_st, long long k_sh, long long v_sb, long long v_st,
                        long long v_sh) {
  constexpr int E = 16 / sizeof(T);          // elements per 16-byte chunk
  constexpr int kMaxC = (kMaxD / E + kDChunks - 1) / kDChunks;   // P.V chunks per lane
  extern __shared__ __align__(16) unsigned char smem[];
  const int nchunk = D / E;
  const int row = D + E;                     // padded smem row, in elements
  T* kv_s = reinterpret_cast<T*>(smem);      // [kStages][K, V][kKT][row]
  float* q_s = reinterpret_cast<float*>(smem + pipe_bytes<T>(D));   // [HPB][D]
  float* s_s = q_s + HPB * D;                // [HPB][kKT] scores of the tile
  float* wm_s = s_s + HPB * kKT;             // [kWarps][HPB] warp maxima

  const int G = Hq / Hkv;
  int bid = blockIdx.x;
  const int hc = bid % n_hchunks;
  bid /= n_hchunks;
  const int kvh = bid % Hkv;
  const int b = bid / Hkv;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int h0 = kvh * G + hc * HPB;         // first query head of the block
  const int nh = min(HPB, G - hc * HPB);

  int live_end = T_len;
  if (q_pos != nullptr) {
    const long long p = q_pos[b];
    live_end = p < 0 ? 0 : static_cast<int>(min(p + 1, static_cast<long long>(T_len)));
  }
  const int t_begin = split * span;
  const int t_end = min(live_end, t_begin + span);
  const int n_tiles = t_end > t_begin ? (t_end - t_begin + kKT - 1) / kKT : 0;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  // K and V rows [t0, t0 + kKT) of tile `tile` into its ring buffer; rows at
  // or past t_end are zero-filled, never read. When a row's 16-byte chunks
  // divide the block, each lane keeps one chunk column and steps over rows
  // (no division in the loop); otherwise the lanes walk the chunks in order.
  const bool fixed_col = kThreads % nchunk == 0;
  const int c0 = threadIdx.x % nchunk;
  const int r0 = threadIdx.x / nchunk;
  const int rstep = kThreads / nchunk;
  auto copy_chunk = [&](T* st, int t0, int is_v, int r, int c) {
    const int t = t0 + r;
    const bool in = t < t_end;
    const T* src = is_v ? vb + (in ? t : t_begin) * v_st : kb + (in ? t : t_begin) * k_st;
    cp_async16(st + (is_v * kKT + r) * row + c * E, src + c * E, in);
  };
  auto issue = [&](int tile) {
    T* st = kv_s + static_cast<size_t>(tile % kStages) * 2 * kKT * row;
    const int t0 = t_begin + tile * kKT;
    if (fixed_col) {
      for (int r2 = r0; r2 < 2 * kKT; r2 += rstep) {
        const int is_v = r2 >= kKT;
        copy_chunk(st, t0, is_v, r2 - is_v * kKT, c0);
      }
    } else {
      for (int i = threadIdx.x; i < 2 * kKT * nchunk; i += kThreads)
        copy_chunk(st, t0, i / (nchunk * kKT), (i / nchunk) % kKT, i % nchunk);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) issue(s);
    cp_async_commit();
  }
  // q after the first tiles are on their way: its loads then wait alongside them
  for (int i = threadIdx.x; i < HPB * D; i += kThreads) {
    const int g = i / D;
    q_s[i] = g < nh ? to_f32(q[(static_cast<size_t>(b) * Hq + h0 + g) * D + i % D]) : 0.f;
  }

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int sub = lane / 8;                   // scores: which quarter of the chunks
  const int dc = threadIdx.x % kDChunks;      // P.V: first D chunk of the lane
  const int kg = threadIdx.x / kDChunks;      // P.V: key group

  float acc[kMaxC][E][HPB];
  float m[HPB], l[HPB];
#pragma unroll
  for (int g = 0; g < HPB; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int u = 0; u < kMaxC; ++u)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[u][e][g] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_begin + it * kKT;
    bool live[kQK];
#pragma unroll
    for (int r = 0; r < kQK; ++r) {      // the mask bytes load while the tile lands
      const int t = t0 + warp * 8 + lane % 8 + 32 * r;
      live[r] = t < t_end && (mask == nullptr || mask[static_cast<size_t>(b) * T_len + t] != 0);
    }
    cp_async_wait<kStages - 2>();
    __syncthreads();                      // the tile is in; the last tile's P.V is done
    if (it + kStages - 1 < n_tiles) issue(it + kStages - 1);
    cp_async_commit();
    const T* ks = kv_s + static_cast<size_t>(it % kStages) * 2 * kKT * row;
    const T* vs = ks + kKT * row;

    // scores: lane (key, sub) dots chunks sub, sub + 4, ... of its key
    float sc[kQK][HPB];
#pragma unroll
    for (int r = 0; r < kQK; ++r) {
      const int key = warp * 8 + lane % 8 + 32 * r;
#pragma unroll
      for (int g = 0; g < HPB; ++g) sc[r][g] = 0.f;
      for (int c = sub; c < nchunk; c += kSubs) {
        float kf[E];
        load16(ks + key * row + c * E, kf);
#pragma unroll
        for (int g = 0; g < HPB; ++g) {
          float qf[E];
#pragma unroll
          for (int e = 0; e < E; e += 4) load16(q_s + g * D + c * E + e, qf + e);
#pragma unroll
          for (int e = 0; e < E; ++e) sc[r][g] = fmaf(qf[e], kf[e], sc[r][g]);
        }
      }
    }
    float wm[HPB];
#pragma unroll
    for (int g = 0; g < HPB; ++g) {
      wm[g] = -INFINITY;
#pragma unroll
      for (int r = 0; r < kQK; ++r) {
        float s = sc[r][g];
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        s = live[r] ? s * scale : -INFINITY;
        sc[r][g] = s;
        wm[g] = fmaxf(wm[g], s);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        wm[g] = fmaxf(wm[g], __shfl_xor_sync(0xffffffffu, wm[g], off));
    }
    if (lane < 8) {
#pragma unroll
      for (int r = 0; r < kQK; ++r)
#pragma unroll
        for (int g = 0; g < HPB; ++g) s_s[g * kKT + warp * 8 + lane + 32 * r] = sc[r][g];
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < HPB; ++g) wm_s[warp * HPB + g] = wm[g];
    }
    __syncthreads();

    // online softmax and P.V: lane (kg, dc) takes keys kg, kg + 8, ... and
    // D chunks dc, dc + 16, ...; exp(-inf) = 0 drops the dead keys
    float p[HPB][kPV];
#pragma unroll
    for (int g = 0; g < HPB; ++g) {
      float mt = wm_s[g];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) mt = fmaxf(mt, wm_s[w * HPB + g]);
      const float m_new = fmaxf(m[g], mt);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[g] - m_use);
      m[g] = m_new;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < kPV; ++j) {
        p[g][j] = expf(s_s[g * kKT + kg + kKeyGroups * j] - m_use);
        ps += p[g][j];
      }
      l[g] = fmaf(l[g], alpha, ps);
#pragma unroll
      for (int u = 0; u < kMaxC; ++u)
        if (dc + kDChunks * u < nchunk) {
#pragma unroll
          for (int e = 0; e < E; ++e) acc[u][e][g] *= alpha;
        }
    }
#pragma unroll
    for (int j = 0; j < kPV; ++j) {
      const T* vr = vs + (kg + kKeyGroups * j) * row;
#pragma unroll
      for (int u = 0; u < kMaxC; ++u) {
        const int c = dc + kDChunks * u;
        if (c < nchunk) {
          float vf[E];
          load16(vr + c * E, vf);
#pragma unroll
          for (int g = 0; g < HPB; ++g)
#pragma unroll
            for (int e = 0; e < E; ++e) acc[u][e][g] = fmaf(p[g][j], vf[e], acc[u][e][g]);
        }
      }
    }
  }

  // the 8 key groups' partial sums meet in the (now idle) ring buffer
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);        // [kKeyGroups][HPB][D]
  float* lred = red + kKeyGroups * HPB * D;           // [kKeyGroups][HPB] denominators
  float* mred = lred + kKeyGroups * HPB;              // [HPB] maxima (the same in every lane)
#pragma unroll
  for (int u = 0; u < kMaxC; ++u) {
    const int c = dc + kDChunks * u;
    if (c < nchunk) {
#pragma unroll
      for (int g = 0; g < HPB; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e) red[(kg * HPB + g) * D + c * E + e] = acc[u][e][g];
    }
  }
  if (dc == 0) {
#pragma unroll
    for (int g = 0; g < HPB; ++g) {
      lred[kg * HPB + g] = l[g];
      if (kg == 0) mred[g] = m[g];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nh * D; i += kThreads) {
    const int g = i / D;
    const int d = i % D;
    float a = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kKeyGroups; ++w) {
      a += red[(w * HPB + g) * D + d];
      den += lred[w * HPB + g];
    }
    const size_t orow = static_cast<size_t>(b) * Hq + h0 + g;
    if (ws_acc == nullptr) {
      out[orow * D + d] = den > 0.f ? a / den : uniform_mean(vb, v_st, T_len, d);
    } else {
      const size_t w = orow * splits + split;
      ws_acc[w * D + d] = a;
      if (d == 0) {
        ws_ml[2 * w] = mred[g];
        ws_ml[2 * w + 1] = den;
      }
    }
  }
}

// merges the splits' partials of one (slot, query head): weights exp(m_s - m)
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_merge(const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
                       const T* __restrict__ v, float* __restrict__ out, int Hq, int Hkv,
                       int T_len, int D, int splits, long long v_sb, long long v_st,
                       long long v_sh) {
  const int orow = blockIdx.x;
  const int b = orow / Hq;
  const int kvh = (orow % Hq) / (Hq / Hkv);
  const float* ml = ws_ml + static_cast<size_t>(orow) * splits * 2;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[2 * s]);
  float wgt[kMaxSplits];
  float den = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    wgt[s] = 0.f;
    if (s < splits && mx != -INFINITY) {
      wgt[s] = expf(ml[2 * s] - mx);     // a split with no live key: exp(-inf) = 0
      den = fmaf(ml[2 * s + 1], wgt[s], den);
    }
  }
  const float* acc = ws_acc + static_cast<size_t>(orow) * splits * D;
  const T* vb = v + b * v_sb + kvh * v_sh;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    if (den > 0.f) {
      float a = 0.f;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s)
        if (s < splits) a = fmaf(acc[s * D + d], wgt[s], a);
      out[static_cast<size_t>(orow) * D + d] = a / den;
    } else {
      out[static_cast<size_t>(orow) * D + d] = uniform_mean(vb, v_st, T_len, d);
    }
  }
}

template <typename T, int HPB>
int launch(const void* q, const void* k, const void* v, const void* mask, const void* q_pos,
           void* out, void* ws_acc, void* ws_ml, int B, int Hq, int Hkv, int T_len, int D,
           int splits, float scale, const long long* st, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int n_hchunks = (G + HPB - 1) / HPB;
  const int per = (T_len + splits - 1) / splits;
  const int span = (per + kKT - 1) / kKT * kKT;
  const int smem = smem_bytes<T, HPB>(D);
  static int smem_set = 48 * 1024;       // the default limit of dynamic shared memory
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(decode_attention_kernel<T, HPB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  const dim3 grid(B * Hkv * n_hchunks, splits);
  float* part = splits > 1 ? static_cast<float*>(ws_acc) : nullptr;
  decode_attention_kernel<T, HPB><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<const int*>(q_pos),
      static_cast<float*>(out), part, static_cast<float*>(ws_ml), Hq, Hkv, n_hchunks, T_len,
      D, span, scale, st[0], st[1], st[2], st[3], st[4], st[5]);
  if (splits > 1) {
    decode_attention_merge<T><<<B * Hq, kThreads, 0, stream>>>(
        static_cast<const float*>(ws_acc), static_cast<const float*>(ws_ml),
        static_cast<const T*>(v), static_cast<float*>(out), Hq, Hkv, T_len, D, splits, st[3],
        st[4], st[5]);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_heads(int hpb, const void* q, const void* k, const void* v, const void* mask,
                 const void* q_pos, void* out, void* ws_acc, void* ws_ml, int B, int Hq,
                 int Hkv, int T_len, int D, int splits, float scale, const long long* st,
                 cudaStream_t s) {
#define DA_CASE(n)                                                                          \
  case n:                                                                                   \
    return launch<T, n>(q, k, v, mask, q_pos, out, ws_acc, ws_ml, B, Hq, Hkv, T_len, D,     \
                        splits, scale, st, s);
  switch (hpb) {
    DA_CASE(1) DA_CASE(2) DA_CASE(3) DA_CASE(4) DA_CASE(5) DA_CASE(6) DA_CASE(7) DA_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DA_CASE
}

}  // namespace

// The tile geometry this library was built with: keys per tile, ring stages,
// query heads per block at most, splits at most.
extern "C" void decode_attention_geometry(int* out4) {
  out4[0] = kKT;
  out4[1] = kStages;
  out4[2] = kMaxHeads;
  out4[3] = kMaxSplits;
}

// q: (B, Hq, D) contiguous; k, v: (B, T, Hkv, D) with unit stride on D and
// the element strides st = {k_sb, k_st, k_sh, v_sb, v_st, v_sh}, every row
// 16-byte aligned; q, k and v share one type, bf16 (is_bf16 = 1) or f32;
// mask: (B, T) uint8, nonzero = live key, or null; q_pos: (B,) int32, key t
// live iff t <= q_pos[b], or null; out: (B, Hq, D) f32. heads_per_block
// (1-8) query heads of a group per block; splits (1-32) blocks along T, and
// with splits > 1 the workspaces ws_acc (B * Hq * splits * D f32) and ws_ml
// (B * Hq * splits * 2 f32). Needs D <= 256 a multiple of 16 bytes,
// Hq % Hkv == 0, T >= 1. Returns cudaGetLastError().
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* mask, const void* q_pos, void* out,
                                       void* ws_acc, void* ws_ml, int B, int Hq, int Hkv,
                                       int T_len, int D, int heads_per_block, int splits,
                                       float scale, const long long* strides, int is_bf16,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits < 1 || splits > kMaxSplits || D > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return launch_heads<__nv_bfloat16>(heads_per_block, q, k, v, mask, q_pos, out, ws_acc,
                                       ws_ml, B, Hq, Hkv, T_len, D, splits, scale, strides, s);
  return launch_heads<float>(heads_per_block, q, k, v, mask, q_pos, out, ws_acc, ws_ml, B, Hq,
                             Hkv, T_len, D, splits, scale, strides, s);
}
