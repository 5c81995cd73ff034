// Blocked (flash) self-attention for Hopper (sm_90a), bf16 in and out:
//   out[b, h, i] = softmax_j(where(visible(i, j), scale * q[b, h, i] . k[b, kvh, j], -1e30))
//                  @ v[b, kvh, :]
// with GQA (kv head = q head / G, G = Hq / Hkv); causal: key j is visible to
// query i iff j <= q_offset[b] + i (a chunk appended at each row's cache
// position); not causal: every key is visible.
//
// Replaces the TPU kernel flash_attention_pallas (src/repro/kernels/
// flash_attention.py, body _kernel); with q_offset = 0 and T = S it computes
// exactly that function, and with a per-row q_offset the reference's extend
// attention (models/layers.py, mode "extend").
//
// What bounds it on an H100, by shape:
//   * a long causal prompt (S = T = 2048): the two products on the tensor
//     cores (operations; P.V costs twice a bf16-P kernel's, see below) in
//     principle, but it runs at about 6.6x that bound: the per-tile work
//     around the products (the copies, the barrier, the softmax bookkeeping)
//     runs at three warps a scheduler (the D = 128 body holds 168 registers
//     a thread);
//   * the serving chunks (a 32-token admission chunk, a 5-token verify chunk
//     over a 192-row cache) and a GQA prompt of 512: the bytes of the K/V
//     rows the queries may see, a few hundred keys each, and the latency of
//     walking a block's tiles one after another when the grid is small.
// The design:
//   * one block of 4 warps per (query tile, KV head, batch row[, T-split]).
//     Its 64 rows are (query position, head) pairs, position-major, over the
//     G query heads of the KV head (G > 16 in equal chunks of at most 16):
//     every row of a block has the causal limits of its few positions, and
//     each K/V tile is loaded once for all G heads, not G times. (A block of
//     128 rows, two m-tiles a warp with Q staged in shared memory, halves the
//     K/V reads from L2 but was slower at every shape measured: register
//     pressure outweighed it);
//   * K and V tiles of kKT keys stream through a kStages ring in dynamic
//     shared memory with 16-byte cp.async (a fixed 16-byte column per
//     thread; rows padded by 16 bytes: no bank conflicts for ldmatrix), one
//     commit group a tile and one barrier a tile: tiles j+1 .. j+kStages-1
//     land while tile j is computed. Key rows at or past the block's last
//     visible key are zero-filled, never read. 32 keys and 2 stages measured
//     best at every shape timed (scripts/flash_attention_sweep.py);
//   * S = Q K^T on bf16 mma.sync m16n8k16 with f32 accumulation, Q's A
//     fragments in registers for the whole key loop, K's B fragments by
//     ldmatrix.x4 (two 8-key tiles a load); then an online softmax in f32
//     per row (running max and denominator, exp2 domain);
//   * the mask only where it cuts: a tile below every row's limit takes a
//     path with no compare or select; masked logits are -1e30 as in the
//     reference, and p is 0 under the mask (every row sees key 0);
//   * P.V keeps p in f32 as the TPU kernel does (it casts q, k and v to
//     f32): p is split into two bf16 terms, hi = bf16(p) and lo = bf16(p -
//     hi), and both go through the tensor cores with V's B fragments by
//     ldmatrix.x4.trans. A bf16 P would err by up to 2^-9 max|v|, past the
//     stated tolerance;
//   * few blocks over many live keys (an admission chunk late in a long
//     prompt): when the grid holds fewer blocks than the card has SMs and
//     T is long, the wrapper splits each block's visible keys across blocks.
//     The caller hands in only the cache's live prefix (T = the chunk's
//     position plus its length, known on the host), so the split count
//     follows the live keys, from shapes alone (the launch can be captured
//     in a CUDA graph; each block reads its own live end from q_offset on
//     the device). The splits write (acc, m, l) partials to a workspace and
//     a second kernel merges them with weights exp2(m_s - m); one split
//     writes the output. Below 256 live keys the merge launch costs more
//     than the extra blocks win, so such chunks keep one split;
//   * causal query tiles are launched last-first, so the heavy tiles start
//     early.
// wgmma, TMA, warp specialisation and a bf16 P are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef FA_KT
#define FA_KT 32
#endif
#ifndef FA_STAGES
#define FA_STAGES 2
#endif

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;        // (position, head) rows per block
constexpr int kKT = FA_KT;                // keys per tile
constexpr int kStages = FA_STAGES;        // tiles in the shared-memory ring
constexpr int kMaxHeads = 16;             // query heads per block at most
constexpr int kMaxSplits = 16;
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kKT % 16 == 0 && kKT <= 128 && kStages >= 2, "tile of 16-128 keys, >= 2 stages");

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* q_offset;
  __nv_bfloat16* out;
  float* ws_acc;                          // splits > 1: (B, Hq, S, splits, D) partial sums
  float* ws_ml;                           //             (B, Hq, S, splits, 2) max, denominator
  int S, T, Hq, Hkv, G, hpb, n_hchunks, qpos, n_qtiles, splits, causal;
  float scale_log2;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_st, v_sb, v_sh, v_st, o_sb, o_sh, o_ss;
};

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 in one register, the first in the low half (the lower k index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// four 8x8 bf16 matrices from shared memory; lanes 8m..8m+7 address the rows
// of matrix m. Plain: lane t gets (row t/4, cols 2(t%4), 2(t%4)+1) of each;
// .trans: (rows 2(t%4), 2(t%4)+1; col t/4)
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
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

template <int D>
constexpr int smem_bytes() {
  return kStages * 2 * kKT * (D + 8) * static_cast<int>(sizeof(__nv_bfloat16));
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(const Params p) {
  constexpr int kPitch = D + 8;           // bf16 per shared row: 16-byte rows, no bank conflicts
  constexpr int kKSteps = D / 16;         // k-steps of Q K^T
  constexpr int kNT = D / 8;              // n-tiles of the output row
  constexpr int kVec = D / 8;             // 16-byte vectors per K/V row
  constexpr int kTile = kKT * kPitch;     // bf16 per K (or V) tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [stage][K, V][kKT][kPitch]

  const int qt = p.n_qtiles - 1 - static_cast<int>(blockIdx.x) / p.splits;
  const int split = static_cast<int>(blockIdx.x) % p.splits;
  const int kvh = blockIdx.y / p.n_hchunks;
  const int hc = blockIdx.y % p.n_hchunks;
  const int b = blockIdx.z;
  const int h0 = kvh * p.G + hc * p.hpb;  // the block's first query head
  const int nh = min(p.hpb, p.G - hc * p.hpb);
  const int pos0 = qt * p.qpos;           // its first query position
  const int npos = min(p.qpos, p.S - pos0);
  const int live_rows = npos * nh;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int off = p.causal ? p.q_offset[b] : 0;

  // keys [0, kv_end) are visible to some row of the block, keys [0,
  // mask_from) to every row; the block's tiles cover [0, kv_end), and this
  // split takes an equal share of them
  const int kv_end = p.causal ? min(p.T, off + pos0 + npos) : p.T;
  const int mask_from = p.causal ? min(off + pos0 + 1, kv_end) : kv_end;
  const int n_all = (kv_end + kKT - 1) / kKT;
  const int per = (n_all + p.splits - 1) / p.splits;
  const int t_first = split * per;
  const int n_tiles = max(0, min(n_all - t_first, per));

  const __nv_bfloat16* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + kvh * p.v_sh;
  auto copy_row = [&](__nv_bfloat16* ks, __nv_bfloat16* vs, int k0, int r, int c) {
    const int key = k0 + r;
    const bool in = key < kv_end;         // no row of this block sees a later key
    const long long src = in ? key : 0;
    cp_async16(ks + r * kPitch + c, kb + src * p.k_st + c, in);
    cp_async16(vs + r * kPitch + c, vb + src * p.v_st + c, in);
  };
  auto fetch = [&](int tile) {            // K and V of the split's tile `tile`
    __nv_bfloat16* ks = smem + (tile % kStages) * 2 * kTile;
    __nv_bfloat16* vs = ks + kTile;
    const int k0 = (t_first + tile) * kKT;
    if constexpr (kThreads % kVec == 0) {  // a fixed 16-byte column per thread
      const int c = (threadIdx.x % kVec) * 8;
#pragma unroll
      for (int r = threadIdx.x / kVec; r < kKT; r += kThreads / kVec) copy_row(ks, vs, k0, r, c);
    } else {
      for (int i = threadIdx.x; i < kKT * kVec; i += kThreads)
        copy_row(ks, vs, k0, i / kVec, (i % kVec) * 8);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) fetch(s);
    cp_async_commit();
  }

  // this thread's rows (position-major over the block's heads): r0, r0 + 8
  const int r0 = warp * 16 + g;
  const int r1 = r0 + 8;
  const bool live0 = r0 < live_rows;
  const bool live1 = r1 < live_rows;
  const bool warp_live = warp * 16 < live_rows;
  const int pos_0 = pos0 + r0 / nh;
  const int pos_1 = pos0 + r1 / nh;
  const int head0 = h0 + r0 % nh;
  const int head1 = h0 + r1 % nh;
  // the last key each of the two rows sees
  const int lim0 = p.causal ? min(off + pos_0, p.T - 1) : p.T - 1;
  const int lim1 = p.causal ? min(off + pos_1, p.T - 1) : p.T - 1;

  // Q as mma A fragments, loaded while the first tiles land, kept in
  // registers for the whole key loop
  const __nv_bfloat16* q0 = p.q + b * p.q_sb + head0 * p.q_sh + pos_0 * p.q_ss;
  const __nv_bfloat16* q1 = p.q + b * p.q_sb + head1 * p.q_sh + pos_1 * p.q_ss;
  uint32_t qa[kKSteps][4];
#pragma unroll
  for (int s = 0; s < kKSteps; ++s) {
    const int d = s * 16 + tig * 2;
    qa[s][0] = live0 ? ld_u32(q0 + d) : 0u;
    qa[s][1] = live1 ? ld_u32(q1 + d) : 0u;
    qa[s][2] = live0 ? ld_u32(q0 + d + 8) : 0u;
    qa[s][3] = live1 ? ld_u32(q1 + d + 8) : 0u;
  }

  float o[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;   // running max (log2 domain)
  float l0 = 0.f, l1 = 0.f;               // this thread's share of the denominators
  const int mat = lane >> 3;              // the ldmatrix sub-matrix this lane addresses

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                      // tile `it` is in; tile it-1 is consumed
    if (it + kStages - 1 < n_tiles) fetch(it + kStages - 1);
    cp_async_commit();
    if (!warp_live) continue;
    const __nv_bfloat16* ks = smem + (it % kStages) * 2 * kTile;
    const __nv_bfloat16* vs = ks + kTile;
    const int k0 = (t_first + it) * kKT;

    // scores of 16 rows x kKT keys: c0/c1 row r0, c2/c3 row r1, at keys
    // 8n + 2 tig (+1); one ldmatrix.x4 gives the B fragments of n-tiles n
    // and n + 1 for one k-step
    float sc[kKT / 8][4];
#pragma unroll
    for (int n = 0; n < kKT / 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int s = 0; s < kKSteps; ++s) {
#pragma unroll
      for (int n = 0; n < kKT / 8; n += 2) {
        uint32_t bf[4];
        ldmatrix_x4(bf, ks + ((n + (mat >> 1)) * 8 + (lane & 7)) * kPitch + s * 16 +
                            (mat & 1) * 8);
        mma_bf16(sc[n], qa[s], bf[0], bf[1]);
        mma_bf16(sc[n + 1], qa[s], bf[2], bf[3]);
      }
    }
    const bool masked = k0 + kKT > mask_from;
    float mx0 = m0, mx1 = m1;
    if (masked) {
#pragma unroll
      for (int n = 0; n < kKT / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + n * 8 + tig * 2 + e;
          sc[n][e] = key <= lim0 ? sc[n][e] * p.scale_log2 : kMasked;
          sc[n][2 + e] = key <= lim1 ? sc[n][2 + e] * p.scale_log2 : kMasked;
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < kKT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] *= p.scale_log2;
    }
#pragma unroll
    for (int n = 0; n < kKT / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
    }
    // the four threads of a quad share a row
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = exp2f(m0 - mx0);   // the first tile: exp2(-inf) = 0
    const float alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    if (masked) {
#pragma unroll
      for (int n = 0; n < kKT / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + n * 8 + tig * 2 + e;
          sc[n][e] = key <= lim0 ? exp2f(sc[n][e] - mx0) : 0.f;
          sc[n][2 + e] = key <= lim1 ? exp2f(sc[n][2 + e] - mx1) : 0.f;
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < kKT / 8; ++n) {
        sc[n][0] = exp2f(sc[n][0] - mx0);
        sc[n][1] = exp2f(sc[n][1] - mx0);
        sc[n][2] = exp2f(sc[n][2] - mx1);
        sc[n][3] = exp2f(sc[n][3] - mx1);
      }
    }
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < kKT / 8; ++n) {
      ps0 += sc[n][0] + sc[n][1];
      ps1 += sc[n][2] + sc[n][3];
    }
    l0 = fmaf(l0, alpha0, ps0);
    l1 = fmaf(l1, alpha1, ps1);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }
    // O += P V over 16-key steps; the score fragments of keys 16j..16j+15
    // are the A fragment of P (n-tiles 2j and 2j+1); one ldmatrix.x4.trans
    // gives V's B fragments of output n-tiles n and n + 1
#pragma unroll
    for (int j = 0; j < kKT / 16; ++j) {
      const float* left = sc[2 * j];        // keys 16j .. 16j+7
      const float* right = sc[2 * j + 1];   // keys 16j+8 .. 16j+15
      const float pv[8] = {left[0], left[1], left[2], left[3],
                           right[0], right[1], right[2], right[3]};
      float rest[8];
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        rest[e] = pv[e] - __bfloat162float(__float2bfloat16_rn(pv[e]));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        ah[r] = pack_bf16(pv[2 * r], pv[2 * r + 1]);
        al[r] = pack_bf16(rest[2 * r], rest[2 * r + 1]);
      }
      const __nv_bfloat16* vrow = vs + (j * 16 + (mat & 1) * 8 + (lane & 7)) * kPitch +
                                  (mat >> 1) * 8;
#pragma unroll
      for (int n = 0; n < kNT; n += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vrow + n * 8);
        mma_bf16(o[n], ah, bf[0], bf[1]);
        mma_bf16(o[n], al, bf[0], bf[1]);
        mma_bf16(o[n + 1], ah, bf[2], bf[3]);
        mma_bf16(o[n + 1], al, bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();
  if (!warp_live) return;

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if (p.splits == 1) {
    const float inv0 = 1.f / l0;
    const float inv1 = 1.f / l1;
    __nv_bfloat16* ob0 = p.out + b * p.o_sb + head0 * p.o_sh + pos_0 * p.o_ss;
    __nv_bfloat16* ob1 = p.out + b * p.o_sb + head1 * p.o_sh + pos_1 * p.o_ss;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int d = n * 8 + tig * 2;
      if (live0) *reinterpret_cast<uint32_t*>(ob0 + d) = pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
      if (live1) *reinterpret_cast<uint32_t*>(ob1 + d) = pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
    }
  } else {
    // partials of (b, head, position, split): the sums unnormalised, the max
    // in the log2 domain (-inf for a split with no tile, -1e30 for a row
    // that saw no key in it; either weighs 0 in the merge)
    const size_t w0 = ((static_cast<size_t>(b) * p.Hq + head0) * p.S + pos_0) * p.splits + split;
    const size_t w1 = ((static_cast<size_t>(b) * p.Hq + head1) * p.S + pos_1) * p.splits + split;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int d = n * 8 + tig * 2;
      if (live0) *reinterpret_cast<float2*>(p.ws_acc + w0 * D + d) = make_float2(o[n][0], o[n][1]);
      if (live1) *reinterpret_cast<float2*>(p.ws_acc + w1 * D + d) = make_float2(o[n][2], o[n][3]);
    }
    if (tig == 0) {
      if (live0) *reinterpret_cast<float2*>(p.ws_ml + 2 * w0) = make_float2(m0, l0);
      if (live1) *reinterpret_cast<float2*>(p.ws_ml + 2 * w1) = make_float2(m1, l1);
    }
  }
}

// merges the splits' partials: one thread per (b, head, position, d),
// weights exp2(m_s - m) with m the largest max (split 0 always holds key 0,
// which every row sees)
template <int D>
__global__ void __launch_bounds__(256)
flash_attention_merge(const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
                      __nv_bfloat16* __restrict__ out, long long total, int S, int Hq,
                      int splits, long long o_sb, long long o_sh, long long o_ss) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long row = i / D;
  const int d = static_cast<int>(i % D);
  const float* ml = ws_ml + row * splits * 2;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[2 * s]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float w = exp2f(ml[2 * s] - mx);
    den = fmaf(ml[2 * s + 1], w, den);
    num = fmaf(ws_acc[(row * splits + s) * D + d], w, num);
  }
  const int pos = static_cast<int>(row % S);
  const long long bh = row / S;
  const int h = static_cast<int>(bh % Hq);
  const long long b = bh / Hq;
  out[b * o_sb + h * o_sh + pos * o_ss + d] = __float2bfloat16_rn(num / den);
}

template <int D>
int launch(Params p, int B, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  static int smem_set = 48 * 1024;       // the default limit of dynamic shared memory
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  const dim3 grid(p.n_qtiles * p.splits, p.Hkv * p.n_hchunks, B);
  flash_attention_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  if (p.splits > 1) {
    const long long total = static_cast<long long>(B) * p.Hq * p.S * D;
    flash_attention_merge<D><<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
        p.ws_acc, p.ws_ml, p.out, total, p.S, p.Hq, p.splits, p.o_sb, p.o_sh, p.o_ss);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tile geometry this library was built with: keys per tile, ring stages,
// query heads per block at most, splits at most, (position, head) rows per
// block.
extern "C" void flash_attention_geometry(int* out5) {
  out5[0] = kKT;
  out5[1] = kStages;
  out5[2] = kMaxHeads;
  out5[3] = kMaxSplits;
  out5[4] = kRows;
}

// q (B, Hq, S, D), k/v (B, Hkv, T, D), out (B, Hq, S, D): bf16, unit stride
// on D, the element strides (batch, head, row) of q, k, v and out in
// strides[0..11] (each a multiple of 8, every base 16-byte aligned);
// q_offset: (B,) int32 >= 0 on the device (read only when causal). D is one
// of 16, 32, 64, 96, 128; Hq % Hkv == 0; S, T >= 1. scale is the softmax
// scale. heads_per_block (1-16) query heads of a group per block, dividing
// the group into equal chunks; splits (1-16) blocks along the keys, and with
// splits > 1 the f32 workspaces ws_acc (B * Hq * S * splits * D) and ws_ml
// (B * Hq * S * splits * 2). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* q_offset, void* out, void* ws_acc,
                                      void* ws_ml, int B, int Hq, int Hkv, int S, int T, int D,
                                      int causal, float scale, int heads_per_block, int splits,
                                      const long long* strides, void* stream) {
  const int G = Hq / Hkv;
  if (heads_per_block < 1 || heads_per_block > kMaxHeads || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && (ws_acc == nullptr || ws_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.q_offset = static_cast<const int*>(q_offset);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.ws_acc = static_cast<float*>(ws_acc);
  p.ws_ml = static_cast<float*>(ws_ml);
  p.S = S;
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.G = G;
  p.hpb = heads_per_block;
  p.n_hchunks = (G + heads_per_block - 1) / heads_per_block;
  p.qpos = kRows / heads_per_block;
  p.n_qtiles = (S + p.qpos - 1) / p.qpos;
  p.splits = splits;
  p.causal = causal;
  p.scale_log2 = scale * kLog2e;
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.q_ss = strides[2];
  p.k_sb = strides[3];
  p.k_sh = strides[4];
  p.k_st = strides[5];
  p.v_sb = strides[6];
  p.v_sh = strides[7];
  p.v_st = strides[8];
  p.o_sb = strides[9];
  p.o_sh = strides[10];
  p.o_ss = strides[11];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(p, B, s);
    case 32: return launch<32>(p, B, s);
    case 64: return launch<64>(p, B, s);
    case 96: return launch<96>(p, B, s);
    case 128: return launch<128>(p, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
