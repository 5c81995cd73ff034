// Blocked (flash) self-attention for Hopper (sm_90a), bf16 in and out:
//   out[b, h, i] = softmax_j(where(visible(i, j), scale * q[b, h, i] . k[b, kvh, j], -1e30))
//                  @ v[b, kvh, :]
// with GQA (kv head = q head / G, G = Hq / Hkv); causal: key j, at position
// kp = k_pos[b, j] (j itself when k_pos is absent), is visible to query i
// (at position qp = q_offset[b] + i) iff kp >= 0, kp <= qp and, with a
// window, qp - kp < window (a chunk appended at each row's cache position;
// a ring buffer's rows carry their positions in k_pos); not causal: every
// key is visible.
//
// Replaces the TPU kernel flash_attention_pallas (src/repro/kernels/
// flash_attention.py, body _kernel); with q_offset = 0 and T = S it computes
// exactly that function, with a per-row q_offset the reference's extend
// attention (models/layers.py, mode "extend"), with a window its local
// attention (prefill), and with k_pos its ring-buffer extend over [ring,
// chunk] (keys at concat(slot_pos, chunk rows)).
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
//     early;
//   * a window without k_pos also skips the tiles before the block's first
//     visible key (a long windowed prompt reads window + 64 keys a block, not
//     all of them); with k_pos any key may be visible (a ring's rows are in
//     no order), so every tile is read and masked. A tile none of whose keys
//     a row sees leaves that row's sums exactly as they were: its p are 0
//     and its max -1e30 does not raise the running max. Every row must see
//     at least one key (a row sees its own key in every caller);
//   * the local mask is a template flag: a call without k_pos or window runs
//     the plain causal body (one compare a key), with the registers and bits
//     it had before local attention;
//   * head dim 256 (Griffin): Q as register fragments would take 64 of a
//     thread's registers beside the 128 of its output row, so Q is staged
//     once in shared memory (64 rows, padded) and its A fragments are read by
//     ldmatrix.x4 at each k-step; the K/V ring keeps 2 stages of kKTWide =
//     16 keys (shared memory 33 KB of Q and 33 KB of ring). At 32 keys the
//     local body spills at 255 registers (ptxas); at 16 nothing spills;
//   * an FP8 (e4m3) K/V cache (template flag kFp8): each thread loads its
//     8 codes of a row with a plain 8-byte load, converts them in registers
//     (e4m3 -> half -> bf16, exact) and stores the 16 bytes into the same
//     shared-memory layout the cp.async path fills, so everything after the
//     staging is the bf16 body: the result is the bf16 kernel's on the cache
//     upcast to bf16, bit for bit.
// wgmma, TMA, warp specialisation and a bf16 P are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
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
constexpr int kKTWide = 16;               // keys per tile past D = 128 (the output
                                          // row takes 128 registers at D = 256)
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
  const int* k_pos;                       // (B, T) key positions, or null (key j at j)
  __nv_bfloat16* out;
  float* ws_acc;                          // splits > 1: (B, Hq, S, splits, D) partial sums
  float* ws_ml;                           //             (B, Hq, S, splits, 2) max, denominator
  int S, T, Hq, Hkv, G, hpb, n_hchunks, qpos, n_qtiles, splits, causal, window;
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

// Q is staged in shared memory past this head dim (its register fragments
// would not fit beside the output row's)
// 8 e4m3 codes at src (8-byte aligned) as 8 bf16 at dst (16-byte aligned
// shared memory), zeros without a read when !fill; e4m3 -> half -> bf16 is exact
__device__ __forceinline__ void stage_fp8(__nv_bfloat16* dst, const uint8_t* src, bool fill) {
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  if (fill) {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
    const uint32_t w[2] = {u.x, u.y};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_fp8x2_storage_t pair =
          static_cast<__nv_fp8x2_storage_t>((w[i / 2] >> (16 * (i % 2))) & 0xffffu);
      const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(pair, __NV_E4M3);
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
      o[i] = pack_bf16(f.x, f.y);
    }
  }
  *reinterpret_cast<uint4*>(dst) = out;
}

template <int D>
__host__ __device__ constexpr bool q_in_smem() {
  return D > 128;
}

// keys per tile at head dim D
template <int D>
__host__ __device__ constexpr int keys_per_tile() {
  return D > 128 ? kKTWide : kKT;
}

template <int D>
constexpr int smem_bytes() {
  return (kStages * 2 * keys_per_tile<D>() + (q_in_smem<D>() ? kRows : 0)) * (D + 8) *
         static_cast<int>(sizeof(__nv_bfloat16));
}

// kLocal: the call has k_pos or a window. Without them the body is the plain
// causal one (visible iff key <= the row's last key), which keeps the
// registers, and the bits, of the kernel before local attention. kFp8: k and
// v are e4m3 (p.k and p.v point at bytes; their strides count bytes)
template <int D, bool kLocal, bool kFp8>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(const Params p) {
  constexpr int kKT = keys_per_tile<D>();  // keys per tile (shadows the default's)
  constexpr int kPitch = D + 8;           // bf16 per shared row: 16-byte rows, no bank conflicts
  constexpr int kKSteps = D / 16;         // k-steps of Q K^T
  constexpr int kNT = D / 8;              // n-tiles of the output row
  constexpr int kVec = D / 8;             // 16-byte vectors per K/V row
  constexpr int kTile = kKT * kPitch;     // bf16 per K (or V) tile
  constexpr bool kQSmem = q_in_smem<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [stage][K, V][kKT][kPitch], then (kQSmem) Q's [kRows][kPitch]
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* smem_q = smem + kStages * 2 * kTile;

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

  // keys [kv_begin, kv_end) hold every key visible to a row of the block,
  // keys [mask_below, mask_from) are visible to every row; the block's tiles
  // cover [kv_begin, kv_end), and this split takes an equal share of them.
  // With k_pos any key may be visible: every tile is read and masked
  const bool by_kpos = kLocal && p.k_pos != nullptr;
  const bool windowed = kLocal && p.causal && p.window > 0;
  const int kv_end = (p.causal && !by_kpos) ? min(p.T, off + pos0 + npos) : p.T;
  const int kv_begin = (windowed && !by_kpos) ? max(0, off + pos0 - p.window + 1) : 0;
  const int mask_from = by_kpos ? 0 : p.causal ? min(off + pos0 + 1, kv_end) : kv_end;
  const int mask_below = (windowed && !by_kpos) ? off + pos0 + npos - p.window : 0;
  const int t_lo = kv_begin / kKT;
  const int n_all = max(0, (kv_end + kKT - 1) / kKT - t_lo);
  const int per = (n_all + p.splits - 1) / p.splits;
  const int t_first = t_lo + split * per;
  const int n_tiles = max(0, min(n_all - split * per, per));
  const int* kpos = by_kpos ? p.k_pos + static_cast<long long>(b) * p.T : nullptr;

  const __nv_bfloat16* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + kvh * p.v_sh;
  const uint8_t* kb8 = reinterpret_cast<const uint8_t*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const uint8_t* vb8 = reinterpret_cast<const uint8_t*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  auto copy_row = [&](__nv_bfloat16* ks, __nv_bfloat16* vs, int k0, int r, int c) {
    const int key = k0 + r;
    const bool in = key < kv_end;         // no row of this block sees a later key
    const long long src = in ? key : 0;
    if constexpr (kFp8) {                 // converted on the way; the barrier publishes it
      stage_fp8(ks + r * kPitch + c, kb8 + src * p.k_st + c, in);
      stage_fp8(vs + r * kPitch + c, vb8 + src * p.v_st + c, in);
    } else {
      cp_async16(ks + r * kPitch + c, kb + src * p.k_st + c, in);
      cp_async16(vs + r * kPitch + c, vb + src * p.v_st + c, in);
    }
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
  if constexpr (kQSmem) {
    // Q's rows into shared memory (dead rows zero-filled), in the first
    // commit group, beside the first K/V tile
    for (int i = threadIdx.x; i < kRows * kVec; i += kThreads) {
      const int r = i / kVec;
      const int c = (i % kVec) * 8;
      const bool live = r < live_rows;
      const __nv_bfloat16* src =
          live ? p.q + b * p.q_sb + (h0 + r % nh) * p.q_sh + (pos0 + r / nh) * p.q_ss + c : p.q;
      cp_async16(smem_q + r * kPitch + c, src, live);
    }
  }
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
  // plain: the last key each of the two rows sees; local: the query
  // position of each, and key j visible to a row at qp iff its position
  // kp (-1 past T: no key) is >= 0, <= qp and, with a window, within it
  const int lim0 = p.causal ? min(off + pos_0, p.T - 1) : p.T - 1;
  const int lim1 = p.causal ? min(off + pos_1, p.T - 1) : p.T - 1;
  const int qp0 = off + pos_0;
  const int qp1 = off + pos_1;

  // Q as mma A fragments, loaded while the first tiles land, kept in
  // registers for the whole key loop (from shared memory at each k-step
  // when kQSmem)
  const __nv_bfloat16* q0 = p.q + b * p.q_sb + head0 * p.q_sh + pos_0 * p.q_ss;
  const __nv_bfloat16* q1 = p.q + b * p.q_sb + head1 * p.q_sh + pos_1 * p.q_ss;
  uint32_t qa[kQSmem ? 1 : kKSteps][4];
  if constexpr (!kQSmem) {
#pragma unroll
    for (int s = 0; s < kKSteps; ++s) {
      const int d = s * 16 + tig * 2;
      qa[s][0] = live0 ? ld_u32(q0 + d) : 0u;
      qa[s][1] = live1 ? ld_u32(q1 + d) : 0u;
      qa[s][2] = live0 ? ld_u32(q0 + d + 8) : 0u;
      qa[s][3] = live1 ? ld_u32(q1 + d + 8) : 0u;
    }
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
      uint32_t qs_frag[4];
      const uint32_t* a = qa[kQSmem ? 0 : s];
      if constexpr (kQSmem) {
        // rows 0-15 of the warp's m-tile, k-steps' halves by lane / 16
        ldmatrix_x4(qs_frag, smem_q + (warp * 16 + (lane & 15)) * kPitch + s * 16 +
                                 (lane >> 4) * 8);
        a = qs_frag;
      }
#pragma unroll
      for (int n = 0; n < kKT / 8; n += 2) {
        uint32_t bf[4];
        ldmatrix_x4(bf, ks + ((n + (mat >> 1)) * 8 + (lane & 7)) * kPitch + s * 16 +
                            (mat & 1) * 8);
        mma_bf16(sc[n], a, bf[0], bf[1]);
        mma_bf16(sc[n + 1], a, bf[2], bf[3]);
      }
    }
    const bool masked = k0 + kKT > mask_from || (kLocal && k0 < mask_below);
    // bit 2n + e: this thread's key k0 + 8n + 2 tig + e is visible to row r0 / r1
    uint32_t vis0 = 0u, vis1 = 0u;
    float mx0 = m0, mx1 = m1;
    if (masked) {
#pragma unroll
      for (int n = 0; n < kKT / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + n * 8 + tig * 2 + e;
          bool v0 = key <= lim0, v1 = key <= lim1;
          if constexpr (kLocal) {
            const int kp = key >= p.T ? -1 : by_kpos ? __ldg(kpos + key) : key;
            const bool all = !p.causal;
            v0 = kp >= 0 && (all || (kp <= qp0 && (p.window <= 0 || qp0 - kp < p.window)));
            v1 = kp >= 0 && (all || (kp <= qp1 && (p.window <= 0 || qp1 - kp < p.window)));
            vis0 |= static_cast<uint32_t>(v0) << (2 * n + e);
            vis1 |= static_cast<uint32_t>(v1) << (2 * n + e);
          }
          sc[n][e] = v0 ? sc[n][e] * p.scale_log2 : kMasked;
          sc[n][2 + e] = v1 ? sc[n][2 + e] * p.scale_log2 : kMasked;
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
          const bool v0 = kLocal ? (vis0 >> (2 * n + e)) & 1u : key <= lim0;
          const bool v1 = kLocal ? (vis1 >> (2 * n + e)) & 1u : key <= lim1;
          sc[n][e] = v0 ? exp2f(sc[n][e] - mx0) : 0.f;
          sc[n][2 + e] = v1 ? exp2f(sc[n][2 + e] - mx1) : 0.f;
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
// weights exp2(m_s - m) with m the largest max (a split in which a row saw
// no key has max -1e30 or -inf and weighs 0; some split holds a key the row
// sees)
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

template <int D, bool kLocal, bool kFp8>
int launch(Params p, int B, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  static int smem_set = 48 * 1024;       // the default limit of dynamic shared memory
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<D, kLocal, kFp8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  const dim3 grid(p.n_qtiles * p.splits, p.Hkv * p.n_hchunks, B);
  flash_attention_kernel<D, kLocal, kFp8><<<grid, kThreads, smem, stream>>>(p);
  if (p.splits > 1) {
    const long long total = static_cast<long long>(B) * p.Hq * p.S * D;
    flash_attention_merge<D><<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
        p.ws_acc, p.ws_ml, p.out, total, p.S, p.Hq, p.splits, p.o_sb, p.o_sh, p.o_ss);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(Params p, int B, cudaStream_t s, bool local, bool fp8) {
  if (fp8) return local ? launch<D, true, true>(p, B, s) : launch<D, false, true>(p, B, s);
  return local ? launch<D, true, false>(p, B, s) : launch<D, false, false>(p, B, s);
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

// q (B, Hq, S, D), k/v (B, Hkv, T, D), out (B, Hq, S, D): bf16 (k and v
// e4m3 when kv_fp8), unit stride on D, the element strides (batch, head,
// row) of q, k, v and out in strides[0..11] (each a multiple of 8, every
// base 16-byte aligned);
// q_offset: (B,) int32 >= 0 on the device (read only when causal); k_pos:
// null, or (B, T) int32 contiguous on the device, key j of row b at position
// k_pos[b, j] (< 0: no key); window: 0, or (causal) the local window. Every
// query row must see at least one key. D is one
// of 16, 32, 64, 96, 128, 256; Hq % Hkv == 0; S, T >= 1. scale is the softmax
// scale. heads_per_block (1-16) query heads of a group per block, dividing
// the group into equal chunks; splits (1-16) blocks along the keys, and with
// splits > 1 the f32 workspaces ws_acc (B * Hq * S * splits * D) and ws_ml
// (B * Hq * S * splits * 2). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* q_offset, const void* k_pos, void* out,
                                      void* ws_acc, void* ws_ml, int B, int Hq, int Hkv, int S,
                                      int T, int D, int causal, int window, float scale,
                                      int heads_per_block, int splits, int kv_fp8,
                                      const long long* strides, void* stream) {
  const int G = Hq / Hkv;
  if (heads_per_block < 1 || heads_per_block > kMaxHeads || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && (ws_acc == nullptr || ws_ml == nullptr)) || window < 0 ||
      (!causal && (window > 0 || k_pos != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.q_offset = static_cast<const int*>(q_offset);
  p.k_pos = static_cast<const int*>(k_pos);
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
  p.window = window;
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
  const bool local = k_pos != nullptr || window > 0;
  const bool fp8 = kv_fp8 != 0;
  switch (D) {
    case 16: return launch_d<16>(p, B, s, local, fp8);
    case 32: return launch_d<32>(p, B, s, local, fp8);
    case 64: return launch_d<64>(p, B, s, local, fp8);
    case 96: return launch_d<96>(p, B, s, local, fp8);
    case 128: return launch_d<128>(p, B, s, local, fp8);
    case 256: return launch_d<256>(p, B, s, local, fp8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
