// Blocked (flash) self-attention for Hopper (sm_90a), bf16 in and out:
//   out[b, h, i] = softmax_j(where(visible(i, j), scale * q[b, h, i] . k[b, kvh, j], -1e30))
//                  @ v[b, kvh, :]
// with GQA (kv head = q head / (Hq / Hkv)); causal: key j is visible to
// query i iff j <= q_offset[b] + i (a chunk appended at each row's cache
// position); not causal: every key is visible.
//
// Replaces the TPU kernel flash_attention_pallas (src/repro/kernels/
// flash_attention.py, body _kernel); with q_offset = 0 and T = S it computes
// exactly that function, and with a per-row q_offset the reference's extend
// attention (models/layers.py, mode "extend").
//
// What bounds it on an H100: at the serving path's shapes (a 32-token
// admission chunk, a 5-token verify chunk) each (row, head) reads only the
// K/V rows its queries may see, a few hundred keys, once: it is bound by
// bytes. For a long causal prompt (S = 2048) the two products dominate and
// the tensor cores bound it. The design:
//   * one block of 4 warps per (query tile of 64 rows, q head, batch row);
//     each warp owns 16 query rows; a short chunk (S = 5 or 32) leaves whole
//     warps idle: they only help load the tiles;
//   * q, k and v are read in place through element strides (q as the
//     (B, S, H, D) projection's transpose, k/v as a layer view of the
//     (L, B, T, Hkv, D) cache), no copy; each 64-key tile of K and V is
//     staged in shared memory with 16-byte loads (invisible rows zero-filled);
//   * S = Q K^T on bf16 mma.sync m16n8k16 with f32 accumulation (the bf16
//     products are exact in f32), then an online softmax in f32 with a
//     running max and denominator per row, in the exp2 domain;
//   * P.V keeps P in f32 as the TPU kernel does: p is split into two bf16
//     terms, hi = bf16(p) and lo = bf16(p - hi), and both go through the
//     tensor cores (p carried to ~16 bits, so the result differs from f32
//     P.V by far less than the bf16 rounding of the output);
//   * masked logits are -1e30 as in the reference, and p is set to 0 under
//     the mask, so a tile that is masked for a row adds nothing to its
//     denominator (every row sees key 0, so no row is masked throughout);
//   * K/V rows past the block's last visible key are never read (the TPU
//     kernel's pl.when skip, down to the row): a verify chunk at pos 130 of
//     a 192-row cache reads keys 0-134 only;
//   * causal query tiles are issued last-first, so the heavy tiles start
//     early.
// wgmma, TMA, double buffering and splitting T across blocks are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;          // query rows per block
constexpr int kBK = 64;                   // keys per tile
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

// B fragment (k16 x n8) of a row-major [k][n] bf16 tile in shared memory:
// lanes 0-7 address rows k0..k0+7, lanes 8-15 rows k0+8..k0+15, each at
// column n0; .trans hands lane t the pairs (k = 2(t%4), 2(t%4)+1; n = t/4)
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_offset,
                       __nv_bfloat16* __restrict__ out, int S, int T, int Hq, int Hkv,
                       int causal, float scale_log2, long long q_sb, long long q_sh,
                       long long q_ss, long long k_sb, long long k_sh, long long k_st,
                       long long v_sb, long long v_sh, long long v_st, long long o_sb,
                       long long o_sh, long long o_ss) {
  constexpr int kPitch = D + 8;           // bf16 per shared row: 16-byte rows, no bank conflicts
  constexpr int kKSteps = D / 16;         // k-steps of Q K^T
  constexpr int kNT = D / 8;              // n-tiles of the output row
  constexpr int kVec = D / 8;             // 16-byte vectors per K/V row
  __shared__ __align__(16) __nv_bfloat16 ks[kBK * kPitch];
  __shared__ __align__(16) __nv_bfloat16 vs[kBK * kPitch];

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int q0 = qt * kBQ;
  const int off = causal ? q_offset[b] : 0;
  const int row0 = q0 + warp * 16 + g;    // this thread's rows: row0 and row0 + 8
  const int row1 = row0 + 8;
  const int last_row = min(q0 + kBQ, S) - 1;
  const int kv_end = causal ? min(T, off + last_row + 1) : T;    // keys [0, kv_end)
  const bool warp_live = q0 + warp * 16 < S;
  // the last key each of the two rows sees
  const int lim0 = causal ? min(off + row0, T - 1) : T - 1;
  const int lim1 = causal ? min(off + row1, T - 1) : T - 1;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + kvh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kvh * v_sh;

  // Q as mma A fragments, kept in registers for the whole key loop
  uint32_t qa[kKSteps][4];
#pragma unroll
  for (int s = 0; s < kKSteps; ++s) {
    const int d = s * 16 + tig * 2;
    qa[s][0] = row0 < S ? ld_u32(qb + row0 * q_ss + d) : 0u;
    qa[s][1] = row1 < S ? ld_u32(qb + row1 * q_ss + d) : 0u;
    qa[s][2] = row0 < S ? ld_u32(qb + row0 * q_ss + d + 8) : 0u;
    qa[s][3] = row1 < S ? ld_u32(qb + row1 * q_ss + d + 8) : 0u;
  }

  float o[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;   // running max (log2 domain)
  float l0 = 0.f, l1 = 0.f;               // this thread's share of the denominators

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();                      // the previous tile is consumed
    for (int i = threadIdx.x; i < kBK * kVec; i += kThreads) {
      const int r = i / kVec;
      const int c = (i % kVec) * 8;
      const int key = k0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = kv;
      if (key < kv_end) {                 // no row of this block sees a later key
        kv = *reinterpret_cast<const uint4*>(kb + key * k_st + c);
        vv = *reinterpret_cast<const uint4*>(vb + key * v_st + c);
      }
      *reinterpret_cast<uint4*>(ks + r * kPitch + c) = kv;
      *reinterpret_cast<uint4*>(vs + r * kPitch + c) = vv;
    }
    __syncthreads();
    if (!warp_live) continue;

    // scores of 16 rows x 64 keys: c0/c1 row0, c2/c3 row1, at keys 8n + 2 tig (+1)
    float sc[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
      const __nv_bfloat16* krow = ks + (n * 8 + g) * kPitch + tig * 2;
#pragma unroll
      for (int s = 0; s < kKSteps; ++s)
        mma_bf16(sc[n], qa[s], ld_u32(krow + s * 16), ld_u32(krow + s * 16 + 8));
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + n * 8 + tig * 2 + e;
        sc[n][e] = key <= lim0 ? sc[n][e] * scale_log2 : kMasked;
        sc[n][2 + e] = key <= lim1 ? sc[n][2 + e] * scale_log2 : kMasked;
        mx0 = fmaxf(mx0, sc[n][e]);
        mx1 = fmaxf(mx1, sc[n][2 + e]);
      }
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
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + n * 8 + tig * 2 + e;
        sc[n][e] = key <= lim0 ? exp2f(sc[n][e] - mx0) : 0.f;
        sc[n][2 + e] = key <= lim1 ? exp2f(sc[n][2 + e] - mx1) : 0.f;
        ps0 += sc[n][e];
        ps1 += sc[n][2 + e];
      }
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
    // are the A fragment of P (n-tiles 2j and 2j+1)
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
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
      const __nv_bfloat16* vrow = vs + (j * 16 + (lane & 15)) * kPitch;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vrow + n * 8);
        mma_bf16(o[n], ah, b0, b1);
        mma_bf16(o[n], al, b0, b1);
      }
    }
  }
  if (!warp_live) return;

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
  __nv_bfloat16* ob = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int d = n * 8 + tig * 2;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(ob + row0 * o_ss + d) = pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    if (row1 < S)
      *reinterpret_cast<uint32_t*>(ob + row1 * o_ss + d) = pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, const int* off, void* out, int B,
            int Hq, int Hkv, int S, int T, int causal, float scale_log2, const long long* st,
            cudaStream_t stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_attention_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), off, static_cast<__nv_bfloat16*>(out), S, T, Hq,
      Hkv, causal, scale_log2, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11]);
}

}  // namespace

// q (B, Hq, S, D), k/v (B, Hkv, T, D), out (B, Hq, S, D): bf16, unit stride
// on D, the element strides (batch, head, row) of q, k, v and out in
// strides[0..11] (each a multiple of 8, every base 16-byte aligned);
// q_offset: (B,) int32 on the device (read only when causal). D is one of
// 16, 32, 64, 96, 128; Hq % Hkv == 0; S, T >= 1. scale is the softmax
// scale (1/sqrt(D) by default). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a D it was not built for.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* q_offset, void* out, int B, int Hq, int Hkv,
                                      int S, int T, int D, int causal, float scale,
                                      const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(q_offset);
  const float sl2 = scale * kLog2e;
  switch (D) {
    case 16: launch<16>(q, k, v, off, out, B, Hq, Hkv, S, T, causal, sl2, strides, s); break;
    case 32: launch<32>(q, k, v, off, out, B, Hq, Hkv, S, T, causal, sl2, strides, s); break;
    case 64: launch<64>(q, k, v, off, out, B, Hq, Hkv, S, T, causal, sl2, strides, s); break;
    case 96: launch<96>(q, k, v, off, out, B, Hq, Hkv, S, T, causal, sl2, strides, s); break;
    case 128: launch<128>(q, k, v, off, out, B, Hq, Hkv, S, T, causal, sl2, strides, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
