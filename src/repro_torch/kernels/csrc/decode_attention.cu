// Decode attention for Hopper (sm_90a): one query token per slot against
// one layer's stacked KV cache,
//   out (B, Hq, D) f32 = softmax(where(mask, scale * q . k, -1e30)) @ v
// with GQA (kv head = q head / (Hq / Hkv)).
//
// Replaces the TPU kernel decode_attention_pallas (src/repro/kernels/
// flash_attention.py, bodies _decode_kernel and _decode_exact_kernel) and
// computes what ref.decode_attention_ref computes.
//
// What bounds it on an H100: each (slot, kv head) streams T * D keys and as
// many values once, at 2 FLOPs per element each, so it is bound by bytes
// (the card would need ~295 FLOP/byte to be bound by math). The design:
//   * one block per (slot, q head), 8 warps; the cache is read in place
//     through its strides (the (L, B, T, Hkv, D) stack's layer view), no
//     transpose or copy;
//   * each warp takes 4 consecutive keys at a time, 32 keys apart: lanes
//     split D, the 4 dots are reduced by interleaved warp shuffles, so 4 key rows
//     and then 4 value rows are in flight together; the warp keeps an
//     online max, denominator and value sum for its keys, all in f32;
//   * a masked key's score is -1e30, as in the reference: whenever the row
//     has a live key its weight is exp(-1e30 - max) = 0 exactly, so masked
//     keys and fully masked stretches of T add nothing; a row with no live
//     key at all averages v uniformly, as the reference does;
//   * the eight warp states merge in shared memory at the end.
// Splitting T across blocks (flash-decoding) is left for later work: at
// B = 8, Hq = 32 this grid already has 256 blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 4;                 // keys per warp per step
constexpr int kMaxD = 256;
constexpr int kPerLane = kMaxD / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const uint8_t* __restrict__ mask,
                        float* __restrict__ out, int Hq, int Hkv, int T_len, int D,
                        float scale, long long k_sb, long long k_st, long long k_sh,
                        long long v_sb, long long v_st, long long v_sh) {
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][kMaxD];

  const int b = blockIdx.x / Hq;
  const int h = blockIdx.x % Hq;
  const int kvh = h / (Hq / Hkv);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  float qv[kPerLane];
  float acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < D ? to_f32(q[((size_t)b * Hq + h) * D + d]) : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  const uint8_t* mrow = mask + (size_t)b * T_len;

  for (int t0 = warp * kKeys; t0 < T_len; t0 += kWarps * kKeys) {
    float s[kKeys];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      s[j] = 0.f;
      if (t0 + j < T_len) {
        const T* kt = kb + (t0 + j) * k_st;
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          const int d = lane + 32 * i;
          if (d < D) s[j] = fmaf(qv[i], to_f32(kt[d]), s[j]);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      if (t0 + j < T_len) {
        s[j] = mrow[t0 + j] ? s[j] * scale : -1e30f;
        m_new = fmaxf(m_new, s[j]);
      }
    }
    const float alpha = expf(m - m_new);     // the first step: exp(-inf) = 0
    float p[kKeys];
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      p[j] = (t0 + j < T_len) ? expf(s[j] - m_new) : 0.f;
      psum += p[j];
    }
    l = fmaf(l, alpha, psum);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d >= D) continue;
      float pv = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
        if (t0 + j < T_len) pv = fmaf(p[j], to_f32(vb[(t0 + j) * v_st + d]), pv);
      acc[i] = fmaf(acc[i], alpha, pv);
    }
    m = m_new;
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int d = lane + 32 * i;
    if (d < D) sm_acc[warp][d] = acc[i];
  }
  __syncthreads();
  float mx = sm_m[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
  float den = 0.f;
  float wgt[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wgt[w] = expf(sm_m[w] - mx);      // a warp that saw no key has m = -inf: weight 0
    den = fmaf(sm_l[w], wgt[w], den);
  }
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) num = fmaf(sm_acc[w][d], wgt[w], num);
    out[((size_t)b * Hq + h) * D + d] = num / den;
  }
}

}  // namespace

// q: (B, Hq, D) contiguous; k, v: (B, T, Hkv, D) with unit stride on D and
// the given element strides for B, T and Hkv; q, k and v share one type,
// bf16 (is_bf16 = 1) or f32; mask: (B, T) uint8, nonzero = live key;
// out: (B, Hq, D) f32. Needs D <= 256, Hq % Hkv == 0, T >= 1.
// Returns cudaGetLastError().
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* mask, void* out, int B, int Hq, int Hkv,
                                       int T_len, int D, float scale, long long k_sb,
                                       long long k_st, long long k_sh, long long v_sb,
                                       long long v_st, long long v_sh, int is_bf16,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * Hq);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  if (is_bf16) {
    decode_attention_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), mk, static_cast<float*>(out), Hq, Hkv, T_len,
        D, scale, k_sb, k_st, k_sh, v_sb, v_st, v_sh);
  } else {
    decode_attention_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), mk, static_cast<float*>(out), Hq, Hkv, T_len, D,
        scale, k_sb, k_st, k_sh, v_sb, v_st, v_sh);
  }
  return static_cast<int>(cudaGetLastError());
}
