// Helpers shared by the plain and the grouped FP4 matmul kernels
// (cascade_matmul.cu, cascade_matmul_grouped.cu): the E2M1 decode, the
// output cast, ldmatrix and the bf16 mma.sync, and the scale-group modes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fp4mma {

// one group (the serving path), groups on the 16-row step, groups off it
enum Mode { kOneGroup = 0, kGroups = 1, kEdges = 2 };

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

// A packed byte (two K rows of one column, the even row in the low nibble)
// as the two bf16 values of an mma B register.
__device__ __forceinline__ uint32_t fp4_pair_bits(uint32_t byte) {
  return fp4_bf16_bits(byte & 0xFu) | (fp4_bf16_bits(byte >> 4) << 16);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
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

// The mode of a weight's scale groups: group == K is one group.
inline int mode_for(int K, int group) {
  return group == K ? kOneGroup : group % 16 == 0 ? kGroups : kEdges;
}

}  // namespace fp4mma
