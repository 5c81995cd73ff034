// Mamba-2 SSD scan for Hopper (sm_90a): the sequential state-space
// recurrence of every (batch row b, head h) over S steps,
//   state = state * exp(dt[t] * A) + (dt[t] * x[t]) (outer) B[t]   (P, N) f32
//   y[t]  = state @ C[t] + D * x[t]                                (P,)
// with head h reading state group g = h / (H / G) of B and C.
//
// Replaces the TPU kernel ssd_scan_pallas (src/repro/kernels/ssd_scan.py,
// bodies _kernel and _kernel_carry) and computes what ref.ssd_scan_ref and
// models/ssm.py ssd_decode_step compute. The serving decode step runs it at
// S = 1 with the slot states carried in and out.
//
// What bounds it on an H100: at S = 1 each (b, h) reads its (P, N) f32
// state once and writes it once, at 4 FLOPs per state element; x, dt, B
// and C are a few hundred bytes. So it is bound by bytes: the state read
// plus the state written (2 * 32 KB per head at P = 64, N = 128). The design:
//   * one block per (b, h), 8 warps; the TPU's sequential chunk grid
//     becomes a loop over S inside the block, and the state stays in
//     registers for the whole loop (32 floats a thread at P = 64, N = 128):
//     it is read from device memory once and written once per launch;
//   * warp w owns state rows p = w, w + 8, ...; lane l owns the four
//     columns n = 4l .. 4l + 3 of each, so the state moves as one 16-byte
//     vector per lane per row and a warp reads or writes whole 512-byte rows;
//   * the readout state @ C sums a lane's four products and then the 32
//     lanes with warp shuffles; y is written by lane 0;
//   * x, dt, B and C are read in place through their strides (the serving
//     path passes strided views of the conv output), B and C by group;
//   * the state update is written with __fmul_rn / __fadd_rn so that nvcc
//     does not contract it into an FMA: it is then the same elementwise
//     arithmetic as the plain PyTorch version (expf, as torch.exp uses).
// The final state may be written over the initial one (in place): each
// block reads all of its own state into registers before it writes any of
// it, and no block touches another block's state.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRows = 8;               // state rows per warp: P <= 64
constexpr int kCols = 4;                  // state columns per lane: N <= 128

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ D,
                const float* state_in, float* state_out, T* __restrict__ y,
                int S, int H, int P, int G, int N,
                long long sx_b, long long sx_t, long long sx_h,
                long long sdt_b, long long sdt_t, long long sdt_h,
                long long sB_b, long long sB_t, long long sB_g,
                long long sC_b, long long sC_t, long long sC_g,
                long long sA_b, long long sA_h, long long sD_b, long long sD_h) {
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int g = h / (H / G);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n0 = kCols * lane;
  const bool has_cols = n0 < N;           // N is a multiple of 4

  // state_in and state_out may alias: every read of this block's state
  // happens here, before the first write at the end
  float st[kMaxRows][kCols];
  const size_t base = (size_t)blockIdx.x * P * N;
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    const int p = warp + kWarps * r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (state_in != nullptr && p < P && has_cols)
      v = *reinterpret_cast<const float4*>(state_in + base + (size_t)p * N + n0);
    st[r][0] = v.x;
    st[r][1] = v.y;
    st[r][2] = v.z;
    st[r][3] = v.w;
  }

  const float a = A[b * sA_b + h * sA_h];
  const float dskip = D[b * sD_b + h * sD_h];
  const T* xb = x + b * sx_b + h * sx_h;
  const float* dtb = dt + b * sdt_b + h * sdt_h;
  const T* Bb = Bm + b * sB_b + g * sB_g;
  const T* Cb = Cm + b * sC_b + g * sC_g;

  for (int t = 0; t < S; ++t) {
    const float dtv = dtb[t * sdt_t];
    const float decay = expf(dtv * a);
    float bv[kCols], cv[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      bv[k] = has_cols ? to_f32(Bb[t * sB_t + n0 + k]) : 0.f;
      cv[k] = has_cols ? to_f32(Cb[t * sC_t + n0 + k]) : 0.f;
    }
    const T* xt = xb + t * sx_t;
    T* yt = y + ((size_t)(b * S + t) * H + h) * P;
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      const int p = warp + kWarps * r;
      if (p >= P) break;                  // the same for the whole warp
      const float xv = to_f32(xt[p]);
      const float xdt = __fmul_rn(dtv, xv);
      float part = 0.f;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        st[r][k] = __fadd_rn(__fmul_rn(st[r][k], decay), __fmul_rn(xdt, bv[k]));
        part = fmaf(st[r][k], cv[k], part);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) store(yt + p, part + dskip * xv);
    }
  }

  if (state_out != nullptr) {
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      const int p = warp + kWarps * r;
      if (p < P && has_cols)
        *reinterpret_cast<float4*>(state_out + base + (size_t)p * N + n0) =
            make_float4(st[r][0], st[r][1], st[r][2], st[r][3]);
    }
  }
}

}  // namespace

// x: (Bt, S, H, P), unit stride on P, element strides sx_* for Bt, S, H;
// dt: (Bt, S, H) f32, strides sdt_*; B, C: (Bt, S, G, N), unit stride on N,
// strides sB_* / sC_*; x, B and C share one type, bf16 (is_bf16 = 1) or f32;
// A, D: f32 indexed [b * s*_b + h * s*_h] (stride 0 broadcasts). state_in
// (may be null: zeros) and state_out (may be null: not written; may equal
// state_in): contiguous (Bt, H, P, N) f32, 16-byte aligned. y: contiguous
// (Bt, S, H, P) in x's type. Needs P <= 64, N <= 128 with N % 4 == 0,
// H % G == 0. Returns cudaGetLastError().
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A, const void* Bm,
                               const void* Cm, const void* D, const void* state_in,
                               void* state_out, void* y, int Bt, int S, int H, int P, int G,
                               int N, long long sx_b, long long sx_t, long long sx_h,
                               long long sdt_b, long long sdt_t, long long sdt_h,
                               long long sB_b, long long sB_t, long long sB_g,
                               long long sC_b, long long sC_t, long long sC_g,
                               long long sA_b, long long sA_h, long long sD_b,
                               long long sD_h, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(Bt * H);
  const float* dtp = static_cast<const float*>(dt);
  const float* Ap = static_cast<const float*>(A);
  const float* Dp = static_cast<const float*>(D);
  const float* sin = static_cast<const float*>(state_in);
  float* sout = static_cast<float*>(state_out);
  if (is_bf16) {
    using T = __nv_bfloat16;
    ssd_scan_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), dtp, Ap, static_cast<const T*>(Bm),
        static_cast<const T*>(Cm), Dp, sin, sout, static_cast<T*>(y), S, H, P, G, N,
        sx_b, sx_t, sx_h, sdt_b, sdt_t, sdt_h, sB_b, sB_t, sB_g, sC_b, sC_t, sC_g,
        sA_b, sA_h, sD_b, sD_h);
  } else {
    ssd_scan_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), dtp, Ap, static_cast<const float*>(Bm),
        static_cast<const float*>(Cm), Dp, sin, sout, static_cast<float*>(y), S, H, P, G,
        N, sx_b, sx_t, sx_h, sdt_b, sdt_t, sdt_h, sB_b, sB_t, sB_g, sC_b, sC_t, sC_g,
        sA_b, sA_h, sD_b, sD_h);
  }
  return static_cast<int>(cudaGetLastError());
}
