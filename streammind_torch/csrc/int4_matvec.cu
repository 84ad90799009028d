// Fused int4 weight-only matvec: y = x @ unpack(W)^T * scale.
//
// Replaces the JAX package's ops/int4_matvec.py::_int4_matvec_kernel
// (entry point int4_matvec), the gate LM's linears under quantize_gate="int4".
//
// Bound on the H100: bytes.  At most 8 tokens share each weight row, so
// the kernel does ~4 flops per packed byte, far under the ~295 flops/byte
// the card needs before compute is the limit.  The packed weight (out x
// in/2 bytes) is read once from device memory; x (<= 8 rows) stays in L1/L2.
//
// Design: one warp per output row, eight rows per block.  Each lane streams
// 16 packed bytes per step with one 16-byte load and reads the 16 matching
// x values of each half with 16-byte loads.  Pack layout (column-halved, as
// utils/quantize.py writes it): the low nibble of byte c is input column c,
// the high nibble is column in/2 + c, both sign-extended.  x is taken in
// fp32 and accumulated in fp32, the warp sum is scaled by the row's fp32
// scale and written once in x's dtype.  Rows whose packed width is not a
// multiple of 16 bytes take a byte-at-a-time loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxB = 8;
constexpr int kWarps = 8;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// sign-extended low / high nibble of one packed byte
__device__ __forceinline__ float nib_lo(int byte) { return (float)(((byte & 0xF) ^ 8) - 8); }
__device__ __forceinline__ float nib_hi(int byte) { return (float)((((byte >> 4) & 0xF) ^ 8) - 8); }

// 16 consecutive values of x as fp32 (p 16-byte aligned)
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4* v = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 f = __ldg(v + i);
    out[4 * i] = f.x; out[4 * i + 1] = f.y; out[4 * i + 2] = f.z; out[4 * i + 3] = f.w;
  }
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint4 u = __ldg(v + i);
    const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // bf16 -> fp32 is the bf16 bits in the high half of the fp32 word
      out[8 * i + 2 * j] = __uint_as_float(w[j] << 16);
      out[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
int4_matvec_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, T* __restrict__ y,
                   int B, int din, int dout) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= dout) return;
  const int half = din / 2;
  const int8_t* wr = w + (size_t)row * half;

  float acc[kMaxB];
#pragma unroll
  for (int b = 0; b < kMaxB; ++b) acc[b] = 0.f;

  if ((half & 15) == 0) {
    const uint4* wv = reinterpret_cast<const uint4*>(wr);
    const int nv = half >> 4;
    for (int c = lane; c < nv; c += 32) {
      const uint4 pk = __ldg(wv + c);
      const unsigned int words[4] = {pk.x, pk.y, pk.z, pk.w};
      float lo[16], hi[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int byte = (int)((words[q] >> (8 * j)) & 0xFFu);
          lo[4 * q + j] = nib_lo(byte);
          hi[4 * q + j] = nib_hi(byte);
        }
      }
#pragma unroll
      for (int b = 0; b < kMaxB; ++b) {
        if (b < B) {
          float xl[16], xh[16];
          load16(x + (size_t)b * din + c * 16, xl);
          load16(x + (size_t)b * din + half + c * 16, xh);
          float s = acc[b];
#pragma unroll
          for (int k = 0; k < 16; ++k) {
            s = fmaf(xl[k], lo[k], s);
            s = fmaf(xh[k], hi[k], s);
          }
          acc[b] = s;
        }
      }
    }
  } else {
    for (int c = lane; c < half; c += 32) {
      const int byte = (int)(uint8_t)wr[c];
      const float lo = nib_lo(byte), hi = nib_hi(byte);
#pragma unroll
      for (int b = 0; b < kMaxB; ++b) {
        if (b < B) {
          acc[b] = fmaf(to_f(x[(size_t)b * din + c]), lo, acc[b]);
          acc[b] = fmaf(to_f(x[(size_t)b * din + half + c]), hi, acc[b]);
        }
      }
    }
  }

#pragma unroll
  for (int b = 0; b < kMaxB; ++b) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], off);
  }
  if (lane == 0) {
    const float s = scale[row];
    for (int b = 0; b < B; ++b) store(y + (size_t)b * dout + row, acc[b] * s);
  }
}

}  // namespace

// x (B, din) fp32 or bf16, contiguous; w (dout, din/2) int8, contiguous;
// scale (dout,) fp32; y (B, dout) in x's dtype.  1 <= B <= 8, din even.
extern "C" int sm_int4_matvec(const void* x, const void* w, const void* scale, void* y,
                              int B, int din, int dout, int is_bf16, void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  if (B < 1 || B > kMaxB || din < 2 || (din & 1) || dout < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((dout + kWarps - 1) / kWarps), block(kWarps * 32);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    int4_matvec_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), B, din, dout);
  } else {
    int4_matvec_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<float*>(y), B, din, dout);
  }
  return (int)cudaGetLastError();
}
