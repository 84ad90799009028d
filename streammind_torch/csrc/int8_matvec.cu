// Fused int8 weight-only matvec: y = x @ W^T * scale.
//
// Replaces the JAX package's ops/int8_matvec.py::_int8_matvec_kernel (entry
// point int8_matvec): the linears of the int8 gate (quantize_gate="int8")
// and of the int8 decoder (quantize_text_params(bits=8)) at <= 8 tokens.
//
// Bound on the H100: bytes.  At most 8 tokens share each weight row, so the
// kernel does ~2 flops per weight byte for each token, far under the ~295
// flops/byte the card needs before compute is the limit.  The int8 weight
// (out x in bytes) is read once from device memory; x (<= 8 rows, up to
// 14336 wide: more than shared memory holds at fp32) is read through L1/L2.
//
// Design: one warp per output row, eight rows per block.  Each lane streams
// 16 weight bytes per step with one 16-byte load, sign-extends them to fp32
// in registers and reads the 16 matching x values of each token with
// 16-byte loads.  x keeps its own precision (fp32, or bf16 widened exactly),
// the sum is fp32, the warp sum is scaled by the row's fp32 scale and
// written once in x's dtype.  Rows whose width is not a multiple of 16 bytes
// take a byte-at-a-time loop.  Unlike the TPU kernel, x is never rounded to
// bf16 and the output tile is one row whatever `out` is.

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

// byte j (0..3) of a 32-bit word, sign-extended
__device__ __forceinline__ float sbyte(unsigned int word, int j) {
  return (float)(((int)(word << (24 - 8 * j))) >> 24);
}

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
int8_matvec_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, T* __restrict__ y,
                   int B, int din, int dout) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= dout) return;
  const int8_t* wr = w + (size_t)row * din;

  float acc[kMaxB];
#pragma unroll
  for (int b = 0; b < kMaxB; ++b) acc[b] = 0.f;

  if ((din & 15) == 0) {
    const uint4* wv = reinterpret_cast<const uint4*>(wr);
    const int nv = din >> 4;
    for (int c = lane; c < nv; c += 32) {
      const uint4 pk = __ldg(wv + c);
      const unsigned int words[4] = {pk.x, pk.y, pk.z, pk.w};
      float wf[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int j = 0; j < 4; ++j) wf[4 * q + j] = sbyte(words[q], j);
      }
#pragma unroll
      for (int b = 0; b < kMaxB; ++b) {
        if (b < B) {
          float xv[16];
          load16(x + (size_t)b * din + c * 16, xv);
          float s = acc[b];
#pragma unroll
          for (int k = 0; k < 16; ++k) s = fmaf(xv[k], wf[k], s);
          acc[b] = s;
        }
      }
    }
  } else {
    for (int c = lane; c < din; c += 32) {
      const float wv = (float)wr[c];
#pragma unroll
      for (int b = 0; b < kMaxB; ++b) {
        if (b < B) acc[b] = fmaf(to_f(x[(size_t)b * din + c]), wv, acc[b]);
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

// x (B, din) fp32 or bf16, contiguous; w (dout, din) int8, contiguous;
// scale (dout,) fp32; y (B, dout) in x's dtype.  1 <= B <= 8.  With din a
// multiple of 16, x and w must be 16-byte aligned (the wrapper checks).
extern "C" int sm_int8_matvec(const void* x, const void* w, const void* scale, void* y,
                              int B, int din, int dout, int is_bf16, void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  if (B < 1 || B > kMaxB || din < 1 || dout < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((dout + kWarps - 1) / kWarps), block(kWarps * 32);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    int8_matvec_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), B, din, dout);
  } else {
    int8_matvec_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<float*>(y), B, din, dout);
  }
  return (int)cudaGetLastError();
}
