// Mamba-1 selective-scan forward over L steps, with the fp32 state carried
// in registers: y and the last state.
//
// Replaces the JAX package's ops/scan.py::_scan_kernel (entry point
// selective_scan_pallas, dispatch selective_scan(impl="pallas")): the
// burst catch-up's chunked projector scan (perceive_burst ->
// mamba_project_chunk -> video_mamba_forward(state=...)).  Like
// selective_scan_pallas around its pallas_call, it also applies
// softplus(dt + dt_bias), + D*u, * silu(z) and the cast to u's dtype.
//
// Bound on the H100: bytes (u, dt, z read once, y written once, A and the
// state in and out; ~6 fp32 operations and one exp for each (channel,
// state, step), under a byte's worth of the card's fp32 rate).  Each step
// depends on the last, so the time loop is sequential in each thread; the
// channels and the batch give the parallelism.
//
// Design: grid (channel blocks of 64, batch); one thread owns one channel
// and keeps its N <= 16 states and its row of A in registers across the
// whole time loop.  The block stages B_t and C_t, which every channel
// shares, in shared memory in chunks of 64 steps.  u, dt and z are read
// through the strides the caller passes (the projections produce them as
// (B, L, D) with channels contiguous, so neighbouring threads read
// neighbouring addresses and no copy is made); y is written (B, L, D) with
// channels contiguous.  Arithmetic follows the plain version step by step:
// softplus is log(1 + e^x) without a cut-over (max(x, 0) + log1p(e^-|x|)),
// exp is the accurate expf, and the state update h*dA + (dt*u)*B is kept
// from contracting into an fma, as the plain version rounds it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kMaxN = 16;
constexpr int kChunk = 64;

enum Flags { kHasZ = 1, kHasD = 2, kHasBias = 4, kSoftplus = 8, kHasH0 = 16 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float softplus_f(float x) {
  return __fadd_rn(fmaxf(x, 0.f), log1pf(expf(-fabsf(x))));
}

struct Strides {
  long long b, c, t;  // batch, channel (or state), time
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                      const T* __restrict__ z, const float* __restrict__ A,
                      const T* __restrict__ Bm, const T* __restrict__ Cm,
                      const float* __restrict__ Dv, const float* __restrict__ dt_bias,
                      const float* __restrict__ h0, T* __restrict__ y,
                      float* __restrict__ h_out, int dim, int len, int N, int flags,
                      Strides su, Strides sdt, Strides sz, Strides sB, Strides sC) {
  __shared__ float Bs[kMaxN][kChunk];
  __shared__ float Cs[kMaxN][kChunk];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < dim;

  float h[kMaxN], a[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    h[n] = 0.f;
    a[n] = 0.f;
    if (live && n < N) {
      a[n] = A[(size_t)d * N + n];
      if (flags & kHasH0) h[n] = h0[((size_t)b * dim + d) * N + n];
    }
  }
  const float Dd = (live && (flags & kHasD)) ? Dv[d] : 0.f;
  const float bias = (live && (flags & kHasBias)) ? dt_bias[d] : 0.f;
  const T* ub = u + b * su.b + (long long)d * su.c;
  const T* dtb = dt + b * sdt.b + (long long)d * sdt.c;
  const T* zb = (flags & kHasZ) ? z + b * sz.b + (long long)d * sz.c : nullptr;
  const T* Bb = Bm + b * sB.b;
  const T* Cb = Cm + b * sC.b;

  for (int t0 = 0; t0 < len; t0 += kChunk) {
    const int tc = min(kChunk, len - t0);
    __syncthreads();  // the previous chunk is read by every thread
    for (int i = threadIdx.x; i < N * tc; i += kThreads) {
      const int n = i / tc, tt = i - n * tc;
      Bs[n][tt] = to_f(Bb[n * sB.c + (t0 + tt) * sB.t]);
      Cs[n][tt] = to_f(Cb[n * sC.c + (t0 + tt) * sC.t]);
    }
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < tc; ++tt) {
      const long long t = t0 + tt;
      const float uv = to_f(ub[t * su.t]);
      float dv = to_f(dtb[t * sdt.t]);
      if (flags & kHasBias) dv = __fadd_rn(dv, bias);
      if (flags & kSoftplus) dv = softplus_f(dv);
      const float du = __fmul_rn(dv, uv);
      float yv = 0.f;
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) {
        if (n < N) {
          const float dA = expf(__fmul_rn(dv, a[n]));
          h[n] = __fadd_rn(__fmul_rn(h[n], dA), __fmul_rn(du, Bs[n][tt]));
          yv = fmaf(h[n], Cs[n][tt], yv);
        }
      }
      if (flags & kHasD) yv = __fadd_rn(yv, __fmul_rn(uv, Dd));
      if (flags & kHasZ) {
        const float zv = to_f(zb[t * sz.t]);
        yv = __fmul_rn(yv, __fdiv_rn(zv, __fadd_rn(1.f, expf(-zv))));
      }
      store(y + ((size_t)b * len + t) * dim + d, yv);
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < kMaxN; ++n)
      if (n < N) h_out[((size_t)b * dim + d) * N + n] = h[n];
  }
}

}  // namespace

// u, dt, z (batch, dim, len) and B, C (batch, N, len) in one dtype (fp32 or
// bf16), any strides (in elements); A (dim, N), D and dt_bias (dim,) and h0
// (batch, dim, N) fp32 contiguous; z, D, dt_bias and h0 may be null (flags
// say which are given).  Writes y (batch, len, dim) in u's dtype and h_out
// (batch, dim, N) fp32, both contiguous.  1 <= N <= 16, len >= 1.
extern "C" int sm_selective_scan(
    const void* u, const void* dt, const void* z, const void* A, const void* Bm,
    const void* Cm, const void* Dv, const void* dt_bias, const void* h0, void* y,
    void* h_out, int batch, int dim, int len, int N, int is_bf16, int flags,
    long long su_b, long long su_d, long long su_t, long long sdt_b, long long sdt_d,
    long long sdt_t, long long sz_b, long long sz_d, long long sz_t, long long sB_b,
    long long sB_n, long long sB_t, long long sC_b, long long sC_n, long long sC_t,
    void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  if (batch < 1 || batch > 65535 || dim < 1 || len < 1 || N < 1 || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((dim + kThreads - 1) / kThreads, batch), block(kThreads);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Strides su{su_b, su_d, su_t}, sdt{sdt_b, sdt_d, sdt_t}, sz{sz_b, sz_d, sz_t},
      sB{sB_b, sB_n, sB_t}, sC{sC_b, sC_n, sC_t};
  const float* fA = static_cast<const float*>(A);
  const float* fD = static_cast<const float*>(Dv);
  const float* fb = static_cast<const float*>(dt_bias);
  const float* fh0 = static_cast<const float*>(h0);
  float* fh = static_cast<float*>(h_out);
  if (is_bf16) {
    using T = __nv_bfloat16;
    selective_scan_kernel<T><<<grid, block, 0, s>>>(
        static_cast<const T*>(u), static_cast<const T*>(dt), static_cast<const T*>(z), fA,
        static_cast<const T*>(Bm), static_cast<const T*>(Cm), fD, fb, fh0,
        static_cast<T*>(y), fh, dim, len, N, flags, su, sdt, sz, sB, sC);
  } else {
    selective_scan_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(u), static_cast<const float*>(dt),
        static_cast<const float*>(z), fA, static_cast<const float*>(Bm),
        static_cast<const float*>(Cm), fD, fb, fh0, static_cast<float*>(y), fh, dim, len, N,
        flags, su, sdt, sz, sB, sC);
  }
  return (int)cudaGetLastError();
}
