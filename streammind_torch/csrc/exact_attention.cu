// Exact (whole-row fp32 softmax) attention, non-causal: the ViT's attention.
//
// Replaces the JAX package's ops/attention.py::_exact_kernel (entry
// point exact_attention), reached by the vision tower under attn_impl="exact".
//
// Arithmetic, as the TPU kernel and mha_reference do it: s = (q . k) in
// fp32, THEN times scale; a full-row max, exp, sum and divide in fp32;
// probs rounded to v's dtype; PV accumulated in fp32 and rounded once to
// the output dtype.  Keys past Sk are never scored (the TPU kernel masks
// its lane padding to the same effect).
//
// Bound on the H100: at the ViT's (B, 577, 16, 64) the work is ~1.4 GFLOP
// per frame-layer against ~4.7 MB of q/k/v/o, so it is operation-bound at
// tensor-core rates.  This first version uses CUDA-core fp32 FMAs (no
// wgmma), so it is far from that bound; what it does keep is the TPU
// kernel's point: neither the logits nor the probs touch device memory.
//
// Design: one block of 256 threads per (batch, head, tile of QT query
// rows).  The QT x Sk fp32 logits rows live in shared memory (QT = 16 up
// to 2048 keys, 8 up to 4096), so the softmax is over whole rows, not
// online.  K and then V stream through a 64-key shared tile padded to
// D+1 floats per row (no bank conflicts on the per-key dots).  q, k and v
// are read through their strides, so the ViT's strided views of its fused
// qkv projection need no copy; only the head dim must be contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKT = 64;  // keys per shared tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int D, int QT>
__global__ void __launch_bounds__(kThreads)
exact_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int Sq, int Sk, int H, int Hkv,
                       long long qsb, long long qss, long long qsh,
                       long long ksb, long long kss, long long ksh,
                       long long vsb, long long vss, long long vsh, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                    // QT x D
  float* kv = qs + QT * D;             // kKT x (D + 1)
  float* s = kv + kKT * (D + 1);       // QT x Sk logits, then probs

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QT;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  for (int e = tid; e < QT * D; e += kThreads) {
    const int i = e / D, d = e % D, qi = q0 + i;
    qs[e] = qi < Sq ? to_f(qb[qi * qss + d]) : 0.f;
  }

  // ---- logits: thread -> one key of the tile, RPT query rows -------------
  constexpr int RPT = QT / (kThreads / kKT);
  const int jl = tid % kKT, ig = tid / kKT;
  for (int k0 = 0; k0 < Sk; k0 += kKT) {
    __syncthreads();
    for (int e = tid; e < kKT * D; e += kThreads) {
      const int j = e / D, d = e % D, kj = k0 + j;
      kv[j * (D + 1) + d] = kj < Sk ? to_f(kb[kj * kss + d]) : 0.f;
    }
    __syncthreads();
    const int kj = k0 + jl;
    if (kj < Sk) {
      float acc[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) acc[r] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float kd = kv[jl * (D + 1) + d];
#pragma unroll
        for (int r = 0; r < RPT; ++r) acc[r] = fmaf(qs[(ig * RPT + r) * D + d], kd, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) s[(ig * RPT + r) * Sk + kj] = acc[r] * scale;
    }
  }
  __syncthreads();

  // ---- whole-row softmax: one warp per row ------------------------------
  const int warp = tid / 32, lane = tid % 32;
  for (int i = warp; i < QT; i += kThreads / 32) {
    float* row = s + i * Sk;
    float m = -INFINITY;
    for (int j = lane; j < Sk; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < Sk; j += 32) {
      const float p = expf(row[j] - m);
      row[j] = p;
      l += p;
    }
    l = warp_sum(l);
    for (int j = lane; j < Sk; j += 32) row[j] = round_to(row[j] / l, v);
  }

  // ---- PV: thread -> one head-dim column, RPT2 query rows ---------------
  constexpr int RPT2 = QT / (kThreads / D);
  const int dl = tid % D, ig2 = tid / D;
  float acc[RPT2];
#pragma unroll
  for (int r = 0; r < RPT2; ++r) acc[r] = 0.f;
  for (int k0 = 0; k0 < Sk; k0 += kKT) {
    __syncthreads();
    for (int e = tid; e < kKT * D; e += kThreads) {
      const int j = e / D, d = e % D, kj = k0 + j;
      kv[j * (D + 1) + d] = kj < Sk ? to_f(vb[kj * vss + d]) : 0.f;
    }
    __syncthreads();
    const int nk = min(kKT, Sk - k0);
    for (int j = 0; j < nk; ++j) {
      const float vd = kv[j * (D + 1) + dl];
#pragma unroll
      for (int r = 0; r < RPT2; ++r)
        acc[r] = fmaf(s[(ig2 * RPT2 + r) * Sk + k0 + j], vd, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < RPT2; ++r) {
    const int qi = q0 + ig2 * RPT2 + r;
    if (qi < Sq) store(o + (((long long)b * Sq + qi) * H + h) * D + dl, acc[r]);
  }
}

template <typename T, int D, int QT>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
           int H, int Hkv, const long long* st, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)QT * D + (size_t)kKT * (D + 1) + (size_t)QT * Sk);
  auto kern = exact_attention_kernel<T, D, QT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + QT - 1) / QT, B * H), block(kThreads);
  kern<<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, H, Hkv, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
             int H, int Hkv, const long long* st, float scale, cudaStream_t stream) {
  if (Sk <= 2048) return launch<T, D, 16>(q, k, v, o, B, Sq, Sk, H, Hkv, st, scale, stream);
  return launch<T, D, 8>(q, k, v, o, B, Sq, Sk, H, Hkv, st, scale, stream);
}

}  // namespace

// q (B, Sq, H, D), k/v (B, Sk, Hkv, D), each with element strides
// (batch, seq, head) and a contiguous head dim; o (B, Sq, H, D) contiguous
// in q's dtype.  D in {64, 128}; 1 <= Sk <= 4096; B*H <= 65535.
extern "C" int sm_exact_attention(const void* q, const void* k, const void* v, void* o,
                                  int B, int Sq, int Sk, int H, int Hkv, int D, int is_bf16,
                                  long long qsb, long long qss, long long qsh,
                                  long long ksb, long long kss, long long ksh,
                                  long long vsb, long long vss, long long vsh,
                                  float scale, void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  if (B < 1 || Sq < 1 || Sk < 1 || Sk > 4096 || Hkv < 1 || H % Hkv || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D == 64) return launch_d<__nv_bfloat16, 64>(q, k, v, o, B, Sq, Sk, H, Hkv, st, scale, s);
    if (D == 128) return launch_d<__nv_bfloat16, 128>(q, k, v, o, B, Sq, Sk, H, Hkv, st, scale, s);
  } else {
    if (D == 64) return launch_d<float, 64>(q, k, v, o, B, Sq, Sk, H, Hkv, st, scale, s);
    if (D == 128) return launch_d<float, 128>(q, k, v, o, B, Sq, Sk, H, Hkv, st, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
