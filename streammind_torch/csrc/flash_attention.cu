// Blockwise online-softmax attention forward (flash), causal prefill over a
// KV cache, and the training forward that also returns the row lse.
//
// Replaces the JAX package's ops/attention.py::_flash_kernel_nolse (entry
// point flash_attention), which cached prefill calls in every decoder layer,
// and its lse-returning twin _flash_kernel (entry _flash_fwd_with_lse), the
// forward of the differentiable flash_mha that training runs in every
// decoder layer and again in its rematerialized recompute.  A null lse
// pointer is the inference kernel; otherwise each row's
// lse = max(m, -1e30) + log(max(l, 1e-30)) is written in fp32 to (B, Sq, H),
// one float a row (the TPU kernel replicates it over 128 lanes for Mosaic's
// tiling; nothing here needs that), so a row with no visible key gives a
// finite lse and output 0, as on the TPU.
//
// Arithmetic, as the TPU kernel does it: q is cast to fp32 and scaled
// BEFORE the dot; per key tile the running (m, l, acc) are updated in fp32
// with m_new = max(m, rowmax(s)), p = exp(s - m_new), alpha = exp(m - m_new);
// masked logits are -1e30; the output is acc / max(l, 1e-30), so a row with
// no visible key gives 0.
//
// Bound on the H100: at the 2048-token prefill bucket the work is ~34
// GFLOP per layer (causal, 32 heads, D 128), so it is operation-bound at
// tensor-core rates; at the small buckets it is bound by reading the
// visible K/V rows.  This first version uses CUDA-core fp32 FMAs (no wgmma
// yet).  What it does about the bytes: it reads the cache in its own
// (B, C, Hkv, D) layout through strides and stops at the last visible key
// tile, so the 8192-row ring is neither transposed, padded nor read past
// min(kv_len, q_offset + tile end) — the JAX wrapper transposes and pads
// the whole cache per layer.
//
// Design: one block of 256 threads per (batch, head, 32 query rows); GQA
// maps head h to kv head h / (H / Hkv).  Each block loads its row's kv_len
// and q_offset from device memory itself.  K (padded to D+1 floats a row)
// and V tiles of 64 keys go through shared memory; scores and probabilities
// of the tile stay in shared memory; acc lives in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 32;  // query rows per block
constexpr int kBK = 64;  // keys per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                       const int* __restrict__ kv_len, const int* __restrict__ q_offset,
                       int Sq, int Sk, int H, int Hkv, int causal,
                       long long qsb, long long qss, long long qsh,
                       long long ksb, long long kss, long long ksh,
                       long long vsb, long long vss, long long vsh, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                  // kBQ x D, pre-scaled
  float* ks = qs + kBQ * D;          // kBK x (D + 1)
  float* vs = ks + kBK * (D + 1);    // kBK x D
  float* ps = vs + kBK * D;          // kBQ x kBK scores, then probs
  float* m_s = ps + kBQ * kBK;       // running max
  float* l_s = m_s + kBQ;            // running sum
  float* a_s = l_s + kBQ;            // this tile's rescale factor

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;
  const int L = min(kv_len[b], Sk);
  const int off = q_offset[b];

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int i = e / D, d = e % D, qi = q0 + i;
    qs[e] = qi < Sq ? to_f(qb[qi * qss + d]) * scale : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // score mapping: thread -> one key of the tile, RPT query rows
  constexpr int RPT = kBQ / (kThreads / kBK);
  const int jl = tid % kBK, ig = tid / kBK;
  // PV mapping: thread -> one head-dim column, RPT2 query rows
  constexpr int RPT2 = kBQ / (kThreads / D);
  const int dl = tid % D, ig2 = tid / D;
  float acc[RPT2];
#pragma unroll
  for (int r = 0; r < RPT2; ++r) acc[r] = 0.f;

  const int lim = causal ? min(q0 + kBQ + off, L) : L;
  const int n_kb = lim > 0 ? min((Sk + kBK - 1) / kBK, (lim + kBK - 1) / kBK) : 0;
  const int warp = tid / 32, lane = tid % 32;

  for (int t = 0; t < n_kb; ++t) {
    const int k0 = t * kBK;
    __syncthreads();
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int j = e / D, d = e % D, kj = k0 + j;
      const bool in = kj < Sk;
      ks[j * (D + 1) + d] = in ? to_f(kb[kj * kss + d]) : 0.f;
      vs[j * D + d] = in ? to_f(vb[kj * vss + d]) : 0.f;
    }
    __syncthreads();

    {
      float sacc[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) sacc[r] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float kd = ks[jl * (D + 1) + d];
#pragma unroll
        for (int r = 0; r < RPT; ++r) sacc[r] = fmaf(qs[(ig * RPT + r) * D + d], kd, sacc[r]);
      }
      const int kpos = k0 + jl;
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int i = ig * RPT + r;
        const bool ok = kpos < L && (!causal || kpos <= q0 + i + off);
        ps[i * kBK + jl] = ok ? sacc[r] : kNegInf;
      }
    }
    __syncthreads();

    // online-softmax row update: one warp per row, two keys per lane
    for (int i = warp; i < kBQ; i += kThreads / 32) {
      const float x0 = ps[i * kBK + lane], x1 = ps[i * kBK + lane + 32];
      const float m_prev = m_s[i];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      ps[i * kBK + lane] = p0;
      ps[i * kBK + lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[i] = l_s[i] * alpha + sum;
        m_s[i] = m_new;
        a_s[i] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < RPT2; ++r) {
      const int i = ig2 * RPT2 + r;
      float pv = 0.f;
      for (int j = 0; j < kBK; ++j) pv = fmaf(ps[i * kBK + j], vs[j * D + dl], pv);
      acc[r] = acc[r] * a_s[i] + pv;
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < RPT2; ++r) {
    const int i = ig2 * RPT2 + r, qi = q0 + i;
    if (qi < Sq)
      store(o + (((long long)b * Sq + qi) * H + h) * D + dl, acc[r] / fmaxf(l_s[i], 1e-30f));
  }
  if (lse != nullptr && tid < kBQ && q0 + tid < Sq)
    lse[((long long)b * Sq + q0 + tid) * H + h] =
        fmaxf(m_s[tid], kNegInf) + logf(fmaxf(l_s[tid], 1e-30f));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, const void* kv_len,
           const void* q_offset, int B, int Sq, int Sk, int H, int Hkv, int causal,
           const long long* st, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)kBQ * D + (size_t)kBK * (D + 1) + (size_t)kBK * D + (size_t)kBQ * kBK + 3 * kBQ);
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H), block(kThreads);
  kern<<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), static_cast<const int*>(kv_len),
      static_cast<const int*>(q_offset),
      Sq, Sk, H, Hkv, causal, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, D), k/v (B, Sk, Hkv, D), each with element strides
// (batch, seq, head) and a contiguous head dim; kv_len and q_offset (B,)
// int32 on the device; o (B, Sq, H, D) contiguous in q's dtype; lse null
// or (B, Sq, H) fp32 contiguous.  D in {64, 128}; B*H <= 65535.  kv_len is
// clamped to Sk.
extern "C" int sm_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  void* lse, const void* kv_len, const void* q_offset,
                                  int B, int Sq, int Sk, int H, int Hkv, int D,
                                  int causal, int is_bf16,
                                  long long qsb, long long qss, long long qsh,
                                  long long ksb, long long kss, long long ksh,
                                  long long vsb, long long vss, long long vsh,
                                  float scale, void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || H % Hkv || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D == 64)
      return launch<__nv_bfloat16, 64>(q, k, v, o, lse, kv_len, q_offset, B, Sq, Sk, H, Hkv, causal, st, scale, s);
    if (D == 128)
      return launch<__nv_bfloat16, 128>(q, k, v, o, lse, kv_len, q_offset, B, Sq, Sk, H, Hkv, causal, st, scale, s);
  } else {
    if (D == 64)
      return launch<float, 64>(q, k, v, o, lse, kv_len, q_offset, B, Sq, Sk, H, Hkv, causal, st, scale, s);
    if (D == 128)
      return launch<float, 128>(q, k, v, o, lse, kv_len, q_offset, B, Sq, Sk, H, Hkv, causal, st, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
