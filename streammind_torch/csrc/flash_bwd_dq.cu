// FlashAttention-2 backward, the dQ half: dQ = scale * sum_j dS_ij K_j with
// P = exp(S - lse) recomputed from the forward's saved row lse and
// dS = P * (dO V^T - delta), delta = rowsum(dO * O).
//
// Replaces the JAX package's ops/attention.py::_flash_bwd_dq_kernel (reached
// by the custom-vjp backward _flash_mha_bwd of flash_mha), which training
// runs once in the backward of every decoder layer.
//
// Arithmetic, as the TPU kernel does it: q is cast to fp32 and scaled BEFORE
// the dot (the forward's lse was taken over the same pre-scaled logits);
// p = exp(s - lse) where the key is visible (k < kv_len, and k <= q when
// causal), else 0 -- never an online max; ds = p * (dp - delta); dQ sums
// ds * K in fp32 over the visible key tiles and is multiplied by the scale
// once at the end, then rounded once to q's dtype.
//
// Bound on the H100: at the training shape (Sq = Sk = 2048, 32 heads, D 128,
// causal) the work is three (Sq x Sk x D) matrix products over the visible
// half, ~52 GFLOP a layer, so it is operation-bound at tensor-core rates.
// This first version uses CUDA-core fp32 FMAs (no wgmma yet).  What it does
// about the bytes: K and V are read in their own (B, Sk, Hkv, D) layout
// through strides (no transpose or padding), each block stops at the last
// key tile its rows can see, and the (Sq, Sk) probabilities never leave
// shared memory.
//
// Design: one block of 256 threads per (batch, head, 32 query rows); GQA
// maps head h to kv head h / (H / Hkv).  The block keeps its pre-scaled q
// and dO rows and their lse and delta in shared memory, streams K and V
// tiles of 64 keys (rows padded to D+1 floats so the per-key dot products
// are free of bank conflicts), puts the tile's dS in shared memory, and
// accumulates dQ in registers (one head-dim column, RPT rows a thread).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 32;  // query rows per block
constexpr int kBK = 64;  // keys per tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    const int* __restrict__ kv_len, int Sq, int Sk, int H, int Hkv, int causal,
                    long long qsb, long long qss, long long qsh,
                    long long ksb, long long kss, long long ksh,
                    long long vsb, long long vss, long long vsh,
                    long long dsb, long long dss, long long dsh, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                  // kBQ x D, pre-scaled q
  float* dos = qs + kBQ * D;         // kBQ x D, dO
  float* ks = dos + kBQ * D;         // kBK x (D + 1)
  float* vs = ks + kBK * (D + 1);    // kBK x (D + 1)
  float* ds_s = vs + kBK * (D + 1);  // kBQ x kBK, this tile's dS
  float* lse_s = ds_s + kBQ * kBK;   // kBQ
  float* dlt_s = lse_s + kBQ;        // kBQ

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const T* qb = q + b * qsb + h * qsh;
  const T* dob = dout + b * dsb + h * dsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;
  const int L = min(kv_len[b], Sk);

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int i = e / D, d = e % D, qi = q0 + i;
    const bool in = qi < Sq;
    qs[e] = in ? to_f(qb[qi * qss + d]) * scale : 0.f;
    dos[e] = in ? to_f(dob[qi * dss + d]) : 0.f;
  }
  if (tid < kBQ) {
    const int qi = q0 + tid;
    const long long row = ((long long)b * Sq + qi) * H + h;
    lse_s[tid] = qi < Sq ? lse[row] : 0.f;
    dlt_s[tid] = qi < Sq ? delta[row] : 0.f;
  }

  // score mapping: thread -> one key of the tile, RPT query rows
  constexpr int RPT = kBQ / (kThreads / kBK);
  const int jl = tid % kBK, ig = tid / kBK;
  // dQ mapping: thread -> one head-dim column, RPT2 query rows
  constexpr int RPT2 = kBQ / (kThreads / D);
  const int dl = tid % D, ig2 = tid / D;
  float acc[RPT2];
#pragma unroll
  for (int r = 0; r < RPT2; ++r) acc[r] = 0.f;

  const int lim = causal ? min(q0 + kBQ, L) : L;
  const int n_kb = lim > 0 ? min((Sk + kBK - 1) / kBK, (lim + kBK - 1) / kBK) : 0;

  for (int t = 0; t < n_kb; ++t) {
    const int k0 = t * kBK;
    __syncthreads();
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int j = e / D, d = e % D, kj = k0 + j;
      const bool in = kj < Sk;
      ks[j * (D + 1) + d] = in ? to_f(kb[kj * kss + d]) : 0.f;
      vs[j * (D + 1) + d] = in ? to_f(vb[kj * vss + d]) : 0.f;
    }
    __syncthreads();

    {
      float s[RPT], dp[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) s[r] = dp[r] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float kd = ks[jl * (D + 1) + d], vd = vs[jl * (D + 1) + d];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int i = ig * RPT + r;
          s[r] = fmaf(qs[i * D + d], kd, s[r]);
          dp[r] = fmaf(dos[i * D + d], vd, dp[r]);
        }
      }
      const int kpos = k0 + jl;
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int i = ig * RPT + r;
        const bool ok = kpos < L && (!causal || kpos <= q0 + i);
        const float p = ok ? expf(s[r] - lse_s[i]) : 0.f;
        ds_s[i * kBK + jl] = p * (dp[r] - dlt_s[i]);
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < RPT2; ++r) {
      const int i = ig2 * RPT2 + r;
      float a = 0.f;
      for (int j = 0; j < kBK; ++j) a = fmaf(ds_s[i * kBK + j], ks[j * (D + 1) + dl], a);
      acc[r] += a;
    }
  }

#pragma unroll
  for (int r = 0; r < RPT2; ++r) {
    const int qi = q0 + ig2 * RPT2 + r;
    if (qi < Sq) store(dq + (((long long)b * Sq + qi) * H + h) * D + dl, acc[r] * scale);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, const void* kv_len, int B, int Sq, int Sk, int H,
           int Hkv, int causal, const long long* st, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (2 * (size_t)kBQ * D + 2 * (size_t)kBK * (D + 1) + (size_t)kBQ * kBK + 2 * kBQ);
  auto kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H), block(kThreads);
  kern<<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), static_cast<const int*>(kv_len),
      Sq, Sk, H, Hkv, causal, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q and dout (B, Sq, H, D), k/v (B, Sk, Hkv, D), each with element strides
// (batch, seq, head) and a contiguous head dim; lse and delta (B, Sq, H)
// fp32 contiguous; kv_len (B,) int32 on the device; dq (B, Sq, H, D)
// contiguous in q's dtype.  D in {64, 128}; B*H <= 65535.  The queries sit
// at positions 0..Sq-1 (no q_offset: the training backward has none).
extern "C" int sm_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq,
                               const void* kv_len, int B, int Sq, int Sk, int H, int Hkv,
                               int D, int causal, int is_bf16,
                               long long qsb, long long qss, long long qsh,
                               long long ksb, long long kss, long long ksh,
                               long long vsb, long long vss, long long vsh,
                               long long dsb, long long dss, long long dsh,
                               float scale, void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || H % Hkv || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D == 64)
      return launch<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq, kv_len, B, Sq, Sk, H, Hkv, causal, st, scale, s);
    if (D == 128)
      return launch<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dq, kv_len, B, Sq, Sk, H, Hkv, causal, st, scale, s);
  } else {
    if (D == 64)
      return launch<float, 64>(q, k, v, dout, lse, delta, dq, kv_len, B, Sq, Sk, H, Hkv, causal, st, scale, s);
    if (D == 128)
      return launch<float, 128>(q, k, v, dout, lse, delta, dq, kv_len, B, Sq, Sk, H, Hkv, causal, st, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
