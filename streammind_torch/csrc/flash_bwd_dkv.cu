// FlashAttention-2 backward, the dK/dV half: for each key j,
//   dV_j = sum_i P_ij dO_i,   dK_j = sum_i dS_ij (scale * q_i),
// with P = exp(S - lse) recomputed from the forward's saved row lse and
// dS = P * (dO V^T - delta), summed over every query head of the key's GQA
// group.
//
// Replaces the JAX package's ops/attention.py::_flash_bwd_dkv_kernel (reached
// by the custom-vjp backward _flash_mha_bwd of flash_mha) together with the
// GQA reshape-sum that follows it there, which training runs once in the
// backward of every decoder layer.
//
// Arithmetic, as the TPU kernel does it: q is cast to fp32 and scaled
// before the dot; p = exp(s - lse) where the key is visible (k < kv_len, and
// k <= q when causal), else 0; dV and dK accumulate in fp32; the causal loop
// starts at the first query tile that can see the key tile.
//
// Design change from the TPU kernel: the TPU grid is (B*H, key blocks) and
// writes an fp32 (B*H, Sk, D) dK and dV per QUERY head, which the wrapper
// then sums over each group of H/Hkv heads and casts to k's dtype.  Here one
// block owns (batch, kv head, 32 keys) and loops over the H/Hkv query heads
// of its group itself, so the group sum happens in the block's fp32
// registers: no (B*H, Sk, D) fp32 transient, no second pass, no atomics,
// and dK and dV are each written once, in k's dtype.  The sum is the same;
// only its order differs (per tile instead of per head).
//
// Bound on the H100: at the training shape (Sq = Sk = 2048, 32 heads, D 128,
// causal) the work is four (Sq x Sk x D) matrix products over the visible
// half, ~69 GFLOP a layer, so it is operation-bound at tensor-core rates.
// This first version uses CUDA-core fp32 FMAs (no wgmma yet).  Bytes: q, dO,
// lse and delta are streamed once per key tile from the causal start on, K
// and V tiles are read once and stay in shared memory, and nothing of size
// (Sq, Sk) leaves the block.
//
// Design: one block of 256 threads per (batch, kv head, 32 keys).  Per
// (query head, 64-row query tile) the block stages pre-scaled q and dO,
// computes S and dO V^T (thread -> one key, 8 rows), puts P and dS in
// shared memory, then each thread adds them into its head-dim column of dK
// and dV for 32 / (256 / D) keys held in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 32;  // keys per block
constexpr int kBQ = 64;  // query rows per tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     const int* __restrict__ kv_len, int Sq, int Sk, int H, int Hkv, int causal,
                     long long qsb, long long qss, long long qsh,
                     long long ksb, long long kss, long long ksh,
                     long long vsb, long long vss, long long vsh,
                     long long dsb, long long dss, long long dsh, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                  // kBK x (D + 1)
  float* vs = ks + kBK * (D + 1);    // kBK x (D + 1)
  float* qs = vs + kBK * (D + 1);    // kBQ x D, pre-scaled q
  float* dos = qs + kBQ * D;         // kBQ x D, dO
  float* p_s = dos + kBQ * D;        // kBQ x kBK, P
  float* ds_s = p_s + kBQ * kBK;     // kBQ x kBK, dS
  float* lse_s = ds_s + kBQ * kBK;   // kBQ
  float* dlt_s = lse_s + kBQ;        // kBQ

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kBK;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int group = H / Hkv;
  const int L = min(kv_len[b], Sk);
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  for (int e = tid; e < kBK * D; e += kThreads) {
    const int j = e / D, d = e % D, kj = k0 + j;
    const bool in = kj < Sk;
    ks[j * (D + 1) + d] = in ? to_f(kb[kj * kss + d]) : 0.f;
    vs[j * (D + 1) + d] = in ? to_f(vb[kj * vss + d]) : 0.f;
  }

  // score mapping: thread -> one key of the block, RPT query rows
  constexpr int RPT = kBQ / (kThreads / kBK);
  const int jl = tid % kBK, ig = tid / kBK;
  // dK/dV mapping: thread -> one head-dim column, RPK keys
  constexpr int RPK = kBK / (kThreads / D);
  const int dl = tid % D, jg = tid / D;
  float dk_acc[RPK], dv_acc[RPK];
#pragma unroll
  for (int r = 0; r < RPK; ++r) dk_acc[r] = dv_acc[r] = 0.f;

  // keys past kv_len are invisible to every query: their dK and dV are 0
  const int n_qt = k0 < L ? (Sq + kBQ - 1) / kBQ : 0;
  const int start = causal ? k0 / kBQ : 0;  // first tile with a row q >= k0

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qb = q + b * qsb + h * qsh;
    const T* dob = dout + b * dsb + h * dsh;
    for (int t = start; t < n_qt; ++t) {
      const int q0 = t * kBQ;
      __syncthreads();
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
          const int i = ig * RPT + r, qi = q0 + i;
          const bool ok = qi < Sq && kpos < L && (!causal || kpos <= qi);
          const float p = ok ? expf(s[r] - lse_s[i]) : 0.f;
          p_s[i * kBK + jl] = p;
          ds_s[i * kBK + jl] = p * (dp[r] - dlt_s[i]);
        }
      }
      __syncthreads();

      for (int i = 0; i < kBQ; ++i) {
        const float qd = qs[i * D + dl], dod = dos[i * D + dl];
#pragma unroll
        for (int r = 0; r < RPK; ++r) {
          const int j = jg * RPK + r;
          dv_acc[r] = fmaf(p_s[i * kBK + j], dod, dv_acc[r]);
          dk_acc[r] = fmaf(ds_s[i * kBK + j], qd, dk_acc[r]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPK; ++r) {
    const int kj = k0 + jg * RPK + r;
    if (kj < Sk) {
      const long long off = (((long long)b * Sk + kj) * Hkv + hk) * D + dl;
      store(dk + off, dk_acc[r]);
      store(dv + off, dv_acc[r]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dk, void* dv, const void* kv_len, int B, int Sq, int Sk,
           int H, int Hkv, int causal, const long long* st, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (2 * (size_t)kBK * (D + 1) + 2 * (size_t)kBQ * D + 2 * (size_t)kBQ * kBK + 2 * kBQ);
  auto kern = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sk + kBK - 1) / kBK, B * Hkv), block(kThreads);
  kern<<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<const int*>(kv_len), Sq, Sk, H, Hkv, causal, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q and dout (B, Sq, H, D), k/v (B, Sk, Hkv, D), each with element strides
// (batch, seq, head) and a contiguous head dim; lse and delta (B, Sq, H)
// fp32 contiguous; kv_len (B,) int32 on the device; dk and dv (B, Sk, Hkv, D)
// contiguous in k's dtype, already summed over each GQA group.  D in
// {64, 128}; B*Hkv <= 65535.  The queries sit at positions 0..Sq-1.
extern "C" int sm_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk, void* dv,
                                const void* kv_len, int B, int Sq, int Sk, int H, int Hkv,
                                int D, int causal, int is_bf16,
                                long long qsb, long long qss, long long qsh,
                                long long ksb, long long kss, long long ksh,
                                long long vsb, long long vss, long long vsh,
                                long long dsb, long long dss, long long dsh,
                                float scale, void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || H % Hkv || B * Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D == 64)
      return launch<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dk, dv, kv_len, B, Sq, Sk, H, Hkv, causal, st, scale, s);
    if (D == 128)
      return launch<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dk, dv, kv_len, B, Sq, Sk, H, Hkv, causal, st, scale, s);
  } else {
    if (D == 64)
      return launch<float, 64>(q, k, v, dout, lse, delta, dk, dv, kv_len, B, Sq, Sk, H, Hkv, causal, st, scale, s);
    if (D == 128)
      return launch<float, 128>(q, k, v, dout, lse, delta, dk, dv, kv_len, B, Sq, Sk, H, Hkv, causal, st, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
