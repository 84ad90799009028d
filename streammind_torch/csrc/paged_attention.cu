// One-token decode attention over the paged KV pool.
//
// Replaces the TPU paged-attention kernel that the JAX package calls from
// JAX's Pallas library (jax.experimental.pallas.ops.tpu.paged_attention,
// at streaming/paged.py::_paged_decode_attention), once per decoder layer
// in every decode step.  For row b and query head h it is the softmax over
// the first length[b] positions of the row's logical sequence, position t
// at pool[h / (H / Hkv), table[b, t / page], t % page, :].
//
// Arithmetic, as the JAX package's CPU branch (gather + mha_reference)
// does it, not as the TPU path (which pre-scales q in bf16): q and the
// keys in fp32, the scale 1/sqrt(D) applied to the fp32 dot, then an
// online softmax in fp32 (m, l, acc per query head, masked logits -1e30)
// and one rounding of acc / max(l, 1e-30) to q's dtype.  length is
// clamped to the table's width (maxp x page): a finished row of the
// lockstep loop attends at its frozen length + 1, which at a page boundary
// points one page past its table, and the kernel never reads outside the
// table row.
//
// Bound on the H100: bytes — the visible K and V rows (length x Hkv x D x
// 2 elements a row) read once; the operations (4 x H x D a position) are
// ~100x below the tensor-core line.  This first version reads only the
// pages the length covers, each K/V element once, with 16-byte loads, and
// prefetches the next tile into registers while the current one is
// computed.  Its cost: one block per (row, kv head) — K x Hkv blocks, 32
// at K 4 for Mistral-7B on 132 SMs — each walking its row's pages alone,
// so a long row is latency-bound on one SM; splitting the pages across
// blocks (flash-decoding) is the next step.
//
// Design: 256 threads per (row, kv head) block; the block holds the G =
// H / Hkv query heads of its kv head (G <= 8).  Keys go in tiles of 64
// logical positions (any page size): K (rows padded to D+1 floats) and V
// tiles in shared memory as fp32; scores and probabilities in shared
// memory; acc in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;    // logical positions per tile
constexpr int kMaxG = 8;   // query heads per kv head
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 16 bytes of T → 16 / sizeof(T) floats
__device__ __forceinline__ void unpack(const uint4& u, float* dst, float) {
  const float* f = reinterpret_cast<const float*>(&u);
#pragma unroll
  for (int c = 0; c < 4; ++c) dst[c] = f[c];
}
__device__ __forceinline__ void unpack(const uint4& u, float* dst, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float2 f = __bfloat1622float2(h[c]);
    dst[2 * c] = f.x;
    dst[2 * c + 1] = f.y;
  }
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                       const T* __restrict__ pool_v, const int* __restrict__ table,
                       const int* __restrict__ length, T* __restrict__ o,
                       int H, int Hkv, int P, int page, int maxp, float scale) {
  constexpr int VEC = 16 / sizeof(T);          // elements per 16-byte word
  constexpr int WPR = D / VEC;                 // words per K/V row
  constexpr int NW = kBK * WPR / kThreads;     // words a thread fetches per tile and side
  constexpr int R = (kMaxG * D + kThreads - 1) / kThreads;
  static_assert(kBK * WPR % kThreads == 0, "tile words must split evenly over the block");

  extern __shared__ float smem[];
  float* qs = smem;                  // G x D
  float* ks = qs + kMaxG * D;        // kBK x (D + 1)
  float* vs = ks + kBK * (D + 1);    // kBK x D
  float* ps = vs + kBK * D;          // G x kBK scores, then probs
  float* m_s = ps + kMaxG * kBK;     // running max
  float* l_s = m_s + kMaxG;          // running sum
  float* a_s = l_s + kMaxG;          // this tile's rescale factor

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int G = H / Hkv;
  const int L = max(0, min(length[b], maxp * page));
  const int* trow = table + (long long)b * maxp;

  for (int e = tid; e < G * D; e += kThreads)
    qs[e] = to_f(q[((long long)b * H + hk * G) * D + e]);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  uint4 rk[NW], rv[NW];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int n = 0; n < NW; ++n) {
      const int e = tid + n * kThreads, j = e / WPR, w = e % WPR, pos = k0 + j;
      if (pos < L) {
        const long long base =
            (((long long)hk * P + trow[pos / page]) * page + pos % page) * D + w * VEC;
        rk[n] = *reinterpret_cast<const uint4*>(pool_k + base);
        rv[n] = *reinterpret_cast<const uint4*>(pool_v + base);
      } else {
        rk[n] = make_uint4(0u, 0u, 0u, 0u);
        rv[n] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  const int jl = tid % kBK, ig = tid / kBK;
  const int n_t = (L + kBK - 1) / kBK;
  if (n_t > 0) fetch(0);

  for (int t = 0; t < n_t; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's PV is done with ks/vs/ps
#pragma unroll
    for (int n = 0; n < NW; ++n) {
      const int e = tid + n * kThreads, j = e / WPR, w = e % WPR;
      unpack(rk[n], ks + j * (D + 1) + w * VEC, T());
      unpack(rv[n], vs + j * D + w * VEC, T());
    }
    __syncthreads();
    if (t + 1 < n_t) fetch(k0 + kBK);  // next tile's loads fly during this tile

    // scores: thread -> one position of the tile, query heads ig, ig+4, ...
    for (int i = ig; i < G; i += kThreads / kBK) {
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qs[i * D + d], ks[jl * (D + 1) + d], s);
      ps[i * kBK + jl] = k0 + jl < L ? s * scale : kNegInf;
    }
    __syncthreads();

    // online-softmax row update: one warp per query head, two positions a lane
    if (warp < G) {
      const int i = warp;
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
    for (int r = 0; r < R; ++r) {
      const int e = tid + r * kThreads, i = e / D, d = e % D;
      if (i < G) {
        float pv = 0.f;
#pragma unroll 8
        for (int j = 0; j < kBK; ++j) pv = fmaf(ps[i * kBK + j], vs[j * D + d], pv);
        acc[r] = acc[r] * a_s[i] + pv;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = tid + r * kThreads, i = e / D, d = e % D;
    if (i < G)
      store(o + ((long long)b * H + hk * G + i) * D + d, acc[r] / fmaxf(l_s[i], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* pool_k, const void* pool_v, const void* table,
           const void* length, void* o, int K, int H, int Hkv, int P, int page, int maxp,
           float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kMaxG * D + (size_t)kBK * (D + 1) +
                                       (size_t)kBK * D + (size_t)kMaxG * kBK + 3 * kMaxG);
  auto kern = paged_attention_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<K * Hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool_k), static_cast<const T*>(pool_v),
      static_cast<const int*>(table), static_cast<const int*>(length), static_cast<T*>(o), H,
      Hkv, P, page, maxp, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (K, 1, H, D) contiguous; pool_k/pool_v (Hkv, P, page, D) contiguous in
// q's dtype, 16-byte aligned; table (K, maxp) and length (K,) int32 on the
// device; o (K, 1, H, D) contiguous.  D in {64, 128}; H / Hkv <= 8.
extern "C" int sm_paged_attention(const void* q, const void* pool_k, const void* pool_v,
                                  const void* table, const void* length, void* o, int K, int H,
                                  int Hkv, int D, int P, int page, int maxp, int is_bf16,
                                  float scale, void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  if (K < 1 || Hkv < 1 || H % Hkv || H / Hkv > kMaxG || P < 1 || page < 1 || maxp < 1 ||
      (long long)K * Hkv > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<unsigned long long>(pool_k) % 16 ||
      reinterpret_cast<unsigned long long>(pool_v) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D == 64)
      return launch<__nv_bfloat16, 64>(q, pool_k, pool_v, table, length, o, K, H, Hkv, P, page, maxp, scale, s);
    if (D == 128)
      return launch<__nv_bfloat16, 128>(q, pool_k, pool_v, table, length, o, K, H, Hkv, P, page, maxp, scale, s);
  } else {
    if (D == 64)
      return launch<float, 64>(q, pool_k, pool_v, table, length, o, K, H, Hkv, P, page, maxp, scale, s);
    if (D == 128)
      return launch<float, 128>(q, pool_k, pool_v, table, length, o, K, H, Hkv, P, page, maxp, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
