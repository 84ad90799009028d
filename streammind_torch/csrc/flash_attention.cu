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
// finite lse and output 0, as on the TPU.  Per key tile the running
// (m, l, acc) are updated in fp32; masked logits are -1e30; the output is
// acc / max(l, 1e-30).  kv_len is clamped to Sk; GQA maps head h to kv head
// h / (H / Hkv).  The cache is read in its own (B, C, Hkv, D) layout through
// strides and only up to the last visible key tile, so the 8192-row ring is
// neither transposed, padded nor read past min(kv_len, q_offset + tile end).
//
// Two instantiations, chosen by the caller's dtype:
//
// bf16 (every path of the model): tensor cores.  Bound on the H100: at the
// 2048-token bucket the work is ~34 GFLOP a layer (causal, 32 heads, D 128),
// operation-bound; at the small prefill buckets it is bound by reading the
// visible K/V rows.  Design: a block is two warpgroups, 128 rows; a row is
// one (query, head) pair, and the H / Hkv query heads of one kv group are
// packed into the rows (query-major), so a block covers floor(128 / group)
// queries of all heads of its group and each K/V tile is loaded once for
// the whole group; any group of 1 to 128 heads fits, the rows past the
// last whole group (2 of 128 for Qwen2-7B's group of 7) load zeros and
// are not stored.  Q is loaded once; K and V tiles of 64 keys go through a
// two-stage ring in shared memory, loaded a tile ahead with 16-byte cp.async
// by all 256 threads into the 128-byte swizzle of hopper_attention.cuh
// (cp.async rather than TMA: any 16-byte-aligned strides load as they are,
// and no tensor map has to be encoded on the host).  Each warpgroup takes
// S = Q K^T with wgmma (bf16 in, fp32 accumulate), scales the fp32 S by
// scale * log2(e) AFTER the product (a bf16 q cannot carry the TPU kernel's
// fp32 pre-scale), masks only the tiles that cross the causal diagonal or
// kv_len, keeps its rows' (m, l) in registers with quad shuffles and ex2,
// converts P to bf16 in registers and accumulates O += P V with wgmma (V
// read MN-major through the descriptor).  A warpgroup skips the tiles its
// rows cannot see.  The heaviest causal query tiles are launched first.
//
// fp32 (the CPU-vs-card parity runs only): the first version, CUDA-core
// FMAs in the TPU kernel's arithmetic (q cast to fp32 and scaled BEFORE the
// dot; m_new = max(m, rowmax(s)), p = exp(s - m_new), alpha = exp(m - m_new)):
// one block of 256 threads per (batch, head, 32 query rows); K (padded to
// D+1 floats a row) and V tiles of 64 keys go through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_attention.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int kThreads = 256;
constexpr int kBQ = 32;  // query rows per block
constexpr int kBK = 64;  // keys per tile

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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
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
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;
  const int L = min(kv_len[b], Sk);
  const int off = q_offset[b];

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int i = e / D, d = e % D, qi = q0 + i;
    qs[e] = qi < Sq ? qb[qi * qss + d] * scale : 0.f;
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
      ks[j * (D + 1) + d] = in ? kb[kj * kss + d] : 0.f;
      vs[j * D + d] = in ? vb[kj * vss + d] : 0.f;
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
    if (qi < Sq) o[(((long long)b * Sq + qi) * H + h) * D + dl] = acc[r] / fmaxf(l_s[i], 1e-30f);
  }
  if (lse != nullptr && tid < kBQ && q0 + tid < Sq)
    lse[((long long)b * Sq + q0 + tid) * H + h] =
        fmaxf(m_s[tid], kNegInf) + logf(fmaxf(l_s[tid], 1e-30f));
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, const void* kv_len,
           const void* q_offset, int B, int Sq, int Sk, int H, int Hkv, int causal,
           const long long* st, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)kBQ * D + (size_t)kBK * (D + 1) + (size_t)kBK * D + (size_t)kBQ * kBK + 3 * kBQ);
  auto kern = flash_attention_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H), block(kThreads);
  kern<<<grid, block, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), static_cast<const int*>(kv_len),
      static_cast<const int*>(q_offset),
      Sq, Sk, H, Hkv, causal, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale);
  return (int)cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma)
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kRows = 128;    // (query, head) rows a block: two warpgroups of 64
constexpr int kBN = 64;       // keys a tile
constexpr int kThreads = 256;
constexpr int kStages = 2;    // K/V tiles in flight
// two blocks an SM (at most 128 registers a thread, 97 KB of shared memory
// each at D 128): one block's loads and softmax hide behind the other's wgmma
constexpr int kBlocksPerSM = 2;

template <int D>
struct Layout {  // byte offsets in shared memory, from a 1024-aligned base
  static constexpr int kTile = kBN * D * 2;           // one K or V tile
  static constexpr int kQ = 0;                        // kRows x D
  static constexpr int kK = kRows * D * 2;            // the K stages
  static constexpr int kV = kK + kStages * kTile;     // the V stages
  static constexpr int kBytes = kV + kStages * kTile + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                const int* __restrict__ kv_len, const int* __restrict__ q_offset,
                int Sq, int Sk, int H, int Hkv, int causal, int n_qt,
                long long qsb, long long qss, long long qsh,
                long long ksb, long long kss, long long ksh,
                long long vsb, long long vss, long long vsh, float scale_log2) {
  using namespace hopper;
  using Lay = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32, warp = (tid % 128) / 32;
  const int G = H / Hkv, QB = kRows / G, RU = QB * G;  // heads a query, queries a block, rows in use
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int q0 = (n_qt - 1 - blockIdx.y) * QB;  // the heaviest causal tiles first
  const int L = min(kv_len[b], Sk);
  const int off = q_offset[b];
  const bf16* qb = q + b * qsb + (long long)hk * G * qsh;
  const bf16* kb = k + b * ksb + hk * ksh;
  const bf16* vb = v + b * vsb + hk * vsh;

  // keys this block and this warpgroup can see
  const int q_last = min(q0 + QB, Sq) - 1;
  const int lim = causal ? min(q_last + off + 1, L) : L;
  const int n_t = lim > 0 ? (lim + kBN - 1) / kBN : 0;
  const int wg_q0 = q0 + wg * 64 / G, wg_q1 = min(q0 + min(wg * 64 + 63, RU - 1) / G, Sq - 1);
  const int wg_lim = (wg * 64 >= RU || wg_q0 >= Sq) ? 0 : causal ? min(wg_q1 + off + 1, L) : L;

  constexpr int CH = D / 8;  // 16-byte chunks a row
  for (int e = tid; e < kRows * CH; e += kThreads) {
    const int r = e / CH, c = e % CH, qi = q0 + r / G;
    const bool ok = r < RU && qi < Sq;
    cp_async_16(base + Lay::kQ + tile_offset(r, c, kRows),
                ok ? qb + qi * qss + (r % G) * qsh + c * 8 : q, ok);
  }
  auto load_kv = [&](int t, int stage) {
    for (int e = tid; e < kBN * CH; e += kThreads) {
      const int r = e / CH, c = e % CH, kj = t * kBN + r;
      const bool ok = kj < L;
      const uint32_t at = stage * Lay::kTile + tile_offset(r, c, kBN);
      cp_async_16(base + Lay::kK + at, ok ? kb + kj * kss + c * 8 : k, ok);
      cp_async_16(base + Lay::kV + at, ok ? vb + kj * vss + c * 8 : v, ok);
    }
  };
  // the ring: tile t in stage t % kStages, kStages - 1 tiles ahead; one
  // commit group a tile (the first also holds Q)
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_t) load_kv(t, t);
    cp_async_commit();
  }

  // this thread's two rows
  const int r0 = wg * 64 + warp * 16 + lane / 4, r1 = r0 + 8;
  const int qp0 = q0 + r0 / G + off, qp1 = q0 + r1 / G + off;
  const int cq = 2 * (lane % 4);
  float o_acc[D / 2], s[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // m in the log2 domain
  uint32_t pa[4][4];

  for (int t = 0; t < n_t; ++t) {
    if (t + kStages - 1 < n_t) load_kv(t + kStages - 1, (t + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    fence_async_shared();
    __syncthreads();
    const int k0 = t * kBN;
    if (k0 < wg_lim) {
      const uint32_t kt = base + Lay::kK + (t % kStages) * Lay::kTile;
      const uint32_t vt = base + Lay::kV + (t % kStages) * Lay::kTile;
      const uint32_t qt = base + Lay::kQ + wg * 64 * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(s, desc(qt + (kk / 4) * kRows * 128 + (kk % 4) * 32, 16, 1024),
                 desc(kt + (kk / 4) * kBN * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);

      // s holds q.k; the scale enters with the exponent, x = s * scale * log2(e)
      if (k0 + kBN > L || (causal && k0 + kBN - 1 > wg_q0 + off)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int key = k0 + 8 * (i / 4) + cq + (i & 1);
          const int qp = (i & 2) ? qp1 : qp0;
          if (key >= L || (causal && key > qp)) s[i] = kNegInf;
        }
      }
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0) * scale_log2);
      const float mn1 = fmaxf(m1, quad_max(mx1) * scale_log2);
      const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[4 * j] = ex2(fmaf(s[4 * j], scale_log2, -mn0));
        s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], scale_log2, -mn0));
        s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], scale_log2, -mn1));
        s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], scale_log2, -mn1));
        sum0 += s[4 * j] + s[4 * j + 1];
        sum1 += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = l0 * a0 + sum0;  // this thread's share of the row; quad-summed at the end
      l1 = l1 * a1 + sum1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o_acc[4 * j] *= a0;
        o_acc[4 * j + 1] *= a0;
        o_acc[4 * j + 2] *= a1;
        o_acc[4 * j + 3] *= a1;
      }
      p_fragments(s, pa);

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs(o_acc, pa[kk], desc(vt + kk * 16 * 128, kBN * 128, 1024));
      wgmma_commit();
      wgmma_wait();
      fence_regs(o_acc);
    }
    __syncthreads();  // the stage is free for its next load
  }
  cp_async_wait<0>();

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0, qi = q0 + r / G, h = hk * G + r % G;
    if (r >= RU || qi >= Sq) continue;
    const float den = half ? den1 : den0;
    const long long row = ((long long)b * Sq + qi) * H + h;
    bf16* orow = o + row * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + cq) = __floats2bfloat162_rn(
          o_acc[4 * j + 2 * half] / den, o_acc[4 * j + 2 * half + 1] / den);
    if (lse != nullptr && lane % 4 == 0) {
      const float m = half ? m1 : m0, l = half ? l1 : l0;
      lse[row] = (m > -1e29f ? m * kLn2 : kNegInf) + logf(fmaxf(l, 1e-30f));
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, const void* kv_len,
           const void* q_offset, int B, int Sq, int Sk, int H, int Hkv, int causal,
           const long long* st, float scale, cudaStream_t stream) {
  const int QB = kRows / (H / Hkv), n_qt = (Sq + QB - 1) / QB;
  const int smem = Layout<D>::kBytes;
  auto kern = flash_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * Hkv, n_qt), block(kThreads);
  kern<<<grid, block, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), static_cast<const int*>(kv_len),
      static_cast<const int*>(q_offset), Sq, Sk, H, Hkv, causal, n_qt,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale * hopper::kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q (B, Sq, H, D), k/v (B, Sk, Hkv, D), each with element strides
// (batch, seq, head) and a contiguous head dim; kv_len and q_offset (B,)
// int32 on the device; o (B, Sq, H, D) contiguous in q's dtype; lse null
// or (B, Sq, H) fp32 contiguous.  D in {64, 128}; B*H <= 65535.  kv_len is
// clamped to Sk.  bf16 (tensor cores) also needs H / Hkv <= 128,
// 16-byte-aligned q, k, v, o and strides that are multiples of 8 elements.
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
    if (H / Hkv > tc::kRows || !hopper::aligned16({q, k, v, o}, st, 9)) return (int)cudaErrorInvalidValue;
    if (D == 64)
      return tc::launch<64>(q, k, v, o, lse, kv_len, q_offset, B, Sq, Sk, H, Hkv, causal, st, scale, s);
    if (D == 128)
      return tc::launch<128>(q, k, v, o, lse, kv_len, q_offset, B, Sq, Sk, H, Hkv, causal, st, scale, s);
  } else {
    if (D == 64)
      return f32::launch<64>(q, k, v, o, lse, kv_len, q_offset, B, Sq, Sk, H, Hkv, causal, st, scale, s);
    if (D == 128)
      return f32::launch<128>(q, k, v, o, lse, kv_len, q_offset, B, Sq, Sk, H, Hkv, causal, st, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
