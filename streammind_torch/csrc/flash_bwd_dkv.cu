// FlashAttention-2 backward, the dK/dV half: for each key j,
//   dV_j = sum_i P_ij dO_i,   dK_j = scale * sum_i dS_ij q_i,
// with P = exp(S - lse) recomputed from the forward's saved row lse and
// dS = P * (dO V^T - delta), summed over every query head of the key's GQA
// group.
//
// Replaces the JAX package's ops/attention.py::_flash_bwd_dkv_kernel (reached
// by the custom-vjp backward _flash_mha_bwd of flash_mha) together with the
// GQA reshape-sum that follows it there, which training runs once in the
// backward of every decoder layer.  p = exp(s - lse) where the key is
// visible (k < kv_len, and k <= q when causal), else 0; dV and dK
// accumulate in fp32; the causal loop starts at the first query tile that
// can see the key tile.
//
// Design change from the TPU kernel: the TPU grid is (B*H, key blocks) and
// writes an fp32 (B*H, Sk, D) dK and dV per QUERY head, which the wrapper
// then sums over each group of H/Hkv heads and casts to k's dtype.  Here a
// block owns (batch, kv head, a key tile) and loops over the H/Hkv query
// heads of its group itself, so the group sum happens in the block's fp32
// registers: no (B*H, Sk, D) fp32 transient, no second pass, no atomics,
// and dK and dV are each written once, in k's dtype.  The sum is the same;
// only its order differs.  Keys at or past kv_len get dK = dV = 0 and do
// no work.
//
// Bound on the H100: at the training shape (Sq = Sk = 2048, 32 heads, D 128,
// causal) the work is four (Sq x Sk x D) matrix products over the visible
// half, ~69 GFLOP a layer: operation-bound, 0.070 ms at the H100 SXM's
// data-sheet 989 TFLOP/s bf16 (700 W).  K and V tiles are read once; q, dO, lse and delta are
// streamed once per key tile from the causal start on; nothing of size
// (Sq, Sk) leaves the block.
//
// Two instantiations, chosen by the caller's dtype:
//
// bf16 (every training step): tensor cores, keys as the M dimension.  A
// block is two warpgroups sharing one tile of 64 keys (K and V loaded once
// into the 128-byte swizzle of hopper_attention.cuh); the block's
// iterations -- (query head of the group, 64-query tile) pairs from the
// first tile that can see its keys -- alternate between the warpgroups, so
// the heaviest causal tiles (the first keys, launched first) take half as
// long, and each warpgroup streams its Q and dO tiles through its own
// two-stage cp.async ring with the tile's 64 lse and delta values (indexed
// by column here, so staged in shared memory).  Per tile each warpgroup
// takes S^T = K Q^T and dP^T = V dO^T with wgmma (all four K-major),
// P^T = ex2(S^T * scale * log2e - lse * log2e) (masked only on tiles that
// cross the diagonal, kv_len or Sq), dS^T = P^T (dP^T - delta), then
// dV += P^T dO and dK += dS^T Q with P^T and dS^T rounded to bf16 as A
// operands in registers and dO and Q read MN-major from the same swizzled
// tiles (the descriptor's transpose, as the forward reads V).  q enters
// unscaled (a bf16 q cannot carry an fp32 pre-scale): dK takes the scale
// once at the end.  The two warpgroups' sums meet in shared memory; one
// stores dK, the other dV.  Registers at D 128: dK 64 + dV 64 + S^T 32 +
// dP^T 32 fp32 a thread, one block (256 threads) an SM; 163 KB of shared
// memory.
//
// fp32 (the CPU-vs-card parity runs only): the first version, CUDA-core
// FMAs in the TPU kernel's arithmetic (q cast to fp32 and scaled before the
// dot).  One block of 256 threads per (batch, kv head, 32 keys).  Per
// (query head, 64-row query tile) the block stages pre-scaled q and dO,
// computes S and dO V^T (thread -> one key, 8 rows), puts P and dS in
// shared memory, then each thread adds them into its head-dim column of dK
// and dV for 32 / (256 / D) keys held in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_attention.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int kThreads = 256;
constexpr int kBK = 32;  // keys per block
constexpr int kBQ = 64;  // query rows per tile

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
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
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;

  for (int e = tid; e < kBK * D; e += kThreads) {
    const int j = e / D, d = e % D, kj = k0 + j;
    const bool in = kj < Sk;
    ks[j * (D + 1) + d] = in ? kb[kj * kss + d] : 0.f;
    vs[j * (D + 1) + d] = in ? vb[kj * vss + d] : 0.f;
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
    const float* qb = q + b * qsb + h * qsh;
    const float* dob = dout + b * dsb + h * dsh;
    for (int t = start; t < n_qt; ++t) {
      const int q0 = t * kBQ;
      __syncthreads();
      for (int e = tid; e < kBQ * D; e += kThreads) {
        const int i = e / D, d = e % D, qi = q0 + i;
        const bool in = qi < Sq;
        qs[e] = in ? qb[qi * qss + d] * scale : 0.f;
        dos[e] = in ? dob[qi * dss + d] : 0.f;
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
      dk[off] = dk_acc[r];
      dv[off] = dv_acc[r];
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dk, void* dv, const void* kv_len, int B, int Sq, int Sk,
           int H, int Hkv, int causal, const long long* st, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (2 * (size_t)kBK * (D + 1) + 2 * (size_t)kBQ * D + 2 * (size_t)kBQ * kBK + 2 * kBQ);
  auto kern = flash_bwd_dkv_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sk + kBK - 1) / kBK, B * Hkv), block(kThreads);
  kern<<<grid, block, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<const int*>(kv_len), Sq, Sk, H, Hkv, causal, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale);
  return (int)cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma)
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kBK = 64;       // keys a block, shared by its two warpgroups
constexpr int kBQ = 64;       // queries a tile
constexpr int kThreads = 256;
constexpr int kStages = 2;    // Q/dO tiles in flight, per warpgroup

template <int D>
struct Layout {  // byte offsets in shared memory, from a 1024-aligned base
  static constexpr int kTile = 64 * D * 2;                   // one 64-row tile
  static constexpr int kK = 0;
  static constexpr int kV = kTile;
  static constexpr int kRing = 2 * kTile;                    // warpgroup 0's ring, then 1's
  static constexpr int kRingWG = kStages * 2 * kTile;        // kStages x (Q, dO)
  static constexpr int kVals = kRing + 2 * kRingWG;          // [wg][stage][lse, delta][64] fp32
  static constexpr int kBytes = kVals + 2 * kStages * 2 * kBQ * 4 + 1024;  // + alignment slack
};

// rows key0 and key1 (< Sk) of a (B, Sk, Hkv, D) output from this thread's
// share of a 64 x D accumulator, times mul, in bf16
template <int D>
__device__ __forceinline__ void store_keys(bf16* out, const float (&a)[D / 2], float mul,
                                           int key0, int key1, int Sk, int b, int Hkv, int hk,
                                           int cq) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kj = half ? key1 : key0;
    if (kj >= Sk) continue;
    bf16* orow = out + (((long long)b * Sk + kj) * Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + cq) = __floats2bfloat162_rn(
          a[4 * j + 2 * half] * mul, a[4 * j + 2 * half + 1] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv,
                        const int* __restrict__ kv_len, int Sq, int Sk, int H, int Hkv,
                        int causal,
                        long long qsb, long long qss, long long qsh,
                        long long ksb, long long kss, long long ksh,
                        long long vsb, long long vss, long long vsh,
                        long long dsb, long long dss, long long dsh, float scale) {
  using namespace hopper;
  using Lay = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_addr(smem_raw));

  const int tid = threadIdx.x, wg = tid / 128, wtid = tid % 128, lane = tid % 32;
  const int warp = wtid / 32;
  const int G = H / Hkv;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int k0 = blockIdx.y * kBK;  // the first keys, seen by the most queries, launch first
  const int L = min(kv_len[b], Sk);
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int t0 = causal ? k0 / kBQ : 0;  // the first query tile with a query >= k0
  const int per_head = max(n_qt - t0, 0);
  const int n_it = k0 < L ? G * per_head : 0;
  const int cq = 2 * (lane % 4);
  const int key0 = k0 + warp * 16 + lane / 4, key1 = key0 + 8;  // this thread's two keys

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  if (n_it == 0) {  // no query sees these keys (past kv_len, or causal past Sq)
    store_keys<D>(wg == 0 ? dk : dv, dk_acc, 1.f, key0, key1, Sk, b, Hkv, hk, cq);
    return;
  }

  const bf16* kb = k + b * ksb + hk * ksh;
  const bf16* vb = v + b * vsb + hk * vsh;
  constexpr int CH = D / 8;  // 16-byte chunks a row
  for (int e = tid; e < kBK * CH; e += kThreads) {
    const int r = e / CH, c = e % CH, kj = k0 + r;
    const bool ok = kj < L;
    const uint32_t at = tile_offset(r, c, kBK);
    cp_async_16(base + Lay::kK + at, ok ? kb + kj * kss + c * 8 : k, ok);
    cp_async_16(base + Lay::kV + at, ok ? vb + kj * vss + c * 8 : v, ok);
  }
  cp_async_commit();

  // this warpgroup's iterations i = wg, wg + 2, ... of the G * per_head
  // (query head, query tile) pairs, head-major; local iteration j sits in
  // stage j % kStages of its ring, one tile ahead
  const int n_w = (n_it - wg + 1) / 2;
  const uint32_t ring = base + Lay::kRing + wg * Lay::kRingWG;
  const uint32_t vals = base + Lay::kVals + wg * kStages * 2 * kBQ * 4;
  const float* vals_ptr = reinterpret_cast<const float*>(base_ptr + Lay::kVals) +
                          wg * kStages * 2 * kBQ;
  auto load_q = [&](int j) {
    const int i = 2 * j + wg, h = hk * G + i / per_head, q0 = (t0 + i % per_head) * kBQ;
    const bf16* qh = q + b * qsb + h * qsh;
    const bf16* doh = dout + b * dsb + h * dsh;
    const uint32_t st = ring + (j % kStages) * 2 * Lay::kTile;
    for (int e = wtid; e < kBQ * CH; e += 128) {
      const int r = e / CH, c = e % CH, qi = q0 + r;
      const bool ok = qi < Sq;
      const uint32_t at = tile_offset(r, c, kBQ);
      cp_async_16(st + at, ok ? qh + qi * qss + c * 8 : q, ok);
      cp_async_16(st + Lay::kTile + at, ok ? doh + qi * dss + c * 8 : dout, ok);
    }
    // lse (threads 0-63) and delta (64-127) of the tile's queries; 0 past Sq
    const int qi = q0 + wtid % kBQ;
    const bool ok = qi < Sq;
    const float* src = (wtid < kBQ ? lse : delta) + ((long long)b * Sq + qi) * H + h;
    cp_async_4(vals + ((j % kStages) * 2 * kBQ + wtid) * 4, ok ? src : lse, ok);
  };
  if (n_w > 0) load_q(0);
  cp_async_commit();
  cp_async_wait<1>();  // K and V, loaded by both warpgroups
  fence_async_shared();
  __syncthreads();

  const float scale_log2 = scale * kLog2e;
  float s[32], dp[32];
  uint32_t pa[4][4], dsa[4][4];
  for (int j = 0; j < n_w; ++j) {
    if (j + 1 < n_w) load_q(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_shared();
    warpgroup_sync(wg);
    const int i = 2 * j + wg, q0 = (t0 + i % per_head) * kBQ;
    const uint32_t qt = ring + (j % kStages) * 2 * Lay::kTile, dt = qt + Lay::kTile;
    const float* lse_t = vals_ptr + (j % kStages) * 2 * kBQ;
    const float* dlt_t = lse_t + kBQ;

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, desc(base + Lay::kK + (kk / 4) * kBK * 128 + (kk % 4) * 32, 16, 1024),
               desc(qt + (kk / 4) * kBQ * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, desc(base + Lay::kV + (kk / 4) * kBK * 128 + (kk % 4) * 32, 16, 1024),
               desc(dt + (kk / 4) * kBQ * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);

    // rows are keys, columns queries: P^T = 2^(s * scale * log2(e) - lse * log2(e)),
    // 0 where unseen; dS^T = P^T (dP^T - delta)
    const bool edge = k0 + kBK > L || q0 + kBQ > Sq || (causal && q0 < k0 + kBK - 1);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int c = 8 * jj + cq + e2, qi = q0 + c;
        const float l2 = lse_t[c] * kLog2e, dl = dlt_t[c];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int x = 4 * jj + 2 * half + e2, key = half ? key1 : key0;
          float p = ex2(fmaf(s[x], scale_log2, -l2));
          if (edge && (key >= L || qi >= Sq || (causal && key > qi))) p = 0.f;
          s[x] = p;
          dp[x] = p * (dp[x] - dl);
        }
      }
    p_fragments(s, pa);
    p_fragments(dp, dsa);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      wgmma_rs(dv_acc, pa[kk], desc(dt + kk * 16 * 128, kBQ * 128, 1024));
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      wgmma_rs(dk_acc, dsa[kk], desc(qt + kk * 16 * 128, kBQ * 128, 1024));
    wgmma_commit();
    wgmma_wait();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    warpgroup_sync(wg);  // the stage is free for its next load
  }
  cp_async_wait<0>();
  __syncthreads();  // both rings are free

  // the two warpgroups' sums meet in shared memory: warpgroup 0 hands over
  // its dV and stores dK, warpgroup 1 hands over its dK and stores dV
  float* red = reinterpret_cast<float*>(base_ptr + Lay::kRing);
#pragma unroll
  for (int x = 0; x < D / 2; ++x)
    red[(wg * (D / 2) + x) * 128 + wtid] = wg == 0 ? dv_acc[x] : dk_acc[x];
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int x = 0; x < D / 2; ++x) dk_acc[x] += red[(D / 2 + x) * 128 + wtid];
    store_keys<D>(dk, dk_acc, scale, key0, key1, Sk, b, Hkv, hk, cq);
  } else {
#pragma unroll
    for (int x = 0; x < D / 2; ++x) dv_acc[x] += red[x * 128 + wtid];
    store_keys<D>(dv, dv_acc, 1.f, key0, key1, Sk, b, Hkv, hk, cq);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dk, void* dv, const void* kv_len, int B, int Sq, int Sk,
           int H, int Hkv, int causal, const long long* st, float scale, cudaStream_t stream) {
  const int smem = Layout<D>::kBytes;
  auto kern = flash_bwd_dkv_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * Hkv, (Sk + kBK - 1) / kBK), block(kThreads);
  kern<<<grid, block, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<const int*>(kv_len), Sq, Sk, H, Hkv, causal, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q and dout (B, Sq, H, D), k/v (B, Sk, Hkv, D), each with element strides
// (batch, seq, head) and a contiguous head dim; lse and delta (B, Sq, H)
// fp32 contiguous; kv_len (B,) int32 on the device; dk and dv (B, Sk, Hkv, D)
// contiguous in k's dtype, already summed over each GQA group.  D in
// {64, 128}; B*Hkv <= 65535.  The queries sit at positions 0..Sq-1.  bf16
// (tensor cores) also needs 16-byte-aligned q, k, v, dout, dk and dv and
// strides that are multiples of 8 elements.
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
    if (!hopper::aligned16({q, k, v, dout, dk, dv}, st, 12)) return (int)cudaErrorInvalidValue;
    if (D == 64)
      return tc::launch<64>(q, k, v, dout, lse, delta, dk, dv, kv_len, B, Sq, Sk, H, Hkv, causal, st, scale, s);
    if (D == 128)
      return tc::launch<128>(q, k, v, dout, lse, delta, dk, dv, kv_len, B, Sq, Sk, H, Hkv, causal, st, scale, s);
  } else {
    if (D == 64)
      return f32::launch<64>(q, k, v, dout, lse, delta, dk, dv, kv_len, B, Sq, Sk, H, Hkv, causal, st, scale, s);
    if (D == 128)
      return f32::launch<128>(q, k, v, dout, lse, delta, dk, dv, kv_len, B, Sq, Sk, H, Hkv, causal, st, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
