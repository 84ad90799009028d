// FlashAttention-2 backward, the dQ half: dQ = scale * sum_j dS_ij K_j with
// P = exp(S - lse) recomputed from the forward's saved row lse and
// dS = P * (dO V^T - delta), delta = rowsum(dO * O).
//
// Replaces the JAX package's ops/attention.py::_flash_bwd_dq_kernel (reached
// by the custom-vjp backward _flash_mha_bwd of flash_mha), which training
// runs once in the backward of every decoder layer.  Every row's
// p = exp(s - lse) where the key is visible (k < kv_len, and k <= q when
// causal), else 0 -- never an online max; ds = p * (dp - delta); dQ sums
// ds * K in fp32 over the visible key tiles and is multiplied by the scale
// once at the end, then rounded once to q's dtype.
//
// Bound on the H100: at the training shape (Sq = Sk = 2048, 32 heads, D 128,
// causal) the work is three (Sq x Sk x D) matrix products over the visible
// half, ~52 GFLOP a layer: operation-bound, 0.052 ms at the H100 SXM's
// data-sheet 989 TFLOP/s bf16 (700 W).  K and V are read in their own (B, Sk, Hkv, D) layout
// through strides (no transpose or padding), each block stops at the last
// key tile its rows can see, and the (Sq, Sk) probabilities never leave the
// block.
//
// Two instantiations, chosen by the caller's dtype:
//
// bf16 (every training step): tensor cores, the forward's design
// (flash_attention.cu, hopper_attention.cuh).  A block is two warpgroups
// over 128 (query, head) rows, the H / Hkv query heads of one kv group
// packed query-major, floor(128 / group) queries a block (the rows past
// that multiple of the group are masked), so each K/V tile is loaded once
// for the group.  Q and dO are loaded once into the 128-byte swizzle; K and
// V tiles of 64 keys go through a two-stage cp.async ring; the heaviest
// causal query tiles launch first and a warpgroup skips tiles its rows
// cannot see.  Per key tile each warpgroup takes S = Q K^T and dP = dO V^T
// with wgmma (K and V K-major), P = ex2(S * scale * log2e - lse * log2e)
// (the scale enters after the bf16 dot; masked only on tiles that cross
// the diagonal or kv_len), dS = P (dP - delta) in registers, rounded to
// bf16 as the A operand of dQ += dS K (K read MN-major through the
// descriptor, as the forward reads V).  lse and delta are one fp32 a row,
// held in registers.  Registers at D 128: S 32 + dP 32 + dQ 64 fp32 a
// thread; shared memory 129 KB, one block an SM.
//
// fp32 (the CPU-vs-card parity runs only): the first version, CUDA-core
// FMAs in the TPU kernel's arithmetic (q cast to fp32 and scaled BEFORE the
// dot, as the forward's lse was taken): one block of 256 threads per
// (batch, head, 32 query rows); GQA maps head h to kv head h / (H / Hkv).
// The block keeps its pre-scaled q and dO rows and their lse and delta in
// shared memory, streams K and V tiles of 64 keys (rows padded to D+1
// floats so the per-key dot products are free of bank conflicts), puts the
// tile's dS in shared memory, and accumulates dQ in registers (one head-dim
// column, RPT rows a thread).

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
constexpr int kBQ = 32;  // query rows per block
constexpr int kBK = 64;  // keys per tile

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
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
  const float* qb = q + b * qsb + h * qsh;
  const float* dob = dout + b * dsb + h * dsh;
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;
  const int L = min(kv_len[b], Sk);

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
      ks[j * (D + 1) + d] = in ? kb[kj * kss + d] : 0.f;
      vs[j * (D + 1) + d] = in ? vb[kj * vss + d] : 0.f;
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
    if (qi < Sq) dq[(((long long)b * Sq + qi) * H + h) * D + dl] = acc[r] * scale;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, const void* kv_len, int B, int Sq, int Sk, int H,
           int Hkv, int causal, const long long* st, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (2 * (size_t)kBQ * D + 2 * (size_t)kBK * (D + 1) + (size_t)kBQ * kBK + 2 * kBQ);
  auto kern = flash_bwd_dq_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H), block(kThreads);
  kern<<<grid, block, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), static_cast<const int*>(kv_len),
      Sq, Sk, H, Hkv, causal, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale);
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

template <int D>
struct Layout {  // byte offsets in shared memory, from a 1024-aligned base
  static constexpr int kTile = kBN * D * 2;           // one K or V tile
  static constexpr int kQ = 0;                        // kRows x D
  static constexpr int kDO = kRows * D * 2;           // kRows x D
  static constexpr int kK = 2 * kRows * D * 2;        // the K stages
  static constexpr int kV = kK + kStages * kTile;     // the V stages
  static constexpr int kBytes = kV + kStages * kTile + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dq, const int* __restrict__ kv_len,
                       int Sq, int Sk, int H, int Hkv, int causal, int n_qt,
                       long long qsb, long long qss, long long qsh,
                       long long ksb, long long kss, long long ksh,
                       long long vsb, long long vss, long long vsh,
                       long long dsb, long long dss, long long dsh, float scale) {
  using namespace hopper;
  using Lay = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32, warp = (tid % 128) / 32;
  const int G = H / Hkv, QB = kRows / G, RU = QB * G;  // queries a block, rows in use
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int q0 = (n_qt - 1 - blockIdx.y) * QB;  // the heaviest causal tiles first
  const int L = min(kv_len[b], Sk);
  const bf16* qb = q + b * qsb + (long long)hk * G * qsh;
  const bf16* dob = dout + b * dsb + (long long)hk * G * dsh;
  const bf16* kb = k + b * ksb + hk * ksh;
  const bf16* vb = v + b * vsb + hk * vsh;

  // keys this block and this warpgroup can see
  const int q_last = min(q0 + QB, Sq) - 1;
  const int lim = causal ? min(q_last + 1, L) : L;
  const int n_t = lim > 0 ? (lim + kBN - 1) / kBN : 0;
  const int wg_q0 = q0 + wg * 64 / G, wg_q1 = min(q0 + min(wg * 64 + 63, RU - 1) / G, Sq - 1);
  const int wg_lim = (wg * 64 >= RU || wg_q0 >= Sq) ? 0 : causal ? min(wg_q1 + 1, L) : L;

  constexpr int CH = D / 8;  // 16-byte chunks a row
  for (int e = tid; e < kRows * CH; e += kThreads) {
    const int r = e / CH, c = e % CH, qi = q0 + r / G;
    const bool ok = r < RU && qi < Sq;
    const uint32_t at = tile_offset(r, c, kRows);
    cp_async_16(base + Lay::kQ + at, ok ? qb + qi * qss + (r % G) * qsh + c * 8 : q, ok);
    cp_async_16(base + Lay::kDO + at, ok ? dob + qi * dss + (r % G) * dsh + c * 8 : dout, ok);
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
  // commit group a tile (the first also holds Q and dO)
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_t) load_kv(t, t);
    cp_async_commit();
  }

  // this thread's two rows, their lse (log2 domain) and delta; a row past
  // the block's queries reads zeros (its Q and dO are 0, so its dS is 0)
  const int r0 = wg * 64 + warp * 16 + lane / 4, r1 = r0 + 8;
  const int qi0 = q0 + r0 / G, qi1 = q0 + r1 / G;
  const bool ok0 = r0 < RU && qi0 < Sq, ok1 = r1 < RU && qi1 < Sq;
  const long long row0 = ((long long)b * Sq + qi0) * H + hk * G + r0 % G;
  const long long row1 = ((long long)b * Sq + qi1) * H + hk * G + r1 % G;
  const float lse0 = ok0 ? lse[row0] * kLog2e : 0.f, lse1 = ok1 ? lse[row1] * kLog2e : 0.f;
  const float dl0 = ok0 ? delta[row0] : 0.f, dl1 = ok1 ? delta[row1] : 0.f;
  const float scale_log2 = scale * kLog2e;
  const int cq = 2 * (lane % 4);
  float dq_acc[D / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
  uint32_t da[4][4];

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
      const uint32_t dt = base + Lay::kDO + wg * 64 * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(s, desc(qt + (kk / 4) * kRows * 128 + (kk % 4) * 32, 16, 1024),
                 desc(kt + (kk / 4) * kBN * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dp, desc(dt + (kk / 4) * kRows * 128 + (kk % 4) * 32, 16, 1024),
                 desc(vt + (kk / 4) * kBN * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      fence_regs(dp);

      // dS = P (dP - delta), P = 2^(s * scale * log2(e) - lse * log2(e)), 0 where unseen
      const bool edge = k0 + kBN > L || (causal && k0 + kBN - 1 > wg_q0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool hi = i & 2;
        float p = ex2(fmaf(s[i], scale_log2, -(hi ? lse1 : lse0)));
        if (edge) {
          const int key = k0 + 8 * (i / 4) + cq + (i & 1);
          if (key >= L || (causal && key > (hi ? qi1 : qi0))) p = 0.f;
        }
        s[i] = p * (dp[i] - (hi ? dl1 : dl0));
      }
      p_fragments(s, da);

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs(dq_acc, da[kk], desc(kt + kk * 16 * 128, kBN * 128, 1024));
      wgmma_commit();
      wgmma_wait();
      fence_regs(dq_acc);
    }
    __syncthreads();  // the stage is free for its next load
  }
  cp_async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!(half ? ok1 : ok0)) continue;
    bf16* drow = dq + (half ? row1 : row0) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(drow + 8 * j + cq) = __floats2bfloat162_rn(
          dq_acc[4 * j + 2 * half] * scale, dq_acc[4 * j + 2 * half + 1] * scale);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, const void* kv_len, int B, int Sq, int Sk, int H,
           int Hkv, int causal, const long long* st, float scale, cudaStream_t stream) {
  const int QB = kRows / (H / Hkv), n_qt = (Sq + QB - 1) / QB;
  const int smem = Layout<D>::kBytes;
  auto kern = flash_bwd_dq_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * Hkv, n_qt), block(kThreads);
  kern<<<grid, block, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), static_cast<const int*>(kv_len),
      Sq, Sk, H, Hkv, causal, n_qt, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q and dout (B, Sq, H, D), k/v (B, Sk, Hkv, D), each with element strides
// (batch, seq, head) and a contiguous head dim; lse and delta (B, Sq, H)
// fp32 contiguous; kv_len (B,) int32 on the device; dq (B, Sq, H, D)
// contiguous in q's dtype.  D in {64, 128}; B*H <= 65535.  The queries sit
// at positions 0..Sq-1 (no q_offset: the training backward has none).  bf16
// (tensor cores) also needs H / Hkv <= 128, 16-byte-aligned q, k, v, dout
// and dq, and strides that are multiples of 8 elements.
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
    if (H / Hkv > tc::kRows || !hopper::aligned16({q, k, v, dout, dq}, st, 12))
      return (int)cudaErrorInvalidValue;
    if (D == 64)
      return tc::launch<64>(q, k, v, dout, lse, delta, dq, kv_len, B, Sq, Sk, H, Hkv, causal, st, scale, s);
    if (D == 128)
      return tc::launch<128>(q, k, v, dout, lse, delta, dq, kv_len, B, Sq, Sk, H, Hkv, causal, st, scale, s);
  } else {
    if (D == 64)
      return f32::launch<64>(q, k, v, dout, lse, delta, dq, kv_len, B, Sq, Sk, H, Hkv, causal, st, scale, s);
    if (D == 128)
      return f32::launch<128>(q, k, v, dout, lse, delta, dq, kv_len, B, Sq, Sk, H, Hkv, causal, st, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
