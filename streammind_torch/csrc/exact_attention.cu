// Exact (whole-row fp32 softmax) attention, non-causal: the ViT's attention.
//
// Replaces the JAX package's ops/attention.py::_exact_kernel (entry
// point exact_attention), reached by the vision tower under attn_impl="exact".
//
// Arithmetic, as the TPU kernel and mha_reference do it: s = (q . k) in
// fp32, THEN times scale; a full-row max, exp, sum and divide in fp32;
// probs rounded to v's dtype after the division; PV accumulated in fp32 and
// rounded once to the output dtype.  Keys past Sk are never scored (the TPU
// kernel masks its lane padding to the same effect).  Neither the logits
// nor the probs touch device memory.  q, k and v are read through their
// strides, so the ViT's strided views of its fused qkv projection need no
// copy; only the head dim must be contiguous.
//
// Two instantiations, chosen by the caller's dtype:
//
// bf16 (the ViT of every path): tensor cores, two passes.  Bound on the H100:
// at the ViT's (B, 577, 16, 64) the work is ~1.4 GFLOP a frame-layer against
// ~4.7 MB of q/k/v/o, bound by the bytes at B 1 and close to balanced at B 8.
// Design: a block is one warpgroup owning 64 query rows of one (batch,
// head), so B 1 gives 10 x 16 = 160 blocks for the 132 SMs (a second
// warpgroup a block would leave most SMs idle there).  Pass 1 streams the
// K tiles (64 keys, two-stage cp.async ring into the 128-byte swizzle of
// hopper_attention.cuh), takes S = Q K^T with wgmma and keeps each row's
// max and fp32 sum in registers with an online rescale; pass 2 streams K
// and V, recomputes S, forms p = exp(s - m) / l, rounds it to bf16 in
// registers and accumulates O += P V with wgmma.  The probs are thus rounded
// after the whole-row division, with no Sk-long logits row anywhere (no
// shared-memory limit that grows with Sk); the price is a second Q K^T and
// a second ex2 a score, which is what holds the kernel back past one wave of
// blocks (B 4 and 8; PERF.md).  The fp32 sums run in another order than the
// plain version's (the TPU kernel was not bitwise either).  Keys past Sk in
// the last tile get p = 0.
//
// fp32 (the CPU-vs-card parity runs only): the first version, CUDA-core
// FMAs: one block of 256 threads per (batch, head, tile of QT query rows),
// whose QT x Sk fp32 logits rows live in shared memory (QT = 16 up to 2048
// keys, 8 up to 4096); K and then V stream through a 64-key shared tile
// padded to D+1 floats per row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_attention.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int kThreads = 256;
constexpr int kKT = 64;  // keys per shared tile

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

template <int D, int QT>
__global__ void __launch_bounds__(kThreads)
exact_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
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
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;

  for (int e = tid; e < QT * D; e += kThreads) {
    const int i = e / D, d = e % D, qi = q0 + i;
    qs[e] = qi < Sq ? qb[qi * qss + d] : 0.f;
  }

  // ---- logits: thread -> one key of the tile, RPT query rows -------------
  constexpr int RPT = QT / (kThreads / kKT);
  const int jl = tid % kKT, ig = tid / kKT;
  for (int k0 = 0; k0 < Sk; k0 += kKT) {
    __syncthreads();
    for (int e = tid; e < kKT * D; e += kThreads) {
      const int j = e / D, d = e % D, kj = k0 + j;
      kv[j * (D + 1) + d] = kj < Sk ? kb[kj * kss + d] : 0.f;
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
    for (int j = lane; j < Sk; j += 32) row[j] = row[j] / l;
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
      kv[j * (D + 1) + d] = kj < Sk ? vb[kj * vss + d] : 0.f;
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
    if (qi < Sq) o[(((long long)b * Sq + qi) * H + h) * D + dl] = acc[r];
  }
}

template <int D, int QT>
int launch_qt(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
              int H, int Hkv, const long long* st, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)QT * D + (size_t)kKT * (D + 1) + (size_t)QT * Sk);
  auto kern = exact_attention_kernel<D, QT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + QT - 1) / QT, B * H), block(kThreads);
  kern<<<grid, block, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Sq, Sk, H, Hkv, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
           int H, int Hkv, const long long* st, float scale, cudaStream_t stream) {
  if (Sk <= 2048) return launch_qt<D, 16>(q, k, v, o, B, Sq, Sk, H, Hkv, st, scale, stream);
  return launch_qt<D, 8>(q, k, v, o, B, Sq, Sk, H, Hkv, st, scale, stream);
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), two passes
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kRows = 64;     // query rows a block: one warpgroup
constexpr int kBN = 64;       // keys a tile
constexpr int kThreads = 128;
constexpr int kStages = 2;    // K (and V) tiles in flight
constexpr float kNegInf = -1e30f;

template <int D>
struct Layout {  // byte offsets in shared memory, from a 1024-aligned base
  static constexpr int kTile = kBN * D * 2;           // one K or V tile
  static constexpr int kQ = 0;                        // kRows x D
  static constexpr int kK = kRows * D * 2;            // the K stages
  static constexpr int kV = kK + kStages * kTile;     // the V stages
  static constexpr int kBytes = kV + kStages * kTile + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(kThreads)
exact_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o,
                int Sq, int Sk, int H, int Hkv,
                long long qsb, long long qss, long long qsh,
                long long ksb, long long kss, long long ksh,
                long long vsb, long long vss, long long vsh, float scale_log2) {
  using namespace hopper;
  using Lay = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * kRows;
  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + hk * ksh;
  const bf16* vb = v + b * vsb + hk * vsh;
  const int n_t = (Sk + kBN - 1) / kBN;

  constexpr int CH = D / 8;  // 16-byte chunks a row
  for (int e = tid; e < kRows * CH; e += kThreads) {
    const int r = e / CH, c = e % CH, qi = q0 + r;
    const bool ok = qi < Sq;
    cp_async_16(base + Lay::kQ + tile_offset(r, c, kRows), ok ? qb + qi * qss + c * 8 : q, ok);
  }
  auto load = [&](int t, int stage, bool with_v) {
    for (int e = tid; e < kBN * CH; e += kThreads) {
      const int r = e / CH, c = e % CH, kj = t * kBN + r;
      const bool ok = kj < Sk;
      const uint32_t at = stage * Lay::kTile + tile_offset(r, c, kBN);
      cp_async_16(base + Lay::kK + at, ok ? kb + kj * kss + c * 8 : k, ok);
      if (with_v) cp_async_16(base + Lay::kV + at, ok ? vb + kj * vss + c * 8 : v, ok);
    }
  };
  // S = Q K^T of the tile in `stage` (the scale enters with the exponent,
  // x = s * scale * log2(e)); keys past Sk get kNegInf
  auto scores = [&](int t, int stage, float (&s)[32]) {
    const uint32_t kt = base + Lay::kK + stage * Lay::kTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, desc(base + Lay::kQ + (kk / 4) * kRows * 128 + (kk % 4) * 32, 16, 1024),
               desc(kt + (kk / 4) * kBN * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    const int k0 = t * kBN, cq = 2 * (lane % 4);
    if (k0 + kBN > Sk) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (k0 + 8 * (i / 4) + cq + (i & 1) >= Sk) s[i] = kNegInf;
    }
  };
  // the ring: tile t in stage t % kStages, kStages - 1 tiles ahead, one
  // commit group a tile (the first of pass 1 also holds Q)
  auto prologue = [&](bool with_v) {
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < n_t) load(t, t, with_v);
      cp_async_commit();
    }
  };
  auto next = [&](int t, bool with_v) {
    if (t + kStages - 1 < n_t) load(t + kStages - 1, (t + kStages - 1) % kStages, with_v);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    fence_async_shared();
    __syncthreads();
  };

  // ---- pass 1: each row's max and sum (log2 domain, online rescale) -----
  float s[32];
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  prologue(false);
  for (int t = 0; t < n_t; ++t) {
    next(t, false);
    scores(t, t % kStages, s);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0) * scale_log2);
    const float mn1 = fmaxf(m1, quad_max(mx1) * scale_log2);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sum0 += ex2(fmaf(s[4 * j], scale_log2, -mn0)) + ex2(fmaf(s[4 * j + 1], scale_log2, -mn0));
      sum1 += ex2(fmaf(s[4 * j + 2], scale_log2, -mn1)) + ex2(fmaf(s[4 * j + 3], scale_log2, -mn1));
    }
    l0 = l0 * ex2(m0 - mn0) + sum0;
    l1 = l1 * ex2(m1 - mn1) + sum1;
    m0 = mn0;
    m1 = mn1;
    __syncthreads();
  }
  cp_async_wait<0>();
  // 1 / l once a row: p * (1 / l) is within an fp32 ulp of p / l, closer than
  // the device's ex2 comes to exp, and the rounding to bf16 still follows it
  const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);

  // ---- pass 2: p = exp(s - m) / l rounded to bf16, O += P V -------------
  float o_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
  uint32_t pa[4][4];
  prologue(true);
  for (int t = 0; t < n_t; ++t) {
    next(t, true);
    scores(t, t % kStages, s);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[4 * j] = ex2(fmaf(s[4 * j], scale_log2, -m0)) * inv0;
      s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], scale_log2, -m0)) * inv0;
      s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], scale_log2, -m1)) * inv1;
      s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], scale_log2, -m1)) * inv1;
    }
    p_fragments(s, pa);
    const uint32_t vt = base + Lay::kV + (t % kStages) * Lay::kTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_rs(o_acc, pa[kk], desc(vt + kk * 16 * 128, kBN * 128, 1024));
    wgmma_commit();
    wgmma_wait();
    fence_regs(o_acc);
    __syncthreads();  // the stage is free for its next load
  }
  cp_async_wait<0>();

  const int r0 = warp * 16 + lane / 4, cq = 2 * (lane % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + r0 + 8 * half;
    if (qi >= Sq) continue;
    bf16* orow = o + (((long long)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + cq) =
          __floats2bfloat162_rn(o_acc[4 * j + 2 * half], o_acc[4 * j + 2 * half + 1]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
           int H, int Hkv, const long long* st, float scale, cudaStream_t stream) {
  const int smem = Layout<D>::kBytes;
  auto kern = exact_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Sq + kRows - 1) / kRows), block(kThreads);
  kern<<<grid, block, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), Sq, Sk, H, Hkv, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], scale * hopper::kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q (B, Sq, H, D), k/v (B, Sk, Hkv, D), each with element strides
// (batch, seq, head) and a contiguous head dim; o (B, Sq, H, D) contiguous
// in q's dtype.  D in {64, 128}; 1 <= Sk <= 4096; B*H <= 65535.  bf16
// (tensor cores) also needs 16-byte-aligned q, k, v, o and strides that are
// multiples of 8 elements.
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
    if (!hopper::aligned16({q, k, v, o}, st, 9)) return (int)cudaErrorInvalidValue;
    if (D == 64) return tc::launch<64>(q, k, v, o, B, Sq, Sk, H, Hkv, st, scale, s);
    if (D == 128) return tc::launch<128>(q, k, v, o, B, Sq, Sk, H, Hkv, st, scale, s);
  } else {
    if (D == 64) return f32::launch<64>(q, k, v, o, B, Sq, Sk, H, Hkv, st, scale, s);
    if (D == 128) return f32::launch<128>(q, k, v, o, B, Sq, Sk, H, Hkv, st, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
