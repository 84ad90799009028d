// One-token decode attention over the paged KV pool, split over the keys.
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
// keys in fp32, the scale 1/sqrt(D) applied to the fp32 dot, an fp32
// softmax (masked logits -1e30) and one rounding of acc / max(l, 1e-30) to
// q's dtype.  length is clamped to the table's width (maxp x page): a
// finished row of the lockstep loop attends at its frozen length + 1,
// which at a page boundary points one page past its table, and the kernel
// never reads outside the table row.  A row of length 0 gives 0.
//
// Bound on the H100: bytes — the visible K and V rows (length x Hkv x D x
// 2 elements a row) read once; the operations (4 x H x D a position) are
// ~100x below the tensor-core line, so the products are CUDA-core FMAs
// from shared memory.
//
// Design (flash-decoding):
//  * Grid: one block per (split, row, kv head), split-major, so that the
//    first splits of all rows are dispatched first.  A split is a span of
//    256 or 512 positions, chosen by the host from the grid's size alone
//    (ops/paged_attention.py::_span); the number of splits comes from the
//    table's width, ceil(maxp x page / span), never from length, which
//    stays on the device.  A block whose span starts at or past its row's
//    clamped length returns as soon as it has read the length.
//  * Inside a split, two passes over its tiles of 64 positions: the K tiles
//    give the G x span scores (thread = one position, its query heads, four
//    partial sums a head; the G query heads of the kv head share every K
//    row), then the exact max and sum of each head over the split, then the
//    V tiles give acc[G x D] (thread = two dims of some heads).  No online
//    rescaling.
//  * The K and V tiles stream through a ring of kStages shared-memory
//    stages in the pool's dtype (bf16 K tile at D 128: 16 KB), filled by
//    16-byte cp.async.  The split's page ids are read once into shared
//    memory, and each chunk's page and offset come by a shift where page is
//    a power of two: the address arithmetic, not the loads, held the first
//    version back.  Pages of 8 or 16 positions straddle tiles; positions
//    past the length are zero-filled.  One __syncthreads a tile, plus two
//    around the softmax.  Rows are padded by 16 bytes, so the 16-byte reads
//    of 8 neighbouring rows fall on distinct banks.
//  * Merge in a fixed order, in the same launch: a row whose length fits
//    one split writes its output directly.  Otherwise each split leaves
//    (m, l, acc) in fp32 in a workspace; the last block of its (row, kv
//    head) to finish, found by an atomic counter that only counts (the
//    values never pass through atomics), merges
//    o = sum_s exp(m_s - M) acc_s / max(sum_s exp(m_s - M) l_s, 1e-30)
//    (the weights once a head, acc over the splits in split order, many
//    partials' loads at a time) and resets the counter to zero for the
//    next call.  So two calls give the same bits.  One launch was chosen
//    over a second merge kernel: the merge reads (G x D + 2G) floats a split
//    (~2 KB at Mistral-7B's shape), cheaper than a second launch's ~2-3 us.
//
// The token write, folded in (k_new / v_new given; the JAX package's
// streaming/paged.py::_token_write_kernel, entry _write_tokens_dma, which
// its decode step calls just before the attention in every layer): length
// is then each row's count before the new token.  Split 0 of each (row, kv
// head), which is always active, writes the row's new K and V head rows,
// cast to the pool's dtype by the host, at slot (table[b, length / page],
// length % page), or at (0, length % page) where length / page is past the
// table (page 0 is the sink: a finished row keeps writing at its frozen
// length, which at a page boundary points one page past its table).  The
// attention then covers min(length + 1, maxp x page) positions, and the
// block whose span holds position `length` copies that position's K and V
// into its tile from k_new / v_new rather than from the pool, so no block
// waits for another's write and the output has the bits of a write then an
// attention.  A separate write kernel cost a launch a layer (~2 us, its
// whole time) and, on the host, the slot's nine small tensor ops.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;       // positions per tile
constexpr int kMaxG = 8;      // query heads per kv head
constexpr int kMaxSpan = 512;
constexpr int kStages = 3;
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
  const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {  // bf16 → fp32 is the bf16 bits in the high half
    dst[2 * c] = __uint_as_float(w[c] << 16);
    dst[2 * c + 1] = __uint_as_float(w[c] & 0xFFFF0000u);
  }
}
// two consecutive elements of T as floats
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

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
struct Layout {
  static constexpr int kVec = 16 / sizeof(T);                 // elements a 16-byte chunk
  static constexpr int kChunks = D / kVec;                    // chunks a K/V row
  static constexpr int kRow = D + kVec;                       // padded row, elements
  static constexpr int kStage = kBK * kRow;                   // elements a stage
  static constexpr int kPairs = D / 2;                        // PV: threads a head group
  static constexpr int kGroups = kThreads / kPairs;           // PV: head groups
  static constexpr int kHeadsPV = (kMaxG + kGroups - 1) / kGroups;
  static constexpr int kHeadsS = kMaxG / (kThreads / kBK);    // scores: heads a thread
  static constexpr int kMergeElems = kMaxG * D / kThreads;     // merge: outputs a thread
  // the ring, q, then the G x span scores and (m, l) of each head
  static constexpr size_t smem(int span) {
    return sizeof(T) * kStages * kStage + sizeof(float) * ((size_t)kMaxG * D + 2 * kMaxG +
                                                           (size_t)kMaxG * span);
  }
  static_assert(kBK * kChunks % kThreads == 0, "tile chunks must split evenly over the block");
  static_assert(kThreads % kPairs == 0, "dim pairs must split the block");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, T* __restrict__ pool_k, T* __restrict__ pool_v,
                       const int* __restrict__ table, const int* __restrict__ length,
                       const T* __restrict__ k_new, const T* __restrict__ v_new, T* __restrict__ o,
                       float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                       int* __restrict__ counters, int H, int Hkv, int P, int page,
                       int page_shift, int maxp, int span, int n_split, float scale) {
  using Lt = Layout<T, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* qs = reinterpret_cast<float*>(ring + kStages * Lt::kStage);  // G x D
  float* m_s = qs + kMaxG * D;
  float* l_s = m_s + kMaxG;
  float* ps = l_s + kMaxG;                                            // G x span
  __shared__ int last;

  __shared__ int pg_s[kMaxSpan + 1];  // the split's page ids

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // split-major: the first splits of every row are dispatched first, and
  // the empty splits of short rows, which only read their length, last
  const int n_bh = gridDim.x / n_split;
  const int split = blockIdx.x / n_bh, bh = blockIdx.x % n_bh;
  const int b = bh / Hkv, hk = bh % Hkv;
  const int G = H / Hkv;
  const int s0 = split * span;
  // the pages the span can touch (at most kMaxSpan + 1), read while the
  // length is read
  const int p0 = s0 / page, n_pg = min(maxp - p0, (span + page - 1) / page + 1);
  const int* trow = table + (long long)b * maxp + p0;
  int pg_r[(kMaxSpan + 1 + kThreads - 1) / kThreads];
#pragma unroll
  for (int r = 0; r < (kMaxSpan + 1 + kThreads - 1) / kThreads; ++r)
    pg_r[r] = tid + r * kThreads < n_pg ? trow[tid + r * kThreads] : 0;
  // with a new token: its position (the count before it), else -1
  const int new_pos = k_new != nullptr ? length[b] : -1;
  const int L = max(0, min(k_new != nullptr ? new_pos + 1 : length[b], maxp * page));
  const int n_active = (L + span - 1) / span;
  T* out = o + ((long long)b * H + hk * G) * D;
  const long long new_row = ((long long)b * Hkv + hk) * D;  // the row's k_new / v_new head row

  if (split == 0 && new_pos >= 0 && tid < 2 * Lt::kChunks) {  // the token write
    const int pp = page_shift >= 0 ? new_pos >> page_shift : new_pos / page;
    const int pg = pp < maxp ? table[(long long)b * maxp + pp] : 0;
    const int off = page_shift >= 0 ? new_pos & (page - 1) : new_pos - pp * page;
    if (pg >= 0 && pg < P) {  // never outside the pool
      const int side = tid / Lt::kChunks, c = (tid % Lt::kChunks) * Lt::kVec;
      const long long dst = (((long long)hk * P + pg) * page + off) * D + c;
      *reinterpret_cast<uint4*>((side ? pool_v : pool_k) + dst) =
          *reinterpret_cast<const uint4*>((side ? v_new : k_new) + new_row + c);
    }
  }

  if (s0 >= L) {  // an empty split; split 0 of an empty row writes its zeros
    if (L == 0 && split == 0)
      for (int e = tid; e < G * D; e += kThreads) store(out + e, 0.f);
    return;
  }
#pragma unroll
  for (int r = 0; r < (kMaxSpan + 1 + kThreads - 1) / kThreads; ++r)
    if (tid + r * kThreads < n_pg) pg_s[tid + r * kThreads] = pg_r[r];
  __syncthreads();
  const int n_pos = min(span, L - s0);
  const int nt = (n_pos + kBK - 1) / kBK;  // tiles of K, then as many of V

  // tile u < nt: K positions s0 + 64u..; u >= nt: V positions s0 + 64(u - nt)..
  // a thread's chunks: positions jc + n (kThreads / kChunks) of a tile, the
  // same 16 bytes cc of each row; the page and the offset in it by a shift
  // where page is a power of two (the usual case), else by a division
  const int cc = tid % Lt::kChunks, jc = tid / Lt::kChunks;
  const long long hk_base = (long long)hk * P * page * D + cc * Lt::kVec;
  auto issue = [&](int u) {
    if (u < 2 * nt) {
      const T* pool = (u < nt ? pool_k : pool_v) + hk_base;
      const int k0 = s0 + (u < nt ? u : u - nt) * kBK;
      T* stage = ring + (u % kStages) * Lt::kStage + cc * Lt::kVec;
#pragma unroll
      for (int n = 0; n < kBK * Lt::kChunks / kThreads; ++n) {
        const int j = jc + n * (kThreads / Lt::kChunks), pos = k0 + j;
        const bool valid = pos < s0 + n_pos;
        const int pi = page_shift >= 0 ? pos >> page_shift : pos / page;
        const int off = page_shift >= 0 ? pos & (page - 1) : pos - pi * page;
        // the new token's position comes from k_new / v_new, not the pool
        const T* src = !valid ? pool
                       : pos == new_pos ? (u < nt ? k_new : v_new) + new_row + cc * Lt::kVec
                                        : pool + ((long long)pg_s[pi - p0] * page + off) * D;
        cp_async16(stage + j * Lt::kRow, src, valid);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

#pragma unroll
  for (int u = 0; u < kStages - 1; ++u) issue(u);
  for (int e = tid; e < G * D; e += kThreads)
    qs[e] = to_f(q[((long long)b * H + hk * G) * D + e]);

  // PV: thread -> dims 2p, 2p+1 of heads grp, grp + kGroups, ...
  const int pr = tid % Lt::kPairs, grp = tid / Lt::kPairs;
  float acc[Lt::kHeadsPV][2][2];  // head, position parity, dim
#pragma unroll
  for (int r = 0; r < Lt::kHeadsPV; ++r) acc[r][0][0] = acc[r][0][1] = acc[r][1][0] = acc[r][1][1] = 0.f;
  // scores: thread -> position jl of the tile, heads ig, ig + 4, ...
  const int jl = tid % kBK, ig = tid / kBK;

  for (int u = 0; u < 2 * nt; ++u) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile u has landed for every thread; tile u - 1 is done with
    const T* stage = ring + (u % kStages) * Lt::kStage;
    if (u == nt) {
      // the split's scores are complete: the exact max and sum of each head
      if (warp < G) {
        float* row = ps + warp * span;
        const int n = nt * kBK;
        float mx = kNegInf;
        for (int j = lane; j < n; j += 32) mx = fmaxf(mx, row[j]);
        mx = warp_max(mx);
        float sum = 0.f;
        for (int j = lane; j < n; j += 32) {
          const float p = expf(row[j] - mx);
          row[j] = p;
          sum += p;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          m_s[warp] = mx;
          l_s[warp] = sum;
        }
      }
      __syncthreads();
    }
    if (u < nt) {
      // four partial sums a head (chains of D / 4 FMAs), added at the end
      const int k0 = u * kBK;
      float s[Lt::kHeadsS][4];
#pragma unroll
      for (int r = 0; r < Lt::kHeadsS; ++r) s[r][0] = s[r][1] = s[r][2] = s[r][3] = 0.f;
      const T* krow = stage + jl * Lt::kRow;
#pragma unroll
      for (int c = 0; c < Lt::kChunks; ++c) {
        float kf[Lt::kVec];
        unpack(*reinterpret_cast<const uint4*>(krow + c * Lt::kVec), kf, T());
#pragma unroll
        for (int r = 0; r < Lt::kHeadsS; ++r) {
          const int i = ig + r * (kThreads / kBK);
          if (i < G) {
            const float4* qv = reinterpret_cast<const float4*>(qs + i * D + c * Lt::kVec);
#pragma unroll
            for (int v = 0; v < Lt::kVec / 4; ++v) {
              const float4 qq = qv[v];
              float& a = s[r][(c * (Lt::kVec / 4) + v) % 4];
              a = fmaf(qq.x, kf[4 * v], a);
              a = fmaf(qq.y, kf[4 * v + 1], a);
              a = fmaf(qq.z, kf[4 * v + 2], a);
              a = fmaf(qq.w, kf[4 * v + 3], a);
            }
          }
        }
      }
      const bool in = k0 + jl < n_pos;
#pragma unroll
      for (int r = 0; r < Lt::kHeadsS; ++r) {
        const int i = ig + r * (kThreads / kBK);
        if (i < G)
          ps[i * span + k0 + jl] = in ? ((s[r][0] + s[r][1]) + (s[r][2] + s[r][3])) * scale
                                      : kNegInf;
      }
    } else {
      const int k0 = (u - nt) * kBK;
#pragma unroll 4
      for (int j = 0; j < kBK; j += 4) {
        float2 v[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) v[jj] = load2(stage + (j + jj) * Lt::kRow + 2 * pr);
#pragma unroll
        for (int r = 0; r < Lt::kHeadsPV; ++r) {
          const int i = grp + r * Lt::kGroups;
          if (i < G) {  // even positions into acc[r][0], odd into acc[r][1]
            const float4 p = *reinterpret_cast<const float4*>(ps + i * span + k0 + j);
            acc[r][0][0] = fmaf(p.x, v[0].x, acc[r][0][0]);
            acc[r][0][1] = fmaf(p.x, v[0].y, acc[r][0][1]);
            acc[r][1][0] = fmaf(p.y, v[1].x, acc[r][1][0]);
            acc[r][1][1] = fmaf(p.y, v[1].y, acc[r][1][1]);
            acc[r][0][0] = fmaf(p.z, v[2].x, acc[r][0][0]);
            acc[r][0][1] = fmaf(p.z, v[2].y, acc[r][0][1]);
            acc[r][1][0] = fmaf(p.w, v[3].x, acc[r][1][0]);
            acc[r][1][1] = fmaf(p.w, v[3].y, acc[r][1][1]);
          }
        }
      }
    }
    issue(u + kStages - 1);
  }
  cp_async_wait<0>();
  float o2[Lt::kHeadsPV][2];
#pragma unroll
  for (int r = 0; r < Lt::kHeadsPV; ++r) {
    o2[r][0] = acc[r][0][0] + acc[r][1][0];
    o2[r][1] = acc[r][0][1] + acc[r][1][1];
  }

  if (n_active == 1) {  // the whole row in this split: no merge
#pragma unroll
    for (int r = 0; r < Lt::kHeadsPV; ++r) {
      const int i = grp + r * Lt::kGroups;
      if (i < G) {
        store(out + i * D + 2 * pr, o2[r][0] / fmaxf(l_s[i], 1e-30f));
        store(out + i * D + 2 * pr + 1, o2[r][1] / fmaxf(l_s[i], 1e-30f));
      }
    }
    return;
  }

  // this split's partial: (m, l) and the unnormalised acc, in fp32
  float* my_acc = ws_acc + ((long long)bh * n_split + split) * kMaxG * D;
  float* my_ml = ws_ml + ((long long)bh * n_split + split) * 2 * kMaxG;
#pragma unroll
  for (int r = 0; r < Lt::kHeadsPV; ++r) {
    const int i = grp + r * Lt::kGroups;
    if (i < G) *reinterpret_cast<float2*>(my_acc + i * D + 2 * pr) = make_float2(o2[r][0], o2[r][1]);
  }
  if (tid < G) {
    my_ml[tid] = m_s[tid];
    my_ml[kMaxG + tid] = l_s[tid];
  }
  __threadfence();  // the partial is visible device-wide before it is counted
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + bh, 1) == n_active - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid == 0) counters[bh] = 0;  // ready for the next call

  // the merge, in a fixed order: M = max_s m_s and the weights
  // w_s = exp(m_s - M) once a head, then l = sum_s w_s l_s (lanes over
  // splits, a warp tree) and acc = sum_s w_s acc_s in split order, the
  // partials' loads many at a time; weights in the ring, a pass of `cap`
  // splits at a time
  const float* base_acc = ws_acc + (long long)bh * n_split * kMaxG * D;
  const float* base_ml = ws_ml + (long long)bh * n_split * 2 * kMaxG;
  float* w_s = reinterpret_cast<float*>(ring);
  constexpr int cap = kStages * Lt::kStage * (int)sizeof(T) / (int)sizeof(float) / kMaxG;
  if (warp < G) {
    float mx = kNegInf;
    for (int sp = lane; sp < n_active; sp += 32) mx = fmaxf(mx, __ldcg(base_ml + sp * 2 * kMaxG + warp));
    mx = warp_max(mx);
    if (lane == 0) {
      m_s[warp] = mx;
      l_s[warp] = 0.f;
    }
  }
  float a[Lt::kMergeElems];
#pragma unroll
  for (int r = 0; r < Lt::kMergeElems; ++r) a[r] = 0.f;
  for (int c0 = 0; c0 < n_active; c0 += cap) {
    const int cn = min(cap, n_active - c0);
    __syncthreads();  // M is known; the previous pass is done with the weights
    for (int x = tid; x < G * cn; x += kThreads) {
      const int i = x / cn, sp = x % cn;
      w_s[i * cap + sp] = expf(__ldcg(base_ml + (c0 + sp) * 2 * kMaxG + i) - m_s[i]);
    }
    __syncthreads();
    if (warp < G) {
      float v = 0.f;
      for (int sp = lane; sp < cn; sp += 32)
        v = fmaf(w_s[warp * cap + sp], __ldcg(base_ml + (c0 + sp) * 2 * kMaxG + kMaxG + warp), v);
      v = warp_sum(v);
      if (lane == 0) l_s[warp] += v;
    }
    const float* pa = base_acc + (long long)c0 * kMaxG * D;
#pragma unroll 8
    for (int sp = 0; sp < cn; ++sp) {
#pragma unroll
      for (int r = 0; r < Lt::kMergeElems; ++r) {
        const int e = tid + r * kThreads;
        if (e < G * D)
          a[r] = fmaf(w_s[(e / D) * cap + sp], __ldcg(pa + (long long)sp * kMaxG * D + e), a[r]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < Lt::kMergeElems; ++r) {
    const int e = tid + r * kThreads;
    if (e < G * D) store(out + e, a[r] / fmaxf(l_s[e / D], 1e-30f));
  }
}

// Raise a kernel's dynamic shared memory limit to `bytes` (its most), once a
// device (`done`, one array a kernel): the call costs microseconds of host
// time, more than some launches.
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, int bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <typename T, int D>
int launch(const void* q, void* pool_k, void* pool_v, const void* table, const void* length,
           const void* k_new, const void* v_new, void* o, void* ws_acc, void* ws_ml,
           void* counters, int K, int H, int Hkv, int P, int page, int maxp, int span,
           float scale, cudaStream_t stream) {
  using Lt = Layout<T, D>;
  auto kern = paged_attention_kernel<T, D>;
  static bool done[64] = {};
  const cudaError_t err = allow_smem(kern, (int)Lt::smem(kMaxSpan), done);
  if (err != cudaSuccess) return (int)err;
  const int n_split = (maxp * page + span - 1) / span;
  kern<<<(unsigned)((long long)K * Hkv * n_split), kThreads, Lt::smem(span), stream>>>(
      static_cast<const T*>(q), static_cast<T*>(pool_k), static_cast<T*>(pool_v),
      static_cast<const int*>(table), static_cast<const int*>(length),
      static_cast<const T*>(k_new), static_cast<const T*>(v_new), static_cast<T*>(o),
      static_cast<float*>(ws_acc), static_cast<float*>(ws_ml), static_cast<int*>(counters), H,
      Hkv, P, page, (page & (page - 1)) ? -1 : __builtin_ctz(page), maxp, span, n_split, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (K, 1, H, D) contiguous; pool_k/pool_v (Hkv, P, page, D) contiguous in
// q's dtype, 16-byte aligned; table (K, maxp) and length (K,) int32 on the
// device; o (K, 1, H, D) contiguous.  D in {64, 128}; H / Hkv <= 8; span a
// multiple of 64 in [64, 512].  ws_acc (K x Hkv x n_split x 8 x D) and
// ws_ml (K x Hkv x n_split x 16) fp32 scratch, n_split = ceil(maxp x page /
// span); counters (K x Hkv) int32, zero before the call and zero after it.
// k_new and v_new: both null (attend over length positions), or both
// (K, Hkv, D) contiguous in the pool's dtype, 16-byte aligned (write them at
// each row's position length, then attend over length + 1 positions).
extern "C" int sm_paged_attention(const void* q, void* pool_k, void* pool_v, const void* table,
                                  const void* length, const void* k_new, const void* v_new,
                                  void* o, void* ws_acc, void* ws_ml, void* counters, int K,
                                  int H, int Hkv, int D, int P, int page, int maxp, int span,
                                  int is_bf16, float scale, void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  if (K < 1 || Hkv < 1 || H % Hkv || H / Hkv > kMaxG || P < 1 || page < 1 || maxp < 1 ||
      span < kBK || span > kMaxSpan || span % kBK)
    return (int)cudaErrorInvalidValue;
  const long long n_split = ((long long)maxp * page + span - 1) / span;
  if ((long long)K * Hkv * n_split > 2147483647LL) return (int)cudaErrorInvalidValue;
  if ((k_new == nullptr) != (v_new == nullptr)) return (int)cudaErrorInvalidValue;
  for (const void* p : {(const void*)pool_k, (const void*)pool_v, k_new, v_new})
    if (reinterpret_cast<unsigned long long>(p) % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define SM_PAGED_LAUNCH(T, DD)                                                                  \
  return launch<T, DD>(q, pool_k, pool_v, table, length, k_new, v_new, o, ws_acc, ws_ml,   \
                       counters, K, H, Hkv, P, page, maxp, span, scale, s)
  if (is_bf16) {
    if (D == 64) SM_PAGED_LAUNCH(__nv_bfloat16, 64);
    if (D == 128) SM_PAGED_LAUNCH(__nv_bfloat16, 128);
  } else {
    if (D == 64) SM_PAGED_LAUNCH(float, 64);
    if (D == 128) SM_PAGED_LAUNCH(float, 128);
  }
#undef SM_PAGED_LAUNCH
  return (int)cudaErrorInvalidValue;
}
