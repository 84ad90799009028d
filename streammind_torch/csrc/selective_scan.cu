// Mamba-1 selective-scan forward over L steps, with the fp32 state carried
// in registers: y and the last state.
//
// Replaces the JAX package's ops/scan.py::_scan_kernel (entry point
// selective_scan_pallas, dispatch selective_scan(impl="pallas")): the
// burst catch-up's chunked projector scan (perceive_burst ->
// mamba_project_chunk -> video_mamba_forward(state=...)).  Like
// selective_scan_pallas around its pallas_call, it also applies
// softplus(dt + dt_bias), + D*u, * silu(z) and the cast to u's dtype.
//
// Bound on the H100: bytes (u, dt, z read once, y written once, A and the
// state in and out; ~6 fp32 operations and one exp for each (channel,
// state, step), under a byte's worth of the card's fp32 rate).  No tensor
// cores: the scan is a first-order recurrence, h = h*dA + dBu, with no
// product to batch.  At the burst's shape (d_inner 8192, 16 states, 32
// steps) the bytes take ~1 us, so what sets the time is latency: how many
// threads hide it, how many device-memory round trips sit on the serial
// chain, and how much work sits inside the recurrence.  Measured on an H100
// (PERF.md): ~4.3 us for one step (the launch, one round trip, the
// epilogue), then ~4.6 us each 32 steps, spent issuing the ~15 fp32
// instructions of each (state, step), 8 of them the accurate expf.
//
// Design:
//  * Threads: a block owns 32 channels of one batch row; a channel's N <= 16
//    states are spread over a group of G = 8 neighbouring lanes, ceil(N / 8)
//    states a lane (8 was the fastest of 2, 4, 8 and 16 at every shape
//    timed, PERF.md), so D 8192 at B 1 runs 256 blocks of 8 warps instead of
//    one thread a channel.  Each lane keeps its states and its row of A in registers for
//    the whole scan.
//  * Loads off the chain: the block stages a chunk of 32 steps of u, dt
//    and z for its channels, and B_t and C_t, in shared memory, and the
//    next chunk is in flight while this one is scanned (two buffers).  A
//    (B, D, L) input whose channels are contiguous and 16-byte aligned (the
//    mixer's dt and z, views of (B, L, D) products) comes by 16-byte
//    cp.async; any other strides (the burst's u, the conv output sliced
//    past its carried window, is contiguous in time) by element loads
//    spread along whichever dimension has stride 1, every load of a chunk
//    started before the first is used.  One device-memory round trip a
//    chunk, not one a step.
//  * Parallel work out of the recurrence: softplus(dt + bias) and dt*u
//    once per (channel, step) over the whole block before the scan; then
//    each lane's loop is exp(dt*A), h = h*dA + (dt*u)*B_t and its partial
//    sum of h*C_t, in which only the h update waits on the previous step.
//  * y: the lanes of a group hold partial sums over their states for each
//    of the chunk's steps; a reduce-scatter of __shfl_xor_sync (offsets
//    G/2, ..., 1; each lane sends the half of the steps it does not keep)
//    leaves each lane the full sums of 32 / G steps, in the bits of the
//    all-lane butterfly p += p[lane ^ o] (fp32 adds commute).  The lane
//    then adds D*u, multiplies by silu(z), casts, and writes into the
//    chunk's u tile, which the block stores as (B, L, D) rows, channels
//    contiguous (16-byte stores where D allows).  No atomics: the same
//    inputs give the same bits.
// Arithmetic follows the plain version step by step: softplus is
// log(1 + e^x) without a cut-over (max(x, 0) + log1p(e^-|x|)), exp is the
// accurate expf, and the state update h*dA + (dt*u)*B is kept from
// contracting into an fma, as the plain version rounds it.  Only the order
// of y's sum over the states differs: fma in state order within a lane,
// then the butterfly over the group.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxN = 16;   // states a channel
constexpr int kGroup = 8;   // lanes sharing a channel's states
constexpr int kCh = 32;     // channels a block
constexpr int kChunk = 32;  // steps staged at a time

enum Flags { kHasZ = 1, kHasD = 2, kHasBias = 4, kSoftplus = 8, kHasH0 = 16 };
// how an input's chunk is staged: 16-byte cp.async along contiguous
// channels, or element loads with neighbouring threads on neighbouring
// channels (states) or steps
enum Mode { kVector = 0, kChannelFast = 1, kTimeFast = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// an element as the staged tile keeps it: raw in u's dtype, or fp32
template <typename D, typename T>
__device__ __forceinline__ D staged(T v) {
  if constexpr (std::is_same<D, T>::value) return v;
  else return to_f(v);
}

__device__ __forceinline__ float softplus_f(float x) {
  return __fadd_rn(fmaxf(x, 0.f), log1pf(expf(-fabsf(x))));
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

struct Strides {
  long long b, c, t;  // batch, channel (or state), time
};

template <typename T>
struct Args {
  const T *u, *dt, *z, *Bm, *Cm;
  const float *A, *Dv, *dt_bias, *h0;
  T* y;
  float* h_out;
  int dim, len, N, flags, y_vec;
  Strides s[5];   // u, dt, z, B, C
  int mode[5];
};

template <typename T>
struct Smem {
  static constexpr int kPitch = kCh + 16 / sizeof(T);  // 16-byte rows, padded
  T x[2][3][kChunk][kPitch];      // u (then y), dt, z of a chunk; two buffers
  float bc[2][2][kChunk][kMaxN];  // B_t and C_t
  float2 dtd[kChunk][kCh];        // softplus(dt + bias), and that times u
  float Dv[kCh], bias[kCh];
};

// One input's chunk on its way to shared memory: steps [0, tc) of rows
// [0, rows) into dst[t][row].  An input whose rows are contiguous and
// 16-byte aligned goes by cp.async when `start` runs; any other is read
// into registers by `start` and written by `put`, so its round trip
// overlaps whatever runs between the two.  W is the tile's width (kCh
// channels or kMaxN states); either mapping spreads W * kChunk elements
// over the block, kIters a thread, neighbouring threads on the dimension
// whose stride is 1.
template <typename T, int kThreads, int W>
struct Fetch {
  static constexpr int kIters = (W * kChunk + kThreads - 1) / kThreads;
  T v[kIters];

  // the (step, row) of this thread's j-th element
  __device__ __forceinline__ static void at(int mode, int tid, int j, int& t, int& c) {
    if (mode == kTimeFast) {  // a warp reads 32 steps of one row
      t = tid % kChunk;
      c = tid / kChunk + j * (kThreads / kChunk);
    } else {
      c = tid % W;
      t = tid / W + j * (kThreads / W);
    }
  }

  __device__ __forceinline__ void start(const T* base, Strides s, int mode, int rows, int tc,
                                        int tid, T* dst, int pitch) {
    if constexpr (W == kCh) {
      if (mode == kVector) {  // rows a multiple of 16 bytes
        constexpr int kVe = 16 / sizeof(T), kPerRow = W / kVe;
#pragma unroll
        for (int j = 0; j < (kChunk * kPerRow + kThreads - 1) / kThreads; ++j) {
          const int i = tid + j * kThreads, t = i / kPerRow, c = (i % kPerRow) * kVe;
          if (t < tc && c < rows) cp_async_16(dst + t * pitch + c, base + t * s.t + c);
        }
        return;
      }
    }
#pragma unroll
    for (int j = 0; j < kIters; ++j) {
      int t, c;
      at(mode, tid, j, t, c);
      if (t < tc && c < rows) v[j] = base[c * s.c + t * s.t];
    }
  }

  template <typename D>
  __device__ __forceinline__ void put(D* dst, int pitch, int mode, int rows, int tc,
                                      int tid) const {
    if (mode == kVector) return;
#pragma unroll
    for (int j = 0; j < kIters; ++j) {
      int t, c;
      at(mode, tid, j, t, c);
      if (t < tc && c < rows) dst[t * pitch + c] = staged<D>(v[j]);
    }
  }
};

// kS consecutive fp32 values of a shared-memory row, by 8- or 16-byte loads
template <int kS>
__device__ __forceinline__ void load_row(const float* src, float (&out)[kS]) {
  if constexpr (kS % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kS; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + i);
      out[i] = v.x;
      out[i + 1] = v.y;
      out[i + 2] = v.z;
      out[i + 3] = v.w;
    }
  } else if constexpr (kS == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    out[0] = v.x;
    out[1] = v.y;
  } else {
    out[0] = src[0];
  }
}

// The serial part of one chunk: a lane's states over the chunk's steps,
// and its partial sum of h*C_t for each step in yp.  Every lane runs all
// kMaxN / G slots, so each step is one straight-line block and later
// steps' exps schedule ahead of the chain.  With kAll (N = kMaxN) every
// slot of a lane is one of its states, read from the tile rows by vector
// loads; otherwise a slot past the lane's states reads the tile's padding
// and its sum is not taken (a select, no branch).
template <int G, bool kFull, bool kAll>
__device__ __forceinline__ void recur(float (&yp)[kChunk], float (&h)[kMaxN / G],
                                      const float (&a)[kMaxN / G], const bool (&own)[kMaxN / G],
                                      const float2 (*dtd)[kCh], const float (*Bs)[kMaxN],
                                      const float (*Cs)[kMaxN], int cl, int n0, int tc) {
  constexpr int kS = kMaxN / G;
#pragma unroll
  for (int t = 0; t < kChunk; ++t) {
    float p = 0.f;
    if (kFull || t < tc) {
      const float2 dd = dtd[t][cl];
      const float dv = dd.x, du = dd.y;
      float bv[kS], cv[kS];
      if constexpr (kAll) {
        load_row<kS>(&Bs[t][n0], bv);
        load_row<kS>(&Cs[t][n0], cv);
      } else {
#pragma unroll
        for (int k = 0; k < kS; ++k) {
          bv[k] = Bs[t][n0 + k];
          cv[k] = Cs[t][n0 + k];
        }
      }
#pragma unroll
      for (int k = 0; k < kS; ++k) {
        const float dA = expf(__fmul_rn(dv, a[k]));
        h[k] = __fadd_rn(__fmul_rn(h[k], dA), __fmul_rn(du, bv[k]));
        const float q = fmaf(h[k], cv[k], p);
        p = (kAll || own[k]) ? q : p;
      }
    }
    yp[t] = p;
  }
}

// Sum yp over the G lanes of a group, one stage for each offset O = G/2,
// ..., 1: a lane keeps the half of its steps picked by its bit O and sends
// the other half to lane ^ O.  After it, lane g holds the sums of steps
// g * (kChunk / G) + i in yp[i], i < kChunk / G.
template <int O, int kHalf>
__device__ __forceinline__ void reduce_scatter(float (&yp)[kChunk], int g) {
  if constexpr (O >= 1) {
    const bool upper = (g & O) != 0;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const float lo = yp[i], hi = yp[i + kHalf];
      const float got = __shfl_xor_sync(0xffffffffu, upper ? lo : hi, O);
      yp[i] = __fadd_rn(upper ? hi : lo, got);
    }
    reduce_scatter<O / 2, kHalf / 2>(yp, g);
  }
}

template <typename T, int kThreads>
__device__ __forceinline__ void start_chunk(const Args<T>& p, Smem<T>& sm,
                                            Fetch<T, kThreads, kCh> (&fx)[3],
                                            Fetch<T, kThreads, kMaxN> (&fbc)[2], int b, int c0,
                                            int rows, int t0, int buf, int tid) {
  const int tc = min(kChunk, p.len - t0);
  const T* src[3] = {p.u, p.dt, p.z};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (i == 2 && !(p.flags & kHasZ)) continue;
    const Strides st = p.s[i];
    fx[i].start(src[i] + b * st.b + (long long)c0 * st.c + (long long)t0 * st.t, st, p.mode[i],
                rows, tc, tid, &sm.x[buf][i][0][0], Smem<T>::kPitch);
  }
  const T* bc[2] = {p.Bm, p.Cm};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const Strides st = p.s[3 + i];
    fbc[i].start(bc[i] + b * st.b + (long long)t0 * st.t, st, p.mode[3 + i], p.N, tc, tid,
                 nullptr, 0);
  }
  cp_async_commit();
}

template <typename T, int kThreads>
__device__ __forceinline__ void put_chunk(const Args<T>& p, Smem<T>& sm,
                                          const Fetch<T, kThreads, kCh> (&fx)[3],
                                          const Fetch<T, kThreads, kMaxN> (&fbc)[2], int rows,
                                          int t0, int buf, int tid) {
  const int tc = min(kChunk, p.len - t0);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    if (i < 2 || (p.flags & kHasZ))
      fx[i].put(&sm.x[buf][i][0][0], Smem<T>::kPitch, p.mode[i], rows, tc, tid);
#pragma unroll
  for (int i = 0; i < 2; ++i) fbc[i].put(&sm.bc[buf][i][0][0], kMaxN, p.mode[3 + i], p.N, tc, tid);
}

// at most 128 registers: two blocks an SM, 16 warps (the burst's B 1
// puts ~2 blocks on each SM)
template <typename T, bool kAll>
__global__ void __launch_bounds__(kCh * kGroup, 2) selective_scan_kernel(const Args<T> p) {
  constexpr int G = kGroup, kThreads = kCh * G, kS = kMaxN / G, kPer = kChunk / G;
  using S = Smem<T>;
  __shared__ __align__(16) S sm;
  const int tid = threadIdx.x, cl = tid / G, g = tid % G;
  const int b = blockIdx.y, c0 = blockIdx.x * kCh, d = c0 + cl;
  const int rows = min(kCh, p.dim - c0);
  const bool live = d < p.dim;
  // lane g owns states n0 .. n0 + mine - 1; s = ceil(N / G) <= kS, so its
  // slots n0 + k < (G - 1) * kS + kS = kMaxN stay inside a tile row
  const int s = (p.N + G - 1) / G, n0 = g * s;
  const int mine = live ? max(0, min(s, p.N - n0)) : 0;

  float h[kS], a[kS];
  bool own[kS];
#pragma unroll
  for (int k = 0; k < kS; ++k) {
    own[k] = k < mine;
    h[k] = 0.f;
    a[k] = 0.f;
    if (own[k]) {
      a[k] = p.A[(size_t)d * p.N + n0 + k];
      if (p.flags & kHasH0) h[k] = p.h0[((size_t)b * p.dim + d) * p.N + n0 + k];
    }
  }
  if (tid < kCh) {
    sm.Dv[tid] = ((p.flags & kHasD) && tid < rows) ? p.Dv[c0 + tid] : 0.f;
    sm.bias[tid] = ((p.flags & kHasBias) && tid < rows) ? p.dt_bias[c0 + tid] : 0.f;
  }

  Fetch<T, kThreads, kCh> fx[3];
  Fetch<T, kThreads, kMaxN> fbc[2];
  const int chunks = (p.len + kChunk - 1) / kChunk;
  start_chunk(p, sm, fx, fbc, b, c0, rows, 0, 0, tid);
  put_chunk(p, sm, fx, fbc, rows, 0, 0, tid);
  for (int k = 0; k < chunks; ++k) {
    const int buf = k & 1, t0 = k * kChunk, tc = min(kChunk, p.len - t0);
    const bool more = k + 1 < chunks;
    if (more) {  // the next chunk's loads fly while this one is scanned
      start_chunk(p, sm, fx, fbc, b, c0, rows, t0 + kChunk, buf ^ 1, tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // softplus(dt + bias) and dt*u, once per (channel, step)
#pragma unroll
    for (int j = 0; j < kChunk * kCh / kThreads; ++j) {
      const int i = tid + j * kThreads, t = i / kCh, c = i % kCh;
      if (t < tc) {
        float dv = to_f(sm.x[buf][1][t][c]);
        if (p.flags & kHasBias) dv = __fadd_rn(dv, sm.bias[c]);
        if (p.flags & kSoftplus) dv = softplus_f(dv);
        sm.dtd[t][c] = make_float2(dv, __fmul_rn(dv, to_f(sm.x[buf][0][t][c])));
      }
    }
    __syncthreads();
    float yp[kChunk];
    if (tc == kChunk)
      recur<G, true, kAll>(yp, h, a, own, sm.dtd, sm.bc[buf][0], sm.bc[buf][1], cl, n0, tc);
    else
      recur<G, false, kAll>(yp, h, a, own, sm.dtd, sm.bc[buf][0], sm.bc[buf][1], cl, n0, tc);
    reduce_scatter<G / 2, kChunk / 2>(yp, g);
    // + D*u, * silu(z), the cast: y overwrites u in the chunk's tile
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int t = g * kPer + i;
      if (t < tc) {
        float yv = yp[i];
        if (p.flags & kHasD) yv = __fadd_rn(yv, __fmul_rn(to_f(sm.x[buf][0][t][cl]), sm.Dv[cl]));
        if (p.flags & kHasZ) {
          const float zv = to_f(sm.x[buf][2][t][cl]);
          yv = __fmul_rn(yv, __fdiv_rn(zv, __fadd_rn(1.f, expf(-zv))));
        }
        store(&sm.x[buf][0][t][cl], yv);
      }
    }
    if (more) put_chunk(p, sm, fx, fbc, rows, t0 + kChunk, buf ^ 1, tid);
    __syncthreads();
    T* yb = p.y + ((size_t)b * p.len + t0) * p.dim + c0;
    if (p.y_vec) {  // D a multiple of 16 bytes: whole vectors in or out
      constexpr int kVe = 16 / sizeof(T), kPerRow = kCh / kVe;
#pragma unroll
      for (int j = 0; j < (kChunk * kPerRow + kThreads - 1) / kThreads; ++j) {
        const int i = tid + j * kThreads, t = i / kPerRow, c = (i % kPerRow) * kVe;
        if (t < tc && c < rows)
          *reinterpret_cast<uint4*>(yb + (size_t)t * p.dim + c) =
              *reinterpret_cast<const uint4*>(&sm.x[buf][0][t][c]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kChunk * kCh / kThreads; ++j) {
        const int i = tid + j * kThreads, t = i / kCh, c = i % kCh;
        if (t < tc && c < rows) yb[(size_t)t * p.dim + c] = sm.x[buf][0][t][c];
      }
    }
    if (more) __syncthreads();  // this buffer is staged again two chunks on
  }
#pragma unroll
  for (int k = 0; k < kS; ++k)
    if (own[k]) p.h_out[((size_t)b * p.dim + d) * p.N + n0 + k] = h[k];
}

// How one (batch, rows, len) input is staged (see Mode); only channels,
// never the N states, go by 16-byte copies.
int mode_of(const void* ptr, Strides s, int esize, int batch, int rows, int len, bool channels) {
  const int ve = 16 / esize;
  if (channels && s.c == 1 && reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && rows % ve == 0 &&
      (len == 1 || (s.t * esize) % 16 == 0) && (batch == 1 || (s.b * esize) % 16 == 0))
    return kVector;
  return (s.t == 1 && s.c != 1 && len > 1) ? kTimeFast : kChannelFast;
}

template <typename T>
int run(Args<T>& a, int batch, cudaStream_t stream) {
  const int es = sizeof(T);
  const bool has_z = a.flags & kHasZ;
  const void* ins[5] = {a.u, a.dt, has_z ? a.z : a.u, a.Bm, a.Cm};
  for (int i = 0; i < 5; ++i)
    a.mode[i] = mode_of(ins[i], a.s[i], es, batch, i < 3 ? a.dim : a.N, a.len, i < 3);
  a.y_vec = (reinterpret_cast<uintptr_t>(a.y) % 16 == 0 && a.dim % (16 / es) == 0);
  const dim3 grid((a.dim + kCh - 1) / kCh, batch), block(kCh * kGroup);
  if (a.N == kMaxN)
    selective_scan_kernel<T, true><<<grid, block, 0, stream>>>(a);
  else
    selective_scan_kernel<T, false><<<grid, block, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// u, dt, z (batch, dim, len) and B, C (batch, N, len) in one dtype (fp32 or
// bf16), any strides (in elements); A (dim, N), D and dt_bias (dim,) and h0
// (batch, dim, N) fp32 contiguous; z, D, dt_bias and h0 may be null (flags
// say which are given).  Writes y (batch, len, dim) in u's dtype and h_out
// (batch, dim, N) fp32, both contiguous.  1 <= N <= 16, len >= 1.
extern "C" int sm_selective_scan(
    const void* u, const void* dt, const void* z, const void* A, const void* Bm,
    const void* Cm, const void* Dv, const void* dt_bias, const void* h0, void* y,
    void* h_out, int batch, int dim, int len, int N, int is_bf16, int flags,
    long long su_b, long long su_d, long long su_t, long long sdt_b, long long sdt_d,
    long long sdt_t, long long sz_b, long long sz_d, long long sz_t, long long sB_b,
    long long sB_n, long long sB_t, long long sC_b, long long sC_n, long long sC_t,
    void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  if (batch < 1 || batch > 65535 || dim < 1 || len < 1 || N < 1 || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Strides st[5] = {{su_b, su_d, su_t}, {sdt_b, sdt_d, sdt_t}, {sz_b, sz_d, sz_t},
                         {sB_b, sB_n, sB_t}, {sC_b, sC_n, sC_t}};
  auto fill = [&](auto& a) {
    a.A = static_cast<const float*>(A);
    a.Dv = static_cast<const float*>(Dv);
    a.dt_bias = static_cast<const float*>(dt_bias);
    a.h0 = static_cast<const float*>(h0);
    a.h_out = static_cast<float*>(h_out);
    a.dim = dim;
    a.len = len;
    a.N = N;
    a.flags = flags;
    for (int i = 0; i < 5; ++i) a.s[i] = st[i];
  };
  if (is_bf16) {
    using T = __nv_bfloat16;
    Args<T> a{static_cast<const T*>(u), static_cast<const T*>(dt), static_cast<const T*>(z),
              static_cast<const T*>(Bm), static_cast<const T*>(Cm)};
    fill(a);
    a.y = static_cast<T*>(y);
    return run(a, batch, s);
  }
  Args<float> a{static_cast<const float*>(u), static_cast<const float*>(dt),
                static_cast<const float*>(z), static_cast<const float*>(Bm),
                static_cast<const float*>(Cm)};
  fill(a);
  a.y = static_cast<float*>(y);
  return run(a, batch, s);
}
