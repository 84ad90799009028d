// Fused int4 weight-only matvec: y = x @ unpack(W)^T * scale.
//
// Replaces the JAX package's ops/int4_matvec.py::_int4_matvec_kernel
// (entry point int4_matvec), the gate LM's linears under quantize_gate="int4".
//
// Bound on the H100: bytes.  At most 8 tokens share each weight row, so the
// kernel does ~4 flops per packed byte for each token, far under the ~295
// flops/byte the card needs before compute is the limit.  The packed weight
// (out x in/2 bytes) is read once from device memory; everything else is
// small beside it.
//
// Pack layout (column-halved, as utils/quantize.py writes it): the low
// nibble of byte c of a row is input column c, the high nibble is column
// in/2 + c, both sign-extended; one fp32 scale a row.
//
// Arithmetic: x keeps its own precision, every product is exact in fp32,
// the sums are fp32, the row's fp32 scale multiplies the sum and the result
// is rounded once to x's dtype.
//
// Design, bf16 x (the serving path), the int8 kernel's (csrc/int8_matvec.cu)
// carried over to the packed layout:
//  * x once per block, in shared memory: the B <= 8 token rows in chunks of
//    32 KB, double-buffered where there is more than one, filled by 16-byte
//    cp.async (the first version's warps each re-read x from L1/L2 for
//    every 16 weight bytes: 16x the weight bytes at B 4).  A chunk of
//    packed columns c0..c0+cw needs x columns c0..c0+cw and
//    in/2+c0..in/2+c0+cw, so it holds both ranges of every token row (8192
//    / B packed columns: the whole input at B 1; the down projection's
//    14336 columns at B 8 take seven chunks).
//  * Tensor cores: mma.sync m16n8k16 bf16 with fp32 accumulators.  A warp
//    owns a tile of 16 weight rows (A), the tokens are B (n = 8, the columns
//    past B zero).  The nibbles become bf16 in registers, exactly (|w| <= 8):
//    (n ^ 8) under 0x43 is the bf16 128 + (n ^ 8), and a bf16x2 subtract of
//    136 leaves n.  Each product is exact in fp32, so only the order of the
//    sums differs from the plain version.
//  * The sum over k is order-free, so one permutation of k is applied to A
//    and B alike within each step of 64 packed columns: lane (g, t) =
//    (lane / 4, lane % 4) loads 16 contiguous bytes of rows g and g + 8 at
//    packed columns 16t..16t+15 of the step; its 32-bit word q holds the low
//    nibbles of columns 16t + 4q + {0..3} and the high nibbles of the same
//    columns of the upper half.  Of the step's eight k16 products, product
//    2q takes the low nibbles: k pairs (2t, 2t+1) and (2t+8, 2t+9) are
//    columns 16t + 4q + {0,1} and {2,3}; product 2q + 1 the high nibbles,
//    the same columns of the upper half.  The lane reads the same columns of
//    token g from shared memory: no shuffles.  Products 2q and 2q + 1 add
//    into accumulator q, four chains of dependent mma.sync a tile added in
//    order at the end (up to 8 % faster than one chain at B 1 on an H100:
//    PERF.md).
//  * Weights stream straight from HBM to registers (L1::no_allocate), 2
//    steps a batch, 16 bytes of each of a warp's rows a step, the next
//    batch in flight while one is multiplied, across chunk boundaries too,
//    the first before x is staged.
//    (A ring of 4-8 steps a warp in shared memory, filled by cp.async, held
//    more bytes in flight and measured slower at every depth: PERF.md.)
//  * The grid: a warp holds TW tiles of 16 rows (TW = 2 where the host asks:
//    each x fragment, read from shared memory, then feeds the products of
//    both; at B 8 a step's x is twice one tile's weight bytes), a block's 8
//    warps cover `row_tiles` tiles, several warps splitting a tile's
//    columns where there are fewer tiles than warps, and their partial sums
//    meet in shared memory in a fixed order.  The host
//    (ops/int4_matvec.py::_grid) picks TW and row_tiles from the shapes, by
//    a sweep on an H100 (PERF.md): more rows a block share x, more blocks
//    keep more SMs streaming.
//  * Indexed (Mixtral's experts at B 1): the same kernel over a whole bank
//    (E, out, in/2), each block reading the expert's id from the device
//    (one of a router's top-k ids) and offsetting its weight and scale
//    rows, so the ids never reach the host and the launch can be captured
//    in a CUDA graph.
// fp32 x (the parity runs): the same staging of x (chunks of 512 packed
// columns), CUDA-core FMAs, one warp a row, lanes over 16-byte weight
// chunks (each lane's x read in a rotated order, free of bank conflicts),
// a fixed-order warp sum.
// B is a template constant (1, 2, 4 or 8, the tokens past B masked).  Rows
// whose packed width is not a multiple of 16 bytes take a byte-at-a-time
// kernel that reads x from global memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int4_nibbles.cuh"

namespace {

constexpr int kMaxB = 8;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// steps of 64 packed columns a warp loads at once, at every B and tiles a
// warp (4 at B 2-8 spilled and was slower on an H100: PERF.md)
constexpr int kSteps = 2;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// sign-extended low / high nibble of one packed byte
__device__ __forceinline__ float nib_lo(int byte) { return (float)(((byte & 0xF) ^ 8) - 8); }
__device__ __forceinline__ float nib_hi(int byte) { return (float)((((byte >> 4) & 0xF) ^ 8) - 8); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// packed columns [c0, c0 + cw) of x's first B rows into xs: x columns
// c0.. at xs[b * xrow], x columns half + c0.. at xs[b * xrow + hoff]
template <typename T>
__device__ __forceinline__ void stage_x(T* xs, const T* __restrict__ x, int B, int din, int c0,
                                        int cw, int xrow, int hoff) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_half = cw / kVec, per_row = 2 * per_half, half = din / 2;
  for (int e = threadIdx.x; e < B * per_row; e += kThreads) {
    const int b = e / per_row, r = e % per_row, hi = r >= per_half, c = (r - hi * per_half) * kVec;
    cp_async16(xs + b * xrow + hi * hoff + c, x + (size_t)b * din + hi * half + c0 + c);
  }
}

// 16 weight bytes, read once: not kept in L1
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void mma_bf16(float* c, unsigned int a0, unsigned int a1,
                                         unsigned int a2, unsigned int a3, unsigned int b0,
                                         unsigned int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// bf16 x on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kTcChunkBytes = 32768;  // a chunk of x, both halves of all its rows

// packed columns a chunk of NB token rows
template <int NB>
__host__ __device__ constexpr int tc_cols() { return kTcChunkBytes / (4 * NB); }
// packed columns a staged chunk holds: the chunk, or the whole row where it
// is shorter, in whole 64-column steps (so both halves start 128-byte aligned)
template <int NB>
__host__ __device__ inline int tc_width(int half) {
  const int whole = (half + 63) / 64 * 64;
  return whole < tc_cols<NB>() ? whole : tc_cols<NB>();
}
// a token row in shared memory: both halves and 16 bytes of padding, so the
// 16-byte reads of neighbouring rows fall on other banks
__host__ __device__ inline int tc_row(int width) { return 2 * width + 8; }
// one x buffer where one chunk holds the whole input, else two; then the
// warps' sums
template <int NB, int TW>
size_t tc_smem(int half) {
  const int buffers = half > tc_cols<NB>() ? 2 : 1;
  return sizeof(__nv_bfloat16) * buffers * NB * tc_row(tc_width<NB>(half)) +
         sizeof(float) * kWarps * TW * 16 * 8;
}

template <int NB, int TW, bool kIndexed>
__global__ void __launch_bounds__(kThreads)
int4_matvec_tc_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                      const float* __restrict__ scale, __nv_bfloat16* __restrict__ y, int B,
                      int din, int dout, int row_tiles, const long long* __restrict__ expert) {
  constexpr int kCols = tc_cols<NB>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int half = din / 2, width = tc_width<NB>(half), xrow = tc_row(width);
  if constexpr (kIndexed) {  // w and scale are a bank: expert e's rows start e slices in
    const long long e = __ldg(expert);
    w += e * dout * half;
    scale += e * dout;
  }
  const int buffers = half > kCols ? 2 : 1;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // buffers x NB x xrow
  float* red = reinterpret_cast<float*>(xs + buffers * NB * xrow);  // warp x tile x 16 x 8

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wk = kWarps * TW / row_tiles;  // warps splitting a warp's tiles' columns
  const int set = warp / wk, kk = warp % wk;
  // rows g and g + 8 of each of the warp's tiles
  const int8_t* wr[TW][2];
  bool ok[TW][2];
#pragma unroll
  for (int j = 0; j < TW; ++j) {
    const int row0 = (blockIdx.x * row_tiles + set * TW + j) * 16;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ok[j][h] = row0 + g + 8 * h < dout;
      wr[j][h] = w + (size_t)min(row0 + g + 8 * h, dout - 1) * half;
    }
  }
  const bool has_tok = g < B;

  // kSteps steps of 64 packed columns, s0, s0 + wk, ... of chunk ch (warp kk
  // takes the steps kk, kk + wk, ... of each chunk): 16 bytes of each of
  // the warp's rows at packed columns 64 step + 16t, zero past the rows and
  // the columns
  auto load = [&](int ch, int s0, uint4 (*a)[TW][2]) {
    const int c0 = ch * kCols, cw = min(kCols, half - c0), steps = (cw + 63) / 64;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int col = (s0 + u * wk) * 64 + 16 * t;
      const bool in = s0 + u * wk < steps && col < cw;
#pragma unroll
      for (int j = 0; j < TW; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          a[u][j][h] = in && ok[j][h] ? ld_stream(wr[j][h] + c0 + col) : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  // accumulator q of tile j: products 2q and 2q + 1 of every step
  float acc[TW][4][4] = {};
  const int n_chunks = (half + kCols - 1) / kCols;
  uint4 wcur[kSteps][TW][2], wnext[kSteps][TW][2];
  load(0, kk, wcur);  // the first weights fly while x is staged
  stage_x(xs, x, B, din, 0, min(kCols, half), xrow, width);
  cp_async_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * kCols, cw = min(kCols, half - c0);
    if (ch + 1 < n_chunks)
      stage_x(xs + ((ch + 1) & 1) * NB * xrow, x, B, din, c0 + kCols,
              min(kCols, half - c0 - kCols), xrow, width);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // chunk ch is in shared memory for every warp
    const __nv_bfloat16* xr = xs + (ch & 1) * NB * xrow + g * xrow;
    const int steps = (cw + 63) / 64;
    for (int s0 = kk; s0 < steps; s0 += wk * kSteps) {
      // the next batch of weights, in this chunk or the next, flies during this one
      const bool same = s0 + wk * kSteps < steps;
      if (same || ch + 1 < n_chunks)
        load(same ? ch : ch + 1, same ? s0 + wk * kSteps : kk, wnext);
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        if (s0 + u * wk >= steps) break;  // the same for the whole warp
        const int col = (s0 + u * wk) * 64 + 16 * t;
        uint4 xl0 = make_uint4(0u, 0u, 0u, 0u), xl1 = xl0, xh0 = xl0, xh1 = xl0;
        if (has_tok && col < cw) {
          xl0 = *reinterpret_cast<const uint4*>(xr + col);
          xl1 = *reinterpret_cast<const uint4*>(xr + col + 8);
          xh0 = *reinterpret_cast<const uint4*>(xr + width + col);
          xh1 = *reinterpret_cast<const uint4*>(xr + width + col + 8);
        }
        const unsigned int xl[8] = {xl0.x, xl0.y, xl0.z, xl0.w, xl1.x, xl1.y, xl1.z, xl1.w};
        const unsigned int xh[8] = {xh0.x, xh0.y, xh0.z, xh0.w, xh1.x, xh1.y, xh1.z, xh1.w};
#pragma unroll
        for (int j = 0; j < TW; ++j) {
          const uint4 a0 = wcur[u][j][0], a1 = wcur[u][j][1];
          const unsigned int ww0[4] = {a0.x, a0.y, a0.z, a0.w};
          const unsigned int ww1[4] = {a1.x, a1.y, a1.z, a1.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {  // packed columns 16t + 4q .. 16t + 4q + 3
            unsigned int lo0[2], hi0[2], lo1[2], hi1[2];
            nib8_to_bf16x2(ww0[q], lo0, hi0);
            nib8_to_bf16x2(ww1[q], lo1, hi1);
            mma_bf16(acc[j][q], lo0[0], lo1[0], lo0[1], lo1[1], xl[2 * q], xl[2 * q + 1]);
            mma_bf16(acc[j][q], hi0[0], hi1[0], hi0[1], hi1[1], xh[2 * q], xh[2 * q + 1]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kSteps; ++u)
#pragma unroll
        for (int j = 0; j < TW; ++j) {
          wcur[u][j][0] = wnext[u][j][0];
          wcur[u][j][1] = wnext[u][j][1];
        }
    }
    __syncthreads();  // every warp is done with this buffer before it is restaged
  }

  // per tile j: rows g and g + 8, tokens 2t and 2t + 1
#pragma unroll
  for (int j = 0; j < TW; ++j) {
    float c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      c[i] = ((acc[j][0][i] + acc[j][1][i]) + acc[j][2][i]) + acc[j][3][i];
    float* r = red + (warp * TW + j) * 128;
    r[g * 8 + 2 * t] = c[0];
    r[g * 8 + 2 * t + 1] = c[1];
    r[(g + 8) * 8 + 2 * t] = c[2];
    r[(g + 8) * 8 + 2 * t + 1] = c[3];
  }
  __syncthreads();
  const int rows = row_tiles * 16;
  for (int e = tid; e < B * rows; e += kThreads) {
    // tile ti of the block is tile ti % TW of the warps (ti / TW) wk + k
    const int n = e / rows, i = e % rows, ti = i / 16, ri = i % 16;
    const int row = blockIdx.x * rows + i;
    if (row < dout) {
      const float* part = red + ((ti / TW) * wk * TW + ti % TW) * 128 + ri * 8 + n;
      float sum = part[0];
      for (int k = 1; k < wk; ++k) sum += part[k * TW * 128];
      y[(size_t)n * dout + row] = __float2bfloat16(sum * scale[row]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 x on CUDA-core FMAs
// ---------------------------------------------------------------------------
constexpr int kF32Cols = 512;             // packed columns a chunk (4 KB of each half of x)
constexpr int kF32Row = 2 * kF32Cols + 4;  // a token row: both halves, padded

template <int NB>
constexpr size_t f32_smem() {
  return sizeof(float) * 2 * NB * kF32Row;
}

// byte j of v under 0x4B000000 is the fp32 2^23 + byte: v's bytes are n ^ 8,
// so 2^23 + 8 off it is the nibble n, exactly
__device__ __forceinline__ float nib_f(unsigned int v, int j) {
  return __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7650 | j)) - 8388616.f;
}

template <int NB>
__global__ void __launch_bounds__(kThreads)
int4_matvec_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ scale, float* __restrict__ y, int B, int din,
                       int dout) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // 2 x NB x kF32Row
  const int lane = threadIdx.x % 32, half = din / 2;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int8_t* wr = w + (size_t)min(row, dout - 1) * half;

  float acc[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.f;
  const int n_chunks = (half + kF32Cols - 1) / kF32Cols;
  stage_x(xs, x, B, din, 0, min(kF32Cols, half), kF32Row, kF32Cols);
  cp_async_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * kF32Cols, cw = min(kF32Cols, half - c0);
    if (ch + 1 < n_chunks)
      stage_x(xs + ((ch + 1) & 1) * NB * kF32Row, x, B, din, c0 + kF32Cols,
              min(kF32Cols, half - c0 - kF32Cols), kF32Row, kF32Cols);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* xb = xs + (ch & 1) * NB * kF32Row;
    if (row < dout) {
#pragma unroll 2
      for (int cc = lane; cc < cw / 16; cc += 32) {
        const uint4 pk = ld_stream(wr + c0 + 16 * cc);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          // the lane's 16 packed columns in 4 groups, taken in a rotated
          // order so that 8 neighbouring lanes read 8 distinct 16-byte banks
          const int rv = (v + (cc >> 1)) & 3;
          const unsigned int word = rv == 0 ? pk.x : rv == 1 ? pk.y : rv == 2 ? pk.z : pk.w;
          const unsigned int lo = (word & 0x0F0F0F0Fu) ^ 0x08080808u;
          const unsigned int hi = ((word >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
          const float l0 = nib_f(lo, 0), l1 = nib_f(lo, 1), l2 = nib_f(lo, 2), l3 = nib_f(lo, 3);
          const float h0 = nib_f(hi, 0), h1 = nib_f(hi, 1), h2 = nib_f(hi, 2), h3 = nib_f(hi, 3);
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            if (b < B) {
              const float* xt = xb + b * kF32Row + 16 * cc + 4 * rv;
              const float4 fl = *reinterpret_cast<const float4*>(xt);
              const float4 fh = *reinterpret_cast<const float4*>(xt + kF32Cols);
              float a = acc[b];
              a = fmaf(fl.x, l0, a);
              a = fmaf(fh.x, h0, a);
              a = fmaf(fl.y, l1, a);
              a = fmaf(fh.y, h1, a);
              a = fmaf(fl.z, l2, a);
              a = fmaf(fh.z, h2, a);
              a = fmaf(fl.w, l3, a);
              acc[b] = fmaf(fh.w, h3, a);
            }
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], off);
  }
  if (lane == 0 && row < dout) {
    const float s = scale[row];
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b < B) y[(size_t)b * dout + row] = acc[b] * s;
  }
}

// ---------------------------------------------------------------------------
// packed rows that are not a whole number of 16-byte words: a byte at a time
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
int4_matvec_bytes_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                         const float* __restrict__ scale, T* __restrict__ y, int B, int din,
                         int dout) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= dout) return;
  const int half = din / 2;
  const int8_t* wr = w + (size_t)row * half;
  float acc[kMaxB];
#pragma unroll
  for (int b = 0; b < kMaxB; ++b) acc[b] = 0.f;
  for (int c = lane; c < half; c += 32) {
    const int byte = (int)(uint8_t)wr[c];
    const float lo = nib_lo(byte), hi = nib_hi(byte);
#pragma unroll
    for (int b = 0; b < kMaxB; ++b) {
      if (b < B) {
        acc[b] = fmaf(to_f(x[(size_t)b * din + c]), lo, acc[b]);
        acc[b] = fmaf(to_f(x[(size_t)b * din + half + c]), hi, acc[b]);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < kMaxB; ++b) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], off);
  }
  if (lane == 0) {
    const float s = scale[row];
    for (int b = 0; b < B; ++b) store(y + (size_t)b * dout + row, acc[b] * s);
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

template <int NB, int TW, bool kIndexed = false>
int launch_tc(const void* x, const void* w, const void* scale, void* y, int B, int din, int dout,
              int row_tiles, cudaStream_t s, const long long* expert = nullptr) {
  // a block's 8 warps hold TW tiles each, all of them or a share of the
  // columns of each
  if (row_tiles < TW || row_tiles > kWarps * TW) return (int)cudaErrorInvalidValue;
  auto kern = int4_matvec_tc_kernel<NB, TW, kIndexed>;
  static bool done[64] = {};
  const cudaError_t err = allow_smem(kern, (int)tc_smem<NB, TW>(tc_cols<NB>() + 1), done);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (dout + 15) / 16;
  kern<<<(tiles + row_tiles - 1) / row_tiles, kThreads, tc_smem<NB, TW>(din / 2), s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), B, din, dout, row_tiles,
      expert);
  return (int)cudaGetLastError();
}

template <int NB>
int launch_f32(const void* x, const void* w, const void* scale, void* y, int B, int din, int dout,
               cudaStream_t s) {
  auto kern = int4_matvec_f32_kernel<NB>;
  static bool done[64] = {};
  const cudaError_t err = allow_smem(kern, (int)f32_smem<NB>(), done);
  if (err != cudaSuccess) return (int)err;
  kern<<<(dout + kWarps - 1) / kWarps, kThreads, f32_smem<NB>(), s>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(y), B, din, dout);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, din) fp32 or bf16, contiguous; w (dout, din/2) int8, contiguous;
// scale (dout,) fp32; y (B, dout) in x's dtype.  1 <= B <= 8, din even.
// With din/2 a multiple of 16, x and w must be 16-byte aligned (the wrapper
// checks).  The bf16 kernel's grid: tiles_a_warp (1, or 2 from B 3) tiles of
// 16 rows a warp, row_tiles (a power of two, tiles_a_warp to 8 x that) a
// block.
// Indexed (expert not null; bf16 x, B 1, din/2 a multiple of 16): w is a
// bank (E, dout, din/2) and scale (E, dout), and the kernel's blocks read
// the expert's id at `expert` on the device: a router's ids never reach the
// host.
extern "C" int sm_int4_matvec(const void* x, const void* w, const void* scale, void* y, int B,
                              int din, int dout, int is_bf16, int tiles_a_warp, int row_tiles,
                              const void* expert, void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  if (B < 1 || B > kMaxB || din < 2 || (din & 1) || dout < 1 || row_tiles < 1 ||
      (row_tiles & (row_tiles - 1)) || !(tiles_a_warp == 1 || (tiles_a_warp == 2 && B > 2)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (expert) {
    if (!is_bf16 || B != 1 || (din / 2) % 16) return (int)cudaErrorInvalidValue;
    return launch_tc<1, 1, true>(x, w, scale, y, B, din, dout, row_tiles, s,
                                 static_cast<const long long*>(expert));
  }
  if ((din / 2) % 16) {
    const dim3 grid((dout + kWarps - 1) / kWarps), block(kThreads);
    if (is_bf16)
      int4_matvec_bytes_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
          static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), B, din, dout);
    else
      int4_matvec_bytes_kernel<float><<<grid, block, 0, s>>>(
          static_cast<const float*>(x), static_cast<const int8_t*>(w),
          static_cast<const float*>(scale), static_cast<float*>(y), B, din, dout);
    return (int)cudaGetLastError();
  }
  if (is_bf16) {
#define SM_INT4_TC(NB, TW) return launch_tc<NB, TW>(x, w, scale, y, B, din, dout, row_tiles, s)
    if (B == 1) SM_INT4_TC(1, 1);
    if (B == 2) SM_INT4_TC(2, 1);
    if (B <= 4) {
      if (tiles_a_warp == 2) SM_INT4_TC(4, 2);
      SM_INT4_TC(4, 1);
    }
    if (tiles_a_warp == 2) SM_INT4_TC(8, 2);
    SM_INT4_TC(8, 1);
#undef SM_INT4_TC
  }
  if (B == 1) return launch_f32<1>(x, w, scale, y, B, din, dout, s);
  if (B == 2) return launch_f32<2>(x, w, scale, y, B, din, dout, s);
  if (B <= 4) return launch_f32<4>(x, w, scale, y, B, din, dout, s);
  return launch_f32<8>(x, w, scale, y, B, din, dout, s);
}
