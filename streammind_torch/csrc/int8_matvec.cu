// Fused int8 weight-only matvec: y = x @ W^T * scale.
//
// Replaces the JAX package's ops/int8_matvec.py::_int8_matvec_kernel (entry
// point int8_matvec): the linears of the int8 gate (quantize_gate="int8")
// and of the int8 decoder (quantize_text_params(bits=8)) at <= 8 tokens.
//
// Bound on the H100: bytes.  At most 8 tokens share each weight row, so the
// kernel does ~2 flops per weight byte for each token, far under the ~295
// flops/byte the card needs before compute is the limit.  The int8 weight
// (out x in bytes) is read once from device memory; everything else is
// small beside it.
//
// Arithmetic: x keeps its own precision, every product is exact in fp32,
// the sums are fp32, the row's fp32 scale multiplies the sum and the result
// is rounded once to x's dtype.  Unlike the TPU kernel, fp32 x is never
// rounded to bf16.
//
// Design, bf16 x (the serving path):
//  * x once per block, in shared memory: the B <= 8 token rows in chunks of
//    32 KB (16384 / B columns: the whole input at B 1), double-buffered
//    where there is more than one, filled by 16-byte cp.async (the down
//    projection's 14336 columns at B 8 would not fit at once).
//  * Tensor cores: mma.sync m16n8k16 bf16 with fp32 accumulators.  A warp
//    owns a tile of 16 weight rows (A), the tokens are B (n = 8, the columns
//    past B zero).  The int8 weights become bf16 in registers: exact, as
//    |w| <= 127 fits bf16's 8-bit significand (via the fp32 2^23 trick:
//    byte + 128 in the low mantissa, minus 2^23 + 128, then a bf16x2 pack).
//    Each product is exact in fp32, so only the order of the sums differs
//    from the plain version.
//  * The sum over k is order-free, so one permutation of k is applied to A
//    and B alike within each 64-column step: lane (g, t) = (lane / 4,
//    lane % 4) loads 16 contiguous bytes of rows g and g + 8 at columns
//    16t..16t+15 of the step, and in the step's four k16 products its k
//    pairs (2t, 2t+1) and (2t+8, 2t+9) are the columns 16t + 4s + {0,1} and
//    {2,3} of product s.  It reads the same columns of token g from shared
//    memory: no shuffles.
//  * Weights stream straight from HBM to registers, 2 or 4 64-column steps
//    (2 x 16 bytes a lane each) a batch, the next batch in flight while one
//    is multiplied (across chunk boundaries too), the first before x is
//    staged.  (Two batches in flight, a warp's steps contiguous, or batches
//    of 8 steps measured no faster on the H100; batches of 2 are faster at
//    B 1 only.)  A block's 8 warps cover
//    `row_tiles` tiles of 16 rows, 8 / row_tiles warps splitting each tile's
//    k range; their partial sums meet in shared memory and are added in a
//    fixed order.  The host picks the most row_tiles that still give every
//    SM a block (the gate's 1024-row linears: 64 blocks of one tile and 8 k
//    slices).
// fp32 x (the parity runs): the same staging of x, CUDA-core FMAs, one warp
// a row, lanes over 16-byte weight chunks (each lane's x read in a rotated
// order, free of bank conflicts), a fixed-order warp sum.
// B is a template constant (1, 2, 4 or 8, the tokens past B masked).  Rows
// whose width is not a multiple of 16 bytes take a byte-at-a-time kernel
// that reads x from global memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxB = 8;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunkBytes = 4096;  // fp32 x: bytes a token row a chunk
// 64-column steps a warp loads at once: 2 at B 1, where a warp's share of
// the weights is smaller than two batches of 4 at the decoder's o, qkv,
// gate/up and down shapes, else 4 (PERF.md, tools/_probe_decode_kernels.py)
constexpr int kUnrollB1 = 2, kUnroll = 4;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// byte j (0..3) of a 32-bit word, sign-extended
__device__ __forceinline__ float sbyte(unsigned int word, int j) {
  return (float)(((int)(word << (24 - 8 * j))) >> 24);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// columns [c0, c0 + cw) of x's first B rows into xs (rows of xrow elements)
template <typename T>
__device__ __forceinline__ void stage_x(T* xs, const T* __restrict__ x, int B, int din, int c0,
                                        int cw, int xrow) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = cw / kVec;
  for (int e = threadIdx.x; e < B * per_row; e += kThreads) {
    const int b = e / per_row, c = e % per_row;
    cp_async16(xs + b * xrow + c * kVec, x + (size_t)b * din + c0 + c * kVec);
  }
}

// 16 weight bytes, read once: not kept in L1 (measured a few percent faster
// than __ldg on the H100)
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// four signed bytes → bf16x2 of bytes (0, 1) and of bytes (2, 3), exactly
__device__ __forceinline__ void i8x4_to_bf16x2(unsigned int word, unsigned int& lo,
                                               unsigned int& hi) {
  const unsigned int u = word ^ 0x80808080u;  // each byte + 128, unsigned
  // 0x4B0000XX is 2^23 + XX in fp32
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
  const __nv_bfloat162 a = __floats2bfloat162_rn(f0, f1), b = __floats2bfloat162_rn(f2, f3);
  lo = *reinterpret_cast<const unsigned int*>(&a);
  hi = *reinterpret_cast<const unsigned int*>(&b);
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
constexpr int kTcChunkBytes = 32768;  // a chunk of x, all its rows

// columns a chunk of NB token rows (the whole of every linear's input at
// B 1), and its padded row in shared memory
template <int NB>
__host__ __device__ constexpr int tc_cols() { return kTcChunkBytes / (2 * NB); }
template <int NB>
__host__ __device__ constexpr int tc_row() { return tc_cols<NB>() + 8; }
// one x buffer where one chunk holds the whole input, else two
template <int NB>
size_t tc_smem(int din) {
  const int buffers = din > tc_cols<NB>() ? 2 : 1;
  return sizeof(__nv_bfloat16) * buffers * NB * tc_row<NB>() + sizeof(float) * kWarps * 16 * 8;
}

template <int NB>
__global__ void __launch_bounds__(kThreads)
int8_matvec_tc_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                      const float* __restrict__ scale, __nv_bfloat16* __restrict__ y, int B,
                      int din, int dout, int row_tiles) {
  constexpr int kTcCols = tc_cols<NB>(), kTcRow = tc_row<NB>();
  constexpr int kU = NB == 1 ? kUnrollB1 : kUnroll;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int buffers = din > kTcCols ? 2 : 1;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // buffers x NB x kTcRow
  float* red = reinterpret_cast<float*>(xs + buffers * NB * kTcRow);  // warp x 16 rows x 8

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wk = kWarps / row_tiles;  // warps splitting a tile's k range
  const int tile = warp / wk, kk = warp % wk;
  const int row0 = (blockIdx.x * row_tiles + tile) * 16;
  const bool ok0 = row0 + g < dout, ok1 = row0 + g + 8 < dout;
  const int8_t* w0 = w + (size_t)min(row0 + g, dout - 1) * din;
  const int8_t* w1 = w + (size_t)min(row0 + g + 8, dout - 1) * din;
  const bool has_tok = g < B;

  // kU steps of 64 columns, s0, s0 + wk, ... of chunk ch (warp kk takes
  // the steps kk, kk + wk, ... of each chunk): 16 bytes of rows g and g + 8
  // at columns 64 step + 16t, zero past the rows and the columns
  auto load = [&](int ch, int s0, uint4* a, uint4* b) {
    const int c0 = ch * kTcCols, cw = min(kTcCols, din - c0), steps = (cw + 63) / 64;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int col = (s0 + u * wk) * 64 + 16 * t;
      const bool in = s0 + u * wk < steps && col < cw;
      a[u] = in && ok0 ? ld_stream(w0 + c0 + col) : make_uint4(0u, 0u, 0u, 0u);
      b[u] = in && ok1 ? ld_stream(w1 + c0 + col) : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  float c[4] = {0.f, 0.f, 0.f, 0.f};
  const int n_chunks = (din + kTcCols - 1) / kTcCols;
  uint4 wa[kU], wb[kU], na[kU], nb[kU];
  load(0, kk, wa, wb);  // the first weights fly while x is staged
  stage_x(xs, x, B, din, 0, min(kTcCols, din), kTcRow);
  cp_async_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * kTcCols, cw = min(kTcCols, din - c0);
    if (ch + 1 < n_chunks)
      stage_x(xs + ((ch + 1) & 1) * NB * kTcRow, x, B, din, c0 + kTcCols,
              min(kTcCols, din - c0 - kTcCols), kTcRow);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // chunk ch is in shared memory for every warp
    const __nv_bfloat16* xr = xs + (ch & 1) * NB * kTcRow + g * kTcRow;
    const int steps = (cw + 63) / 64;
    for (int s0 = kk; s0 < steps; s0 += wk * kU) {
      // the next batch of weights, in this chunk or the next, flies during this one
      const bool same = s0 + wk * kU < steps;
      if (same || ch + 1 < n_chunks) load(same ? ch : ch + 1, same ? s0 + wk * kU : kk, na, nb);
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (s0 + u * wk >= steps) break;  // the same for the whole warp
        const int col = (s0 + u * wk) * 64 + 16 * t;
        uint4 x0 = make_uint4(0u, 0u, 0u, 0u), x1 = x0;
        if (has_tok && col < cw) {
          x0 = *reinterpret_cast<const uint4*>(xr + col);
          x1 = *reinterpret_cast<const uint4*>(xr + col + 8);
        }
        const unsigned int xw[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        const unsigned int ww0[4] = {wa[u].x, wa[u].y, wa[u].z, wa[u].w};
        const unsigned int ww1[4] = {wb[u].x, wb[u].y, wb[u].z, wb[u].w};
#pragma unroll
        for (int s = 0; s < 4; ++s) {  // k16 product s: columns 16t + 4s .. 16t + 4s + 3
          unsigned int a_lo0, a_hi0, a_lo1, a_hi1;
          i8x4_to_bf16x2(ww0[s], a_lo0, a_hi0);
          i8x4_to_bf16x2(ww1[s], a_lo1, a_hi1);
          mma_bf16(c, a_lo0, a_lo1, a_hi0, a_hi1, xw[2 * s], xw[2 * s + 1]);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        wa[u] = na[u];
        wb[u] = nb[u];
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is restaged
  }

  // c: rows g and g + 8 of the tile, tokens 2t and 2t + 1
  float* r = red + warp * 128;
  r[g * 8 + 2 * t] = c[0];
  r[g * 8 + 2 * t + 1] = c[1];
  r[(g + 8) * 8 + 2 * t] = c[2];
  r[(g + 8) * 8 + 2 * t + 1] = c[3];
  __syncthreads();
  const int rows = row_tiles * 16;
  for (int e = tid; e < B * rows; e += kThreads) {
    const int n = e / rows, i = e % rows, ti = i / 16, ri = i % 16;
    const int row = blockIdx.x * rows + i;
    if (row < dout) {
      float sum = red[(ti * wk) * 128 + ri * 8 + n];
      for (int k = 1; k < wk; ++k) sum += red[(ti * wk + k) * 128 + ri * 8 + n];
      y[(size_t)n * dout + row] = __float2bfloat16(sum * scale[row]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 x on CUDA-core FMAs
// ---------------------------------------------------------------------------
constexpr int kF32Cols = kChunkBytes / 4;  // fp32 x: columns a chunk
constexpr int kF32Row = kF32Cols + 4;

template <int NB>
constexpr size_t f32_smem() {
  return sizeof(float) * 2 * NB * kF32Row;
}

template <int NB>
__global__ void __launch_bounds__(kThreads)
int8_matvec_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ scale, float* __restrict__ y, int B, int din,
                       int dout) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // 2 x NB x kF32Row
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int8_t* wr = w + (size_t)min(row, dout - 1) * din;

  float acc[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.f;
  const int n_chunks = (din + kF32Cols - 1) / kF32Cols;
  stage_x(xs, x, B, din, 0, min(kF32Cols, din), kF32Row);
  cp_async_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * kF32Cols, cw = min(kF32Cols, din - c0);
    if (ch + 1 < n_chunks)
      stage_x(xs + ((ch + 1) & 1) * NB * kF32Row, x, B, din, c0 + kF32Cols,
              min(kF32Cols, din - c0 - kF32Cols), kF32Row);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* xb = xs + (ch & 1) * NB * kF32Row;
    if (row < dout) {
#pragma unroll 4
      for (int cc = lane; cc < cw / 16; cc += 32) {
        const uint4 pk = ld_stream(wr + c0 + 16 * cc);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          // the lane's 16 columns in 4 groups, taken in a rotated order so
          // that 8 neighbouring lanes read 8 distinct 16-byte banks of x
          const int rv = (v + (cc >> 1)) & 3;
          const unsigned int word = rv == 0 ? pk.x : rv == 1 ? pk.y : rv == 2 ? pk.z : pk.w;
          const float w0 = sbyte(word, 0), w1 = sbyte(word, 1), w2 = sbyte(word, 2),
                      w3 = sbyte(word, 3);
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            if (b < B) {
              const float4 f = *reinterpret_cast<const float4*>(xb + b * kF32Row + 16 * cc + 4 * rv);
              acc[b] = fmaf(f.w, w3, fmaf(f.z, w2, fmaf(f.y, w1, fmaf(f.x, w0, acc[b]))));
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
// rows that are not a whole number of 16-byte words: a byte at a time
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_matvec_bytes_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                         const float* __restrict__ scale, T* __restrict__ y, int B, int din,
                         int dout) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= dout) return;
  const int8_t* wr = w + (size_t)row * din;
  float acc[kMaxB];
#pragma unroll
  for (int b = 0; b < kMaxB; ++b) acc[b] = 0.f;
  for (int c = lane; c < din; c += 32) {
    const float wv = (float)wr[c];
#pragma unroll
    for (int b = 0; b < kMaxB; ++b)
      if (b < B) acc[b] = fmaf(to_f(x[(size_t)b * din + c]), wv, acc[b]);
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

template <int NB>
int launch_tc(const void* x, const void* w, const void* scale, void* y, int B, int din, int dout,
              int row_tiles, cudaStream_t s) {
  auto kern = int8_matvec_tc_kernel<NB>;
  static bool done[64] = {};
  const cudaError_t err = allow_smem(kern, (int)tc_smem<NB>(tc_cols<NB>() + 1), done);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (dout + 15) / 16;
  kern<<<(tiles + row_tiles - 1) / row_tiles, kThreads, tc_smem<NB>(din), s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), B, din, dout, row_tiles);
  return (int)cudaGetLastError();
}

template <int NB>
int launch_f32(const void* x, const void* w, const void* scale, void* y, int B, int din, int dout,
               cudaStream_t s) {
  auto kern = int8_matvec_f32_kernel<NB>;
  static bool done[64] = {};
  const cudaError_t err = allow_smem(kern, (int)f32_smem<NB>(), done);
  if (err != cudaSuccess) return (int)err;
  kern<<<(dout + kWarps - 1) / kWarps, kThreads, f32_smem<NB>(), s>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(y), B, din, dout);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, din) fp32 or bf16, contiguous; w (dout, din) int8, contiguous;
// scale (dout,) fp32; y (B, dout) in x's dtype.  1 <= B <= 8.  With din a
// multiple of 16, x and w must be 16-byte aligned (the wrapper checks).
// row_tiles (1, 2, 4 or 8): tiles of 16 rows a block of the bf16 kernel.
extern "C" int sm_int8_matvec(const void* x, const void* w, const void* scale, void* y, int B,
                              int din, int dout, int is_bf16, int row_tiles, void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  if (B < 1 || B > kMaxB || din < 1 || dout < 1 ||
      !(row_tiles == 1 || row_tiles == 2 || row_tiles == 4 || row_tiles == 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (din % 16) {
    const dim3 grid((dout + kWarps - 1) / kWarps), block(kThreads);
    if (is_bf16)
      int8_matvec_bytes_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
          static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), B, din, dout);
    else
      int8_matvec_bytes_kernel<float><<<grid, block, 0, s>>>(
          static_cast<const float*>(x), static_cast<const int8_t*>(w),
          static_cast<const float*>(scale), static_cast<float*>(y), B, din, dout);
    return (int)cudaGetLastError();
  }
  if (is_bf16) {
    if (B == 1) return launch_tc<1>(x, w, scale, y, B, din, dout, row_tiles, s);
    if (B == 2) return launch_tc<2>(x, w, scale, y, B, din, dout, row_tiles, s);
    if (B <= 4) return launch_tc<4>(x, w, scale, y, B, din, dout, row_tiles, s);
    return launch_tc<8>(x, w, scale, y, B, din, dout, row_tiles, s);
  }
  if (B == 1) return launch_f32<1>(x, w, scale, y, B, din, dout, s);
  if (B == 2) return launch_f32<2>(x, w, scale, y, B, din, dout, s);
  if (B <= 4) return launch_f32<4>(x, w, scale, y, B, din, dout, s);
  return launch_f32<8>(x, w, scale, y, B, din, dout, s);
}
