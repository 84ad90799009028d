// Grouped int4 GEMM over a MoE layer's experts: rows sorted by expert, each
// expert's rows against that expert's per-channel int4 bank, the nibbles
// widened to bf16 in registers and never written to device memory.
//
// Replaces no TPU kernel.  The JAX package keeps quantized expert banks
// dense on purpose (streammind_tpu/models/mistral.py, _moe_apply_dense:
// every expert over every token, each bank dequantized by XLA), because
// lax.ragged_dot takes no int4; its port did the same, dequantizing each
// 14336 x 4096 bank to fp32 and bf16 in device memory (about 1.3 GB of
// traffic a bank) and running every token through all E experts.  This
// kernel is the grouped form of that product for the port's MoE prefill
// (models/mistral.py::_moe_apply_grouped_int4).
//
// Two instantiations, one launch each a MoE layer:
//  * gate + up: a block reads the gate and the up bank for the same rows
//    and features and writes h = silu(g * s_g) * (u * s_u) in bf16, so the
//    (R, F) g and u never reach device memory;
//  * down: the epilogue multiplies by the feature's fp32 scale and the
//    row's fp32 routing weight and writes the row at its original (token,
//    slot) place, dst[row], of an (R, N) buffer.
//
// Bound on the H100: at a prefill's R = T * top_k rows an expert gets R / E
// rows on average, and each packed weight byte (two weights) serves all of
// them: 4 R / E operations a byte.  Below ~74 rows an expert (the card's
// ~295 bf16 operations a byte) the bank bytes bound it, read once (22.6 GB
// over Mixtral's 32 layers, ~6.7 ms); above, the operations.
//
// Design:
//  * A and B swapped: the weight tile is wgmma's A operand (64 features x
//    16 deep a warpgroup), widened from nibbles to bf16 in registers
//    exactly (int4_nibbles.cuh); the expert's rows are B, K-major in shared
//    memory (the 128-byte swizzle of hopper_attention.cuh), 64 of them a
//    tile.
//  * A stage is 64 packed columns: the weight tile's 128 rows x 64 bytes
//    (16-byte chunks swizzled by (row >> 1) & 3, so the reads below hit 16
//    distinct banks) and the rows' two 64-column panels that the
//    column-halved pack pairs (input columns c.. and K/2 + c..), staged by
//    16-byte cp.async, each thread's addresses computed once, into a ring
//    of 4 stages (96 KB).
//  * Two blocks an SM (at most 128 registers a thread): a block's fixed
//    cost (finding its tile, filling the ring, the epilogue; ~8 us, measured
//    on an H100 with one block an SM) overlaps the other block's stages.
//    Tiles of 128 rows at one block an SM measured slower at every prefill
//    shape (Mixtral's and Jamba's, T 64-1024).
//  * The k order is the wgmma fragment's own: lane (g, t) needs bytes
//    2t, 2t+1, 2t+8, 2t+9 of each 16-byte chunk of its rows g and g + 8;
//    two 32-bit shared loads and one byte permute give them, and one word
//    widens to the low-nibble operand of a 16-deep slice of the first panel
//    and the high-nibble operand of the same slice of the second.
//  * Per stage each warpgroup issues 8 wgmma (m64n64k16, fp32
//    accumulators); the next stage's weights are widened into the other
//    register set while they run, and wgmma.wait_group 1 frees a stage's
//    slot and registers one stage later.
//  * Two warpgroups a block: features f..f+63 of the gate bank and of the
//    up bank (gate + up), or 128 features (down).  The per-feature scales
//    are read before the main loop, the down form's routing weights and
//    destinations copied into shared memory with the first stage.  The
//    epilogue stages the scaled sums in shared memory as fp32 rows; every
//    thread then forms 8 features of a row (SiLU and the up product, or the
//    routing weight) and stores them as 16 bytes.
//  * Work items are (expert, row tile, feature tile): blockIdx.x walks the
//    row tiles of expert 0, then 1, ... (found from the offsets on the
//    card), blockIdx.y the feature tiles.  The host sizes x as
//    (R + 63 E) / 64, a bound from shapes alone; a block past the
//    last row tile exits.  Neighbouring blocks share a feature tile, so an
//    expert's weight tile is read from device memory once for all its row
//    tiles.
//  * No split over K: each output is summed by one block, in one order, so
//    two calls give the same bits.
//
// Arithmetic: every product of a weight (exact in bf16) and a bf16 row
// value is exact in fp32, the sums are fp32, the scale (and the routing
// weight) fp32; h and y are rounded to bf16 once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_attention.cuh"
#include "int4_nibbles.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;             // two warpgroups
constexpr int kBN = 64;                   // rows a tile: wgmma's N
constexpr int kWRows = 128;               // weight rows a block: 64 of each bank, or 128
constexpr int kBK = 64;                   // packed columns a stage: input columns c.., K/2 + c..
constexpr int kStages = 4;
constexpr int kX = 2 * kBN * 128;         // the rows' two 64-column panels
constexpr int kW = kWRows * kBK;          // the weight tile
constexpr int kStage = kX + kW;           // a multiple of 1024
constexpr int kRing = kStages * kStage;
constexpr int kSmem = kRing + kBN * 12 + 1024;  // + the down form's row weights and destinations,
                                                 // + alignment slack

// d (64 x 64 fp32) += A (64 x 16, bf16 in registers) B (16 x 64), B K-major in shared memory
__device__ __forceinline__ void wgmma_rs_k(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// wait until at most N committed wgmma groups of this warp are still running
template <int N>
__device__ __forceinline__ void wgmma_wait_n() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// 8 bytes global -> shared, asynchronous; zero-filled when !valid
__device__ __forceinline__ void cp_async_8(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 8 : 0) : "memory");
}

template <bool kGateUp>
__global__ void __launch_bounds__(kThreads, 2)
int4_grouped_gemm_kernel(const bf16* __restrict__ x, const int* __restrict__ offsets,
                         const int8_t* __restrict__ w, const float* __restrict__ scale,
                         const int8_t* __restrict__ w2, const float* __restrict__ scale2,
                         const long long* __restrict__ dst, const float* __restrict__ row_weight,
                         bf16* __restrict__ out, int E, int K, int N) {
  using namespace hopper;
  constexpr int S = kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - smem_addr(smem_raw));

  // the block's (expert, row tile): blockIdx.x counts expert 0's row tiles,
  // then 1's, ...; the offsets read 8 experts at a time, the loads at once
  int e = -1, row0 = 0, rows = 0;
  for (int j0 = 0, i = blockIdx.x; j0 < E && e < 0; j0 += 8) {
    int o[9];
#pragma unroll
    for (int q = 0; q < 9; ++q) o[q] = __ldg(offsets + min(j0 + q, E));
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int tiles = j0 + q < E ? (o[q + 1] - o[q] + kBN - 1) / kBN : 0;
      if (e < 0 && i < tiles) {
        e = j0 + q;
        row0 = o[q] + i * kBN;
        rows = min(kBN, o[q + 1] - row0);
      }
      if (e < 0) i -= tiles;
    }
  }
  if (e < 0) return;

  const int Kh = K / 2, n_st = Kh / kBK;
  const int f0 = blockIdx.y * (kGateUp ? 64 : 128);  // the tile's first output feature
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, gid = lane >> 2, t = lane & 3;
  const int wrow = wg * 64 + warp * 16 + gid;  // this thread's weight rows: wrow, wrow + 8

  // the scales of this thread's two weight rows, read now: the epilogue needs them
  const int fs = f0 + (kGateUp ? (wrow & 63) : wrow);
  const float* sc = (kGateUp && wg ? scale2 : scale) + (size_t)e * N;
  const float s0 = __ldg(sc + min(fs, N - 1)), s1 = __ldg(sc + min(fs + 8, N - 1));

  // stage st (packed columns 64 st ..) into ring slot `slot`: the rows past
  // the expert's and the features past N zero-filled, not read.  A thread's
  // share is the same at every stage but for the column: x chunk tid % 16
  // (of the two panels' 16) of rows tid / 16 + 16 j, weight chunk tid % 4 of
  // rows tid / 4 and tid / 4 + 64 (the up bank's row, or 64 features on)
  constexpr int kXPer = kBN * 16 / kThreads;
  const int xr = tid >> 4, xc = tid & 15;
  const bf16* xg = x + (size_t)(row0 + xr) * K + (xc < 8 ? 0 : Kh) + 8 * (xc & 7);
  const size_t xstep = (size_t)16 * K;
  const uint32_t xo = tile_offset(xr, xc, kBN);  // + 2048 j for row xr + 16 j
  unsigned int xok = 0;
#pragma unroll
  for (int j = 0; j < kXPer; ++j) xok |= (xr + 16 * j < rows ? 1u : 0u) << j;
  const int wr = tid >> 2, wc = tid & 3;
  const uint32_t wo = wr * kBK + ((wc ^ ((wr >> 1) & 3)) << 4);  // + 4096 for row wr + 64
  const int fa = f0 + wr, fb = f0 + (kGateUp ? wr : wr + 64);
  const int8_t* wa = w + ((size_t)e * N + min(fa, N - 1)) * Kh + 16 * wc;
  const int8_t* wb = (kGateUp ? w2 : w) + ((size_t)e * N + min(fb, N - 1)) * Kh + 16 * wc;
  auto load = [&](int st, int slot) {
    const uint32_t xs = base + slot * kStage, ws = xs + kX;
    const int c0 = st * kBK;
#pragma unroll
    for (int j = 0; j < kXPer; ++j) {
      const bool ok = (xok >> j) & 1u;
      cp_async_16(xs + xo + 2048 * j, ok ? xg + j * xstep + c0 : x, ok);
    }
    cp_async_16(ws + wo, wa + c0, fa < N);
    cp_async_16(ws + wo + 4096, wb + c0, fb < N);
  };

  const unsigned int pick = (t & 1) ? 0x7632u : 0x5410u;

  // a stage's weights as the A operands of its 8 slices: slice kk < 4 the
  // low nibbles against the first panel's columns 16 kk.., slice 4 + kk the
  // high nibbles against the second panel's
  auto widen = [&](int slot, uint32_t (&af)[8][4]) {
    const uint8_t* wt = sm + slot * kStage + kX;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t word[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wrow + 8 * h;
        const uint8_t* chunk = wt + r * kBK + ((kk ^ ((r >> 1) & 3)) << 4) + 4 * (t >> 1);
        word[h] = __byte_perm(*reinterpret_cast<const uint32_t*>(chunk),
                              *reinterpret_cast<const uint32_t*>(chunk + 8), pick);
      }
      uint32_t lo0[2], hi0[2], lo1[2], hi1[2];
      nib8_to_bf16x2(word[0], lo0, hi0);
      nib8_to_bf16x2(word[1], lo1, hi1);
      af[kk][0] = lo0[0];
      af[kk][1] = lo1[0];
      af[kk][2] = lo0[1];
      af[kk][3] = lo1[1];
      af[4 + kk][0] = hi0[0];
      af[4 + kk][1] = hi1[0];
      af[4 + kk][2] = hi0[1];
      af[4 + kk][3] = hi1[1];
    }
  };

  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
  uint32_t a0[8][4], a1[8][4];

  // the down form's routing weights and destinations, with the first stage
  if constexpr (!kGateUp) {
    if (tid < kBN) {
      const bool ok = tid < rows;
      cp_async_4(base + kRing + 4 * tid, ok ? row_weight + row0 + tid : row_weight, ok);
      cp_async_8(base + kRing + kBN * 4 + 8 * tid, ok ? dst + row0 + tid : dst, ok);
    }
  }
  // the ring: stage st in slot st % S, S - 1 stages ahead, one commit group a stage
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < n_st) load(st, st);
    cp_async_commit();
  }
  cp_async_wait<S - 2>();
  fence_async_shared();
  __syncthreads();
  widen(0, a0);

  auto step = [&](int st, uint32_t (&cur)[8][4], uint32_t (&nxt)[8][4]) {
    const uint32_t xt = base + (st % S) * kStage;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_rs_k(acc, cur[kk], desc(xt + (kk >> 2) * kBN * 128 + (kk & 3) * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait_n<1>();  // stage st - 1 is done: its slot and its registers (nxt) are free
    __syncthreads();
    if (st + S - 1 < n_st) load(st + S - 1, (st + S - 1) % S);
    cp_async_commit();
    if (st + 1 < n_st) {
      cp_async_wait<S - 2>();
      fence_async_shared();
      __syncthreads();
      widen((st + 1) % S, nxt);
    }
  };
  for (int st = 0; st < n_st; st += 2) {
    step(st, a0, a1);
    if (st + 1 < n_st) step(st + 1, a1, a0);
  }
  wgmma_wait_n<0>();
  fence_regs(acc);
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the epilogue

  // the scaled sums as fp32 rows in shared memory: accumulator d[4j + q] is
  // weight row wrow + 8 (q >> 1), tile row 8j + 2t + (q & 1); the padded row
  // lengths (68, 132) put a store's 32 lanes on 32 banks
  float* ys = reinterpret_cast<float*>(sm);
  constexpr int kLd = kGateUp ? 68 : 132;
  float* mine = kGateUp ? ys + wg * kBN * kLd : ys;  // gate + up: g, then u
  const int fr = kGateUp ? warp * 16 + gid : wrow;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      mine[(8 * j + 2 * t + (q & 1)) * kLd + fr + 8 * (q >> 1)] = acc[4 * j + q] * (q < 2 ? s0 : s1);
  __syncthreads();

  // each thread forms 8 features of a row at a time and stores them as 16 bytes
  constexpr int kChunks = kGateUp ? 8 : 16;  // 8-feature chunks a row
  for (int i = tid; i < kBN * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    if (r >= rows || f0 + 8 * c >= N) continue;
    const float* y = ys + r * kLd + 8 * c;
    uint32_t packed[4];
    size_t at;
    if constexpr (kGateUp) {
      const float* u = y + kBN * kLd;
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2) {
        const float g0 = y[2 * k2], g1 = y[2 * k2 + 1];
        packed[k2] = pack_bf16(g0 / (1.f + __expf(-g0)) * u[2 * k2],
                               g1 / (1.f + __expf(-g1)) * u[2 * k2 + 1]);
      }
      at = (size_t)(row0 + r) * N;
    } else {
      const float rw = reinterpret_cast<const float*>(sm + kRing)[r];
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2) packed[k2] = pack_bf16(y[2 * k2] * rw, y[2 * k2 + 1] * rw);
      at = (size_t)reinterpret_cast<const long long*>(sm + kRing + kBN * 4)[r] * N;
    }
    *reinterpret_cast<uint4*>(out + at + f0 + 8 * c) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

template <bool kGateUp>
int launch(const void* x, const void* offsets, const void* w, const void* scale, const void* w2,
           const void* scale2, const void* dst, const void* row_weight, void* out, int R, int E,
           int K, int N, cudaStream_t s) {
  auto kern = int4_grouped_gemm_kernel<kGateUp>;
  // raise the kernel's dynamic shared memory limit once a device: the call
  // costs microseconds of host time
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && !(dev < 64 && done[dev])) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err == cudaSuccess && dev < 64) done[dev] = true;
  }
  if (err != cudaSuccess) return (int)err;
  const long long tiles = ((long long)R + (long long)E * (kBN - 1)) / kBN;
  const int feat = kGateUp ? 64 : 128;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (N + feat - 1) / feat);
  kern<<<grid, kThreads, kSmem, s>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(offsets),
      static_cast<const int8_t*>(w), static_cast<const float*>(scale),
      static_cast<const int8_t*>(w2), static_cast<const float*>(scale2),
      static_cast<const long long*>(dst), static_cast<const float*>(row_weight),
      static_cast<bf16*>(out), E, K, N);
  return (int)cudaGetLastError();
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x (R, K) bf16, rows sorted by expert, contiguous; offsets (E + 1,) int32
// on the device, offsets[e] the first row of expert e, offsets[E] = R; w
// (E, N, K/2) int8 in the column-halved pack, scale (E, N) fp32; out (R, N)
// bf16.  K a multiple of 128, N of 64; x, w, w2 and out 16-byte aligned.
// gate + up (w2, scale2 the up bank, dst and row_weight null): out[r] =
// silu(x[r] W_e^T * s_e) * (x[r] W2_e^T * s2_e).
// down (dst (R,) int64, a permutation of 0..R-1, and row_weight (R,) fp32;
// w2 and scale2 null): out[dst[r]] = (x[r] W_e^T * s_e) * row_weight[r].
extern "C" int sm_int4_grouped_gemm(const void* x, const void* offsets, const void* w,
                                    const void* scale, const void* w2, const void* scale2,
                                    const void* dst, const void* row_weight, void* out, int R,
                                    int E, int K, int N, void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  const bool gate_up = w2 != nullptr && scale2 != nullptr && !dst && !row_weight;
  const bool down = w2 == nullptr && scale2 == nullptr && dst && row_weight;
  if (R < 1 || E < 1 || K < 128 || K % 128 || N < 64 || N % 64 || gate_up == down ||
      !aligned(x) || !aligned(w) || !aligned(out) || (gate_up && !aligned(w2)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (gate_up) return launch<true>(x, offsets, w, scale, w2, scale2, dst, row_weight, out, R, E, K, N, s);
  return launch<false>(x, offsets, w, scale, w2, scale2, dst, row_weight, out, R, E, K, N, s);
}
