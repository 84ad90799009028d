// Hopper building blocks of the tensor-core attention kernels
// (flash_attention.cu, exact_attention.cu, flash_bwd_dq.cu,
// flash_bwd_dkv.cu): 16-byte cp.async loads into
// 128-byte-swizzled shared-memory tiles, wgmma descriptors over those tiles,
// the three warpgroup products the kernels run, and quad reductions over
// the accumulator's rows.
//
// Tile layout.  A tile of R rows x D bf16 columns (D a multiple of 64) is
// D/64 panels of R rows x 128 bytes; in a panel, the 16-byte chunk c of row
// r sits at chunk position c ^ (r % 8).  That is the 128-byte swizzle of the
// wgmma canonical layouts (the layout TMA writes under
// CU_TENSOR_MAP_SWIZZLE_128B), so one layout serves both operand kinds:
//  * K-major (A = Q and B = K of S = Q K^T): a panel's rows are M or N and
//    its 64 columns are K; SBO = 1024 bytes (8 rows), LBO unused; the k-th
//    16-column step starts (k % 4) * 32 bytes into panel k / 4;
//  * MN-major (B = V of O = P V): a panel's rows are K (keys) and its 64
//    columns are N (head dim); SBO = 1024 bytes (8 keys), LBO = the panel
//    stride; the k-th 16-key step starts 16 * 128 bytes further on.
//    The backward kernels read K (dQ = dS K), Q and dO (dK = dS^T Q,
//    dV = P^T dO) the same way, from the tiles that served them as
//    K-major operands of S and dP.
// Panels start on 1024-byte boundaries (the swizzle repeats every 8 rows).
//
// Accumulator layout of m64nNk16 (fp32): thread t of the warpgroup holds
// rows 16 * (t / 32) + (t % 32) / 4 and that + 8; d[4j + e] is column
// 8j + 2 (t % 4) + (e & 1) of the first row (e < 2) or the second (e >= 2).
// A bf16 A operand in registers has the same row/column map per 16-column
// step, so P goes from the S accumulator to the PV product in registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <initializer_list>

namespace hopper {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// what the 16-byte loads need: every pointer 16-byte aligned, and every
// (batch, seq, head) stride st[0..n_st) a multiple of 8 elements
inline bool aligned16(std::initializer_list<const void*> ptrs, const long long* st, int n_st) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) & 15) return false;
  for (int i = 0; i < n_st; ++i)
    if (st[i] % 8) return false;
  return true;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `chunk` (of D / 8) of row r in a swizzled tile of `rows` rows
__device__ __forceinline__ uint32_t tile_offset(int r, int chunk, int rows) {
  return (uint32_t)((chunk >> 3) * rows * 128 + r * 128 + (((chunk & 7) ^ (r & 7)) << 4));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// 4 bytes global -> shared, asynchronous; zero-filled when !valid
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// this thread's completed shared-memory writes become visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand at shared address `addr`
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// barrier of one warpgroup's 128 threads (named barrier 1 + wg; 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses of the accumulators across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// P (64 x 64 keys, the S accumulator) as the bf16 A operand of four 16-key steps
__device__ __forceinline__ void p_fragments(const float (&s)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// d (64 x 64 fp32) = [d +] A (64 x 16) B (16 x 64), A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64 fp32) += A (64 x 16, bf16 in registers) B (16 x 64), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128 fp32) += A (64 x 16, bf16 in registers) B (16 x 128), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

}  // namespace hopper
