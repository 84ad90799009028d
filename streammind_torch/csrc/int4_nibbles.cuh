// Widening the repository's packed int4 weights (utils/quantize.py: one byte
// holds two sign-extended nibbles) to bf16 in registers, exactly; shared by
// int4_matvec.cu and int4_grouped_gemm.cu.
#pragma once

#include <cuda_bf16.h>

// the eight nibbles of four packed bytes → bf16x2 of the low nibbles of
// bytes (0, 1) and (2, 3) and of the high nibbles of bytes (0, 1) and (2, 3),
// exactly: each byte of lo / hi is n ^ 8 (0..15), put under 0x43 it is the
// bf16 128 + (n ^ 8), and 136 off that is n
__device__ __forceinline__ void nib8_to_bf16x2(unsigned int word, unsigned int* lo2,
                                               unsigned int* hi2) {
  const unsigned int lo = (word & 0x0F0F0F0Fu) ^ 0x08080808u;
  const unsigned int hi = ((word >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
  const __nv_bfloat162 off = __floats2bfloat162_rn(136.f, 136.f);
  const unsigned int v[4] = {
      __byte_perm(lo, 0x43434343u, 0x4140), __byte_perm(lo, 0x43434343u, 0x4342),
      __byte_perm(hi, 0x43434343u, 0x4140), __byte_perm(hi, 0x43434343u, 0x4342)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v[i]), off);
    (i < 2 ? lo2 : hi2)[i & 1] = *reinterpret_cast<const unsigned int*>(&d);
  }
}
