// One-token K/V write into the paged KV pool, in place.
//
// Replaces the JAX package's streaming/paged.py::_token_write_kernel
// (entry _write_tokens_dma), which every decode step calls once per
// decoder layer: row i's new (Hkv, D) k and v token goes to pool page
// page_idx[i], offset offset[i], for every kv head.
//
// Bound on the H100: bytes, and tiny ones — K rows x Hkv x D x 2 (k, v)
// elements read once and written once (32 KB at K 4, 7B shapes), so a
// launch costs its launch latency.  The TPU kernel round-tripped the
// enclosing 8-row tile through VMEM because HBM there is (8, 128)-tiled;
// device memory here takes 16-byte stores at any row, so each head row is
// copied directly as 16-byte words and nothing else of the page is
// touched.  Page and offset are read on the device (no host sync).
//
// Design: one block of 128 threads per row; its threads stride over the
// row's 2 x Hkv x (D * elem / 16) words.  A row whose page or offset lies
// outside the pool is skipped, so the kernel never writes outside the
// pool (the caller routes out-of-table rows to sink page 0 before this;
// finished rows may share a sink slot, where their words race and mix,
// and nothing reads it).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
paged_write_kernel(uint4* __restrict__ pool_k, uint4* __restrict__ pool_v,
                   const uint4* __restrict__ k_tok, const uint4* __restrict__ v_tok,
                   const int* __restrict__ page_idx, const int* __restrict__ offset,
                   int Hkv, int P, int page, int row_words) {
  const int i = blockIdx.x;
  const int pg = page_idx[i], off = offset[i];
  if (pg < 0 || pg >= P || off < 0 || off >= page) return;
  const int n = Hkv * row_words;
  for (int e = threadIdx.x; e < 2 * n; e += kThreads) {
    const int side = e / n, r = e % n, h = r / row_words, w = r % row_words;
    const long long dst = (((long long)h * P + pg) * page + off) * row_words + w;
    const long long src = ((long long)i * Hkv + h) * row_words + w;
    if (side == 0)
      pool_k[dst] = k_tok[src];
    else
      pool_v[dst] = v_tok[src];
  }
}

}  // namespace

// pool_k/pool_v (Hkv, P, page, D) contiguous; k_tok/v_tok (K, Hkv, D)
// contiguous in the pool's dtype; page_idx/offset (K,) int32 on the
// device.  row_bytes = D x element size, a multiple of 16; all four data
// pointers 16-byte aligned.
extern "C" int sm_paged_write(void* pool_k, void* pool_v, const void* k_tok, const void* v_tok,
                              const void* page_idx, const void* offset, int K, int Hkv, int P,
                              int page, int row_bytes, void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  if (K < 1 || Hkv < 1 || P < 1 || page < 1 || row_bytes < 16 || row_bytes % 16)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {(const void*)pool_k, (const void*)pool_v, k_tok, v_tok})
    if (reinterpret_cast<unsigned long long>(p) % 16) return (int)cudaErrorMisalignedAddress;
  paged_write_kernel<<<K, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(pool_k), static_cast<uint4*>(pool_v),
      static_cast<const uint4*>(k_tok), static_cast<const uint4*>(v_tok),
      static_cast<const int*>(page_idx), static_cast<const int*>(offset), Hkv, P, page,
      row_bytes / 16);
  return (int)cudaGetLastError();
}
