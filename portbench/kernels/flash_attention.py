"""The flash (prefill) attention kernel, bfloat16 on the tensor cores.

One launch of a batched paged prefill: row r's ``bucket`` queries at
positions offset_r .. offset_r + bucket - 1 attend causally to the keys
before them (kv_len = offset_r + bucket).  Operations: Q·Kᵀ and P·V over
the keys each query sees, 2 per multiply-add.  Bytes: q read and o written
(H heads), k and v read up to kv_len (Hkv heads), 2 bytes an element."""
NAME = "flash_tc_kernel"


def cost(offsets, bucket: int, h: int, hkv: int, d: int):
    flops = nbytes = 0
    for off in offsets:
        keys_seen = bucket * off + bucket * (bucket + 1) // 2
        flops += 2 * 2 * h * d * keys_seen
        nbytes += 2 * (2 * bucket * h * d + 2 * (off + bucket) * hkv * d)
    return flops, nbytes
