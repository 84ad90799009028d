"""The exact (ViT) attention kernel, bfloat16 on the tensor cores.

One launch: q, k, v (B, S, H, D) → o (B, S, H, D), every query against
every key.  Operations: Q·Kᵀ and P·V, 2 per multiply-add.  Bytes: q, k, v
read once and o written once, 2 bytes an element."""
NAME = "exact_tc_kernel"


def cost(b: int, s: int, h: int, d: int):
    flops = 2 * 2 * b * h * s * s * d
    nbytes = 2 * 4 * b * s * h * d
    return flops, nbytes
