"""The flash backward's dK/dV kernel, bfloat16 on the tensor cores.

One launch: q, dO (B, S, H, D), k, v (B, S, Hkv, D), the forward's lse and
delta = rowsum(dO·O) (B, H, S) float32 → dK, dV (B, S, Hkv, D), the GQA
group summed inside.  Operations: recomputing Q·Kᵀ, then dO·Vᵀ, Pᵀ·dO
and dSᵀ·Q, each over the causal half, 2 per multiply-add.  Bytes: every
input read once, dK and dV written once in the inputs' dtype."""
NAME = "flash_bwd_dkv_tc_kernel"


def cost(b: int, s: int, h: int, hkv: int, d: int, causal: bool = True):
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * 2 * b * h * d * pairs
    nbytes = 2 * b * s * d * (2 * h + 2 * hkv) + 2 * 4 * b * h * s + 2 * 2 * b * s * hkv * d
    return flops, nbytes
