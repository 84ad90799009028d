"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit): the yardstick of every roofline share."""
BF16_FLOPS = 989e12          # tensor cores, bfloat16
FP32_FLOPS = 67e12           # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, peak_flops: float = BF16_FLOPS):
    """(least seconds the chip could take, which bound sets it)."""
    t_ops, t_bytes = flops / peak_flops, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
