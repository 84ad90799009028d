"""The int4 matvec kernel (per-channel int4 weights, bfloat16 x).

One launch: x (B, in) · Wᵀ with W (out, in) packed two codes a byte and a
float32 scale an output row.  Operations: 2 per multiply-add.  Bytes: the
codes (out·in/2) and the scales read once, x read, y written (bfloat16)."""
NAME = "int4_matvec_tc_kernel"


def cost(b: int, out: int, inp: int):
    return 2 * b * out * inp, out * inp // 2 + 4 * out + 2 * b * inp + 2 * b * out
