"""The paged decode attention kernel (with the step's token write).

One launch of a lockstep step: each row's one query (H heads) attends to
its ``length`` keys in the page pool (the new token included); the new
token's k and v are written into the pool first.  Operations: q·Kᵀ and
P·V, 2 per multiply-add.  Bytes: the keys and values read once (Hkv
heads), q read, o written, the new k and v written, 2 bytes an element,
and each row's length and its page ids (4 bytes each) read."""
NAME = "paged_attention_kernel"


def cost(lengths, h: int, hkv: int, d: int, page: int):
    flops = sum(2 * 2 * h * d * n for n in lengths)
    nbytes = sum(2 * (2 * n * hkv * d + 2 * h * d + 2 * hkv * d) + 4 * (1 + -(-n // page))
                 for n in lengths)
    return flops, nbytes
