"""Fused int4 weight-only matvec for the gate tier (kernel ``csrc/int4_matvec.cu``).

``y = x @ unpack(packed).T * scale`` for the small-batch (≤ 8 tokens)
regime, where the gate LM is pure weight bandwidth: the kernel reads the
packed int4 bytes once and widens the nibbles in registers right before
the products: for bf16 x on the tensor cores (the nibbles as bf16,
exactly), for fp32 x on CUDA-core FMAs; x is staged once a block in shared
memory.  Pack layout (``utils/quantize.py``): column-halved — low nibbles
hold input columns [0, in/2), high nibbles [in/2, in) — sign-extended, one
fp32 scale per output row.

Numerics: x is taken at its own precision, every product is exact in fp32,
the sum is fp32 (in another order than the plain version's), the row's
fp32 scale multiplies the sum, and the result is rounded once to x's dtype.

``int4_matvec`` takes ``int4_matvec_ref`` only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.  ``int4_matvec.launches``
counts its launches.
"""
from __future__ import annotations

import functools

import torch

from . import _build

MAX_TOKENS = 8


@functools.lru_cache(maxsize=None)
def _grid(b: int, dout: int, sms: int):
    """The bf16 kernel's grid, from shapes alone: (tiles_a_warp,
    row_tiles), tiles of 16 rows a warp and a block.  Two tiles a warp from
    B 3 where there is at least a tile for every SM (they share each x
    fragment); then the most row tiles a block, up to 8 warps' worth, that
    leave at least ``sms`` blocks (B <= 2) or 4/5 of that (B >= 3, where a
    block's rows share more x).  Chosen by sweeps on an H100 at the gate's
    four linears, B 1, 4 and 8 (``tools/_probe_decode_kernels.py``,
    PERF.md)."""
    tiles = -(-dout // 16)
    tw = 2 if b > 2 and tiles >= sms else 1
    floor, rt = (sms if b <= 2 else 4 * sms // 5), tw
    while rt < 8 * tw and -(-tiles // (2 * rt)) >= floor:
        rt *= 2
    return tw, rt


def int4_matvec_ref(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version: unpack the two nibble halves, two half-dots in fp32
    with x taken in fp32, scale per output row, write in x's dtype."""
    lo = ((packed << 4) >> 4).float()
    hi = (packed >> 4).float()
    half = x.shape[1] // 2
    x32 = x.float()
    acc = x32[:, :half] @ lo.T + x32[:, half:] @ hi.T
    return (acc * scale.float()[None, :]).to(x.dtype)


def int4_matvec(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (B, in) fp32/bf16 with B ≤ 8; packed (out, in/2) int8; scale (out,)
    fp32.  Returns (B, out) in x's dtype."""
    if x.device.type == "cpu":
        return int4_matvec_ref(x, packed, scale)
    if not x.is_cuda:
        raise ValueError(f"int4_matvec: no kernel for device {x.device}")
    if not (packed.device == x.device and scale.device == x.device):
        raise ValueError("int4_matvec: x, packed and scale must lie on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int4_matvec: x dtype {x.dtype} not supported (fp32, bf16)")
    if packed.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError("int4_matvec: packed must be int8 and scale fp32")
    if x.dim() != 2 or packed.dim() != 2 or scale.dim() != 1:
        raise ValueError("int4_matvec: x (B, in), packed (out, in/2), scale (out,)")
    b, din = x.shape
    dout = packed.shape[0]
    if not 1 <= b <= MAX_TOKENS:
        raise ValueError(f"int4_matvec: {b} rows, the kernel takes 1..{MAX_TOKENS}")
    if din % 2 or packed.shape[1] * 2 != din or scale.shape[0] != dout:
        raise ValueError(f"int4_matvec: x {tuple(x.shape)}, packed {tuple(packed.shape)}, "
                         f"scale {tuple(scale.shape)} do not agree")
    if not (x.is_contiguous() and packed.is_contiguous() and scale.is_contiguous()):
        raise ValueError("int4_matvec: x, packed and scale must be contiguous")
    if (din // 2) % 16 == 0 and (x.data_ptr() % 16 or packed.data_ptr() % 16):
        # the 16-byte-load path of the kernel (packed rows of 16k bytes)
        raise ValueError("int4_matvec: x and packed must be 16-byte aligned")
    y = torch.empty((b, dout), dtype=x.dtype, device=x.device)
    err = _build.kernel("int4_matvec")(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), y.data_ptr(),
        b, din, dout, int(x.dtype == torch.bfloat16), *_grid(b, dout, _build.sm_count(x.device)),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "int4_matvec")
    int4_matvec.launches += 1
    return y


int4_matvec.launches = 0
