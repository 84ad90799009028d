"""Fused int8 weight-only matvec (kernel ``csrc/int8_matvec.cu``).

``y = x @ W_int8.T * scale`` for the few-token regime (≤ 8 tokens): the
int8 gate (``quantize_gate="int8"``) at one token a frame, and the int8
decoder (``quantize_text_params(bits=8)``) at one token a decode step.
Both are pure weight bandwidth, so the kernel reads each int8 weight byte
once and converts it in registers right before the products: for bf16 x on
the tensor cores (the weights as bf16, exactly), for fp32 x on CUDA-core
FMAs; x is staged once a block in shared memory.

Numerics: x is taken at its own precision (fp32 or bf16), every product is
exact in fp32, the sum is fp32 (in another order than the plain version's),
the row's fp32 scale multiplies the sum, and the result is rounded once to
x's dtype.

``int8_matvec`` takes ``int8_matvec_ref`` only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.  ``int8_matvec.launches``
counts its launches.
"""
from __future__ import annotations

import functools

import torch

from . import _build

MAX_TOKENS = 8


@functools.lru_cache(maxsize=None)
def _row_tiles(dout: int, device: torch.device) -> int:
    """Tiles of 16 rows a block of the bf16 kernel: the most, up to 8, that
    still give every SM a block; 1 for outputs too small for that (the
    block's 8 warps then split each tile's input columns).  Chosen by a
    sweep of 1, 2, 4 and 8 on an H100 (``tools/decode_kernels_bench.py
    --sweep``, PERF.md)."""
    tiles, rt = -(-dout // 16), 8
    while rt > 1 and -(-tiles // rt) < _build.sm_count(device):
        rt //= 2
    return rt


def int8_matvec_ref(x: torch.Tensor, w_int8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version: x in fp32 against the int8 weight in fp32, fp32 sums,
    the fp32 scale per output row, one rounding to x's dtype."""
    acc = x.float() @ w_int8.float().T
    return (acc * scale.float()[None, :]).to(x.dtype)


def int8_matvec(x: torch.Tensor, w_int8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (B, in) fp32/bf16 with B ≤ 8; w_int8 (out, in) int8; scale (out,)
    fp32.  Returns (B, out) in x's dtype."""
    if x.device.type == "cpu":
        return int8_matvec_ref(x, w_int8, scale)
    if not x.is_cuda:
        raise ValueError(f"int8_matvec: no kernel for device {x.device}")
    if not (w_int8.device == x.device and scale.device == x.device):
        raise ValueError("int8_matvec: x, w_int8 and scale must lie on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int8_matvec: x dtype {x.dtype} not supported (fp32, bf16)")
    if w_int8.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError("int8_matvec: w_int8 must be int8 and scale fp32")
    if x.dim() != 2 or w_int8.dim() != 2 or scale.dim() != 1:
        raise ValueError("int8_matvec: x (B, in), w_int8 (out, in), scale (out,)")
    b, din = x.shape
    dout = w_int8.shape[0]
    if not 1 <= b <= MAX_TOKENS:
        raise ValueError(f"int8_matvec: {b} rows, the kernel takes 1..{MAX_TOKENS}")
    if din < 1 or w_int8.shape[1] != din or scale.shape[0] != dout:
        raise ValueError(f"int8_matvec: x {tuple(x.shape)}, w_int8 {tuple(w_int8.shape)}, "
                         f"scale {tuple(scale.shape)} do not agree")
    if not (x.is_contiguous() and w_int8.is_contiguous() and scale.is_contiguous()):
        raise ValueError("int8_matvec: x, w_int8 and scale must be contiguous")
    if din % 16 == 0 and (x.data_ptr() % 16 or w_int8.data_ptr() % 16):
        # the 16-byte-load path of the kernel (rows of 16k bytes)
        raise ValueError("int8_matvec: x and w_int8 must be 16-byte aligned")
    y = torch.empty((b, dout), dtype=x.dtype, device=x.device)
    err = _build.kernel("int8_matvec")(
        x.data_ptr(), w_int8.data_ptr(), scale.data_ptr(), y.data_ptr(),
        b, din, dout, int(x.dtype == torch.bfloat16), _row_tiles(dout, x.device),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "int8_matvec")
    int8_matvec.launches += 1
    return y


int8_matvec.launches = 0
