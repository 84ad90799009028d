"""Grouped int4 GEMM of a MoE layer's experts (kernel ``csrc/int4_grouped_gemm.cu``).

Rows sorted stably by expert id, expert e's rows ``xs[offsets[e]:offsets[e+1]]``
against expert e's slice of a whole per-channel int4 bank (E, N, K/2) in the
repository's column-halved pack (``utils/quantize.py``: the low nibble of
byte j is input column j, the high nibble column K/2 + j) and its fp32
scales (E, N).  Two forms, one launch each a MoE layer:

  - gate + up (``up=(w_up, scale_up)``): ``silu(xs W_e^T s_e) * (xs U_e^T
    u_e)``, the (R, N) product of a SwiGLU's two banks;
  - down (``dst``, ``row_weight``): ``(xs W_e^T s_e) * row_weight``, row r
    written at row ``dst[r]`` of the output (the rows' original order).

The kernel widens the nibbles to bf16 in registers and never writes a
dequantized weight to device memory; the offsets stay on the card, so
nothing of a MoE's routing is read on the host.  Numerics: every product
exact in fp32, fp32 sums, the scale and the routing weight in fp32, the
result rounded once to bf16.

``int4_grouped_gemm`` takes ``int4_grouped_gemm_ref`` only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.
``int4_grouped_gemm.launches`` counts its launches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build


def fits(k: int, n: int) -> bool:
    """Whether the kernel takes a bank of n outputs over k inputs: k a
    multiple of 128 (whole stages of 64 packed columns), n of 64."""
    return k % 128 == 0 and n % 64 == 0


def _unpack(w: torch.Tensor) -> torch.Tensor:
    """(N, K/2) int8 in the column-halved pack → (N, K) fp32 integers."""
    return torch.cat([(w << 4) >> 4, w >> 4], dim=-1).float()


def int4_grouped_gemm_ref(xs: torch.Tensor, offsets: torch.Tensor, w: torch.Tensor,
                          scale: torch.Tensor, up: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                          dst: Optional[torch.Tensor] = None,
                          row_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: each expert's rows in fp32 against its nibbles in
    fp32, fp32 sums, the scale (then SiLU and the up product, or the
    routing weight and the scatter to ``dst``), one rounding to xs's dtype."""
    bounds = offsets.tolist()
    x32 = xs.float()
    parts = []
    for e in range(len(bounds) - 1):
        rows = x32[bounds[e]:bounds[e + 1]]
        y = (rows @ _unpack(w[e]).T) * scale[e].float()
        if up is not None:
            y = F.silu(y) * ((rows @ _unpack(up[0][e]).T) * up[1][e].float())
        parts.append(y)
    y = torch.cat(parts)
    if dst is not None:
        out = torch.empty_like(y)
        out[dst] = y * row_weight.float()[:, None]
        y = out
    return y.to(xs.dtype)


def int4_grouped_gemm(xs: torch.Tensor, offsets: torch.Tensor, w: torch.Tensor,
                      scale: torch.Tensor, up: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      dst: Optional[torch.Tensor] = None,
                      row_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """xs (R, K) rows sorted by expert; offsets (E + 1,) int32, expert e's
    rows ``offsets[e]:offsets[e+1]`` (``offsets[E]`` = R); w (E, N, K/2)
    int8; scale (E, N) fp32.  Gate + up with ``up`` = (w_up, scale_up) of
    the same shapes; down with ``dst`` (R,) int64, a permutation of 0..R-1,
    and ``row_weight`` (R,) fp32.  Returns (R, N) in xs's dtype.  On the
    card xs must be bf16, every tensor contiguous, K a multiple of 128 and N
    of 64 (``fits``)."""
    if xs.dim() != 2 or w.dim() != 3 or scale.shape != w.shape[:2]:
        raise ValueError(f"int4_grouped_gemm: xs (R, K), w (E, N, K/2), scale (E, N), got "
                         f"{tuple(xs.shape)}, {tuple(w.shape)}, {tuple(scale.shape)}")
    R, K = xs.shape
    E, N = w.shape[:2]
    if w.shape[2] * 2 != K or offsets.shape != (E + 1,):
        raise ValueError(f"int4_grouped_gemm: xs {tuple(xs.shape)}, w {tuple(w.shape)}, "
                         f"offsets {tuple(offsets.shape)} do not agree")
    if (up is None) == (dst is None) or (dst is None) != (row_weight is None):
        raise ValueError("int4_grouped_gemm: give either up (gate + up) or dst and row_weight "
                         "(down)")
    if up is not None and (up[0].shape != w.shape or up[1].shape != scale.shape):
        raise ValueError("int4_grouped_gemm: the up bank must have the gate bank's shapes")
    if dst is not None and (dst.shape != (R,) or row_weight.shape != (R,)):
        raise ValueError(f"int4_grouped_gemm: dst and row_weight must be ({R},)")
    if xs.device.type == "cpu":
        return int4_grouped_gemm_ref(xs, offsets, w, scale, up, dst, row_weight)
    return _launch(xs, offsets, w, scale, up, dst, row_weight)


def _launch(xs, offsets, w, scale, up, dst, row_weight) -> torch.Tensor:
    """Check what only the kernel needs and launch it."""
    R, K = xs.shape
    E, N = w.shape[:2]
    tensors = [xs, offsets, w, scale, *(up or ()), *(t for t in (dst, row_weight) if t is not None)]
    if not xs.is_cuda:
        raise ValueError(f"int4_grouped_gemm: no kernel for device {xs.device}")
    if any(t.device != xs.device for t in tensors):
        raise ValueError("int4_grouped_gemm: every tensor must lie on xs's CUDA device")
    if xs.dtype != torch.bfloat16:
        raise ValueError(f"int4_grouped_gemm: xs dtype {xs.dtype}, the kernel takes bf16")
    if offsets.dtype != torch.int32 or any(t.dtype != torch.int8 for t in (w, *(up or ())[:1])) \
            or any(t.dtype != torch.float32 for t in (scale, *(up or ())[1:])):
        raise ValueError("int4_grouped_gemm: offsets int32, banks int8, scales fp32")
    if dst is not None and (dst.dtype != torch.int64 or row_weight.dtype != torch.float32):
        raise ValueError("int4_grouped_gemm: dst int64, row_weight fp32")
    if not fits(K, N) or R < 1:
        raise ValueError(f"int4_grouped_gemm: K {K} must be a multiple of 128 and N {N} of 64, "
                         f"with at least one row")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("int4_grouped_gemm: every tensor must be contiguous")
    if any(t.data_ptr() % 16 for t in (xs, w, *(up or ())[:1])):
        raise ValueError("int4_grouped_gemm: xs and the banks must be 16-byte aligned")
    out = torch.empty((R, N), dtype=torch.bfloat16, device=xs.device)
    err = _build.kernel("int4_grouped_gemm")(
        xs.data_ptr(), offsets.data_ptr(), w.data_ptr(), scale.data_ptr(),
        up[0].data_ptr() if up else None, up[1].data_ptr() if up else None,
        dst.data_ptr() if dst is not None else None,
        row_weight.data_ptr() if row_weight is not None else None,
        out.data_ptr(), R, E, K, N, torch.cuda.current_stream(xs.device).cuda_stream,
    )
    _build.check(err, "int4_grouped_gemm")
    int4_grouped_gemm.launches += 1
    return out


int4_grouped_gemm.launches = 0
