"""Selective-scan (Mamba-1 SSM) ops.

The per-frame step (``selective_state_update``, ``causal_conv1d_update``)
is a handful of elementwise ops, left to XLA in the JAX package and to
plain torch here.  The full-sequence scan has two implementations behind
``selective_scan(impl=...)``: ``selective_scan_ref``, the plain,
differentiable per-step loop, and ``selective_scan_kernel``, the
hand-written CUDA forward (``csrc/selective_scan.cu``) that the burst
catch-up runs.  ``causal_conv1d`` serves the full-sequence mixer.

Recurrence (per batch b, channel d, state n):
  dt'   = softplus(dt + dt_bias)           (when delta_softplus)
  h     = exp(dt' * A[d,n]) * h + dt' * u * B[n]
  y     = sum_n(h * C[n]) + D[d] * u
  out   = y * silu(z)                      (when z is given)

Shapes follow the JAX package: u, delta, z (B, D, L); A (D, N);
B, C (B, N, L); D, dt_bias (D,).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # log(1 + e^x) without torch's linear cut-over at 20, as jax.nn.softplus
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def selective_scan_ref(
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: Optional[torch.Tensor] = None,
    z: Optional[torch.Tensor] = None,
    delta_bias: Optional[torch.Tensor] = None,
    delta_softplus: bool = False,
    return_last_state: bool = False,
    h0: Optional[torch.Tensor] = None,
):
    """Sequential scan over time with an fp32 state."""
    dtype_in = u.dtype
    u32 = u.float()
    dt = delta.float()
    if delta_bias is not None:
        dt = dt + delta_bias.float()[None, :, None]
    if delta_softplus:
        dt = _softplus(dt)
    A32, B32, C32 = A.float(), B.float(), C.float()
    bsz, d_inner, seqlen = u32.shape
    h = (h0.float() if h0 is not None
         else torch.zeros(bsz, d_inner, A32.shape[1], device=u.device))
    ys = []
    for t in range(seqlen):
        dA = torch.exp(dt[:, :, t, None] * A32[None])                 # (B, D, N)
        dBu = (dt[:, :, t] * u32[:, :, t])[:, :, None] * B32[:, None, :, t]
        h = h * dA + dBu
        ys.append(torch.einsum("bdn,bn->bd", h, C32[:, :, t]))
    y = torch.stack(ys, dim=2)
    if D is not None:
        y = y + u32 * D.float()[None, :, None]
    if z is not None:
        y = y * F.silu(z.float())
    out = y.to(dtype_in)
    return (out, h) if return_last_state else out


_MAX_STATE = 16  # the kernel keeps N states a channel in registers


def selective_scan_kernel(
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: Optional[torch.Tensor] = None,
    z: Optional[torch.Tensor] = None,
    delta_bias: Optional[torch.Tensor] = None,
    delta_softplus: bool = False,
    return_last_state: bool = False,
    h0: Optional[torch.Tensor] = None,
):
    """The scan forward through the CUDA kernel (the JAX package's
    ``selective_scan_pallas``): same arguments and results as
    ``selective_scan_ref``, which it takes for tensors on the CPU.  It has
    no backward, as the Pallas kernel has none: it raises if an input
    requires grad while grad mode is on.

    u, delta, z (B, D, L) and B, C (B, N, L) share one dtype (fp32 or
    bf16) and are read through their strides as they lie (no copy);
    A (D, N), D, delta_bias (D,) and h0 (B, D, N) are taken in fp32 (the
    wrapper makes fp32 contiguous copies where they are not already).  y
    comes back as a (B, D, L) view of a (B, L, D) tensor, channels
    contiguous; the last state (B, D, N) fp32.  The kernel spreads each
    channel's states over 8 lanes and sums y over them in a fixed order,
    so two calls give the same bits.  ``selective_scan_kernel.launches``
    counts the launches."""
    args = (u, delta, A, B, C, D, z, delta_bias, h0)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args):
        raise RuntimeError("selective_scan(impl='pallas') has no backward; use impl='ref'")
    if u.device.type == "cpu":
        return selective_scan_ref(u, delta, A, B, C, D=D, z=z, delta_bias=delta_bias,
                                  delta_softplus=delta_softplus,
                                  return_last_state=return_last_state, h0=h0)
    if not u.is_cuda or any(t is not None and t.device != u.device for t in args):
        raise ValueError("selective_scan_kernel: every input must lie on one CUDA device")
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"selective_scan_kernel: dtype {u.dtype} not supported (fp32, bf16)")
    if any(t is not None and t.dtype != u.dtype for t in (delta, B, C, z)):
        raise ValueError("selective_scan_kernel: u, delta, B, C and z must share one dtype")
    if u.dim() != 3 or A.dim() != 2 or B.dim() != 3 or C.dim() != 3:
        raise ValueError("selective_scan_kernel: u (B, D, L), A (D, N), B and C (B, N, L)")
    bsz, dim, seqlen = u.shape
    n = A.shape[1]
    if (delta.shape != u.shape or (z is not None and z.shape != u.shape)
            or A.shape[0] != dim or B.shape != (bsz, n, seqlen) or C.shape != B.shape
            or (D is not None and D.shape != (dim,))
            or (delta_bias is not None and delta_bias.shape != (dim,))
            or (h0 is not None and h0.shape != (bsz, dim, n))):
        raise ValueError("selective_scan_kernel: input shapes do not agree")
    if not (1 <= n <= _MAX_STATE and seqlen >= 1 and 1 <= bsz <= 65535):
        raise ValueError(f"selective_scan_kernel: N {n} (1..{_MAX_STATE}), L {seqlen} (>= 1) "
                         f"and batch {bsz} (1..65535) are what the kernel takes")

    def f32(t):
        return None if t is None else t.float().contiguous()

    A32, D32, bias32, h032 = f32(A), f32(D), f32(delta_bias), f32(h0)
    y = torch.empty((bsz, seqlen, dim), dtype=u.dtype, device=u.device)
    h_out = torch.empty((bsz, dim, n), dtype=torch.float32, device=u.device)
    flags = ((z is not None) | (D is not None) << 1 | (delta_bias is not None) << 2
             | bool(delta_softplus) << 3 | (h0 is not None) << 4)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    zs = z.stride() if z is not None else (0, 0, 0)
    err = _build.kernel("selective_scan")(
        u.data_ptr(), delta.data_ptr(), ptr(z), A32.data_ptr(), B.data_ptr(), C.data_ptr(),
        ptr(D32), ptr(bias32), ptr(h032), y.data_ptr(), h_out.data_ptr(),
        bsz, dim, seqlen, n, int(u.dtype == torch.bfloat16), flags,
        *u.stride(), *delta.stride(), *zs, *B.stride(), *C.stride(),
        torch.cuda.current_stream(u.device).cuda_stream,
    )
    _build.check(err, "selective_scan_kernel")
    selective_scan_kernel.launches += 1
    y = y.transpose(1, 2)
    return (y, h_out) if return_last_state else y


selective_scan_kernel.launches = 0


def selective_scan(u, delta, A, B, C, D=None, z=None, delta_bias=None, delta_softplus=False,
                   return_last_state=False, h0=None, impl: str = "auto"):
    """Dispatching front end, with the JAX package's ``impl`` values:
    ``"pallas"`` is the hand-written forward kernel
    (``selective_scan_kernel``: CUDA on the card, the plain version on the
    CPU, no backward); ``"ref"`` the plain per-step loop.  The port has no
    associative scan, so ``"auto"`` (the JAX package's parallel-in-time,
    differentiable default) is the plain, differentiable
    ``selective_scan_ref`` here."""
    kw = dict(D=D, z=z, delta_bias=delta_bias, delta_softplus=delta_softplus,
              return_last_state=return_last_state, h0=h0)
    if impl == "pallas":
        return selective_scan_kernel(u, delta, A, B, C, **kw)
    if impl in ("auto", "ref"):
        return selective_scan_ref(u, delta, A, B, C, **kw)
    raise ValueError(f"selective_scan: impl {impl!r} (auto, ref, pallas)")


def selective_state_update(
    state: torch.Tensor,   # (B, D, N) fp32 carried SSM state
    x: torch.Tensor,       # (B, D)
    dt: torch.Tensor,      # (B, D)
    A: torch.Tensor,       # (D, N)
    B: torch.Tensor,       # (B, N)
    C: torch.Tensor,       # (B, N)
    D: Optional[torch.Tensor] = None,
    z: Optional[torch.Tensor] = None,
    dt_bias: Optional[torch.Tensor] = None,
    dt_softplus: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step: returns (y, new_state)."""
    x32 = x.float()
    dt32 = dt.float()
    if dt_bias is not None:
        dt32 = dt32 + dt_bias.float()[None, :]
    if dt_softplus:
        dt32 = _softplus(dt32)
    dA = torch.exp(dt32[:, :, None] * A.float()[None])
    dBx = (dt32 * x32)[:, :, None] * B.float()[:, None, :]
    new_state = state * dA + dBx
    y = torch.einsum("bdn,bn->bd", new_state, C.float())
    if D is not None:
        y = y + D.float()[None, :] * x32
    if z is not None:
        y = y * F.silu(z.float())
    return y.to(x.dtype), new_state


def causal_conv1d(
    x: torch.Tensor,        # (B, D, L)
    weight: torch.Tensor,   # (D, W)
    bias: Optional[torch.Tensor] = None,
    activation: Optional[str] = "silu",
) -> torch.Tensor:
    """Depthwise causal conv over time, left-padded with W-1 zeros, written
    as the same stack of shifted adds as the JAX package."""
    seqlen = x.shape[-1]
    width = weight.shape[-1]
    xf = x.float()
    wf = weight.float()
    out = torch.zeros_like(xf)
    for k in range(width):
        shift = width - 1 - k  # tap k sees x[t - shift]
        seg = xf if shift == 0 else F.pad(xf, (shift, 0))[:, :, :seqlen]
        out = out + seg * wf[None, :, k, None]
    if bias is not None:
        out = out + bias.float()[None, :, None]
    if activation == "silu":
        out = F.silu(out)
    return out.to(x.dtype)


def causal_conv1d_update(
    x: torch.Tensor,           # (B, D) new timestep
    conv_state: torch.Tensor,  # (B, D, W) rolling window, oldest first
    weight: torch.Tensor,      # (D, W)
    bias: Optional[torch.Tensor] = None,
    activation: Optional[str] = "silu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming conv step: roll the window, append x, apply the taps.
    Returns (y, new_conv_state)."""
    new_state = torch.cat([conv_state[:, :, 1:], x[:, :, None].to(conv_state.dtype)], dim=2)
    y = (new_state.float() * weight.float()[None]).sum(dim=-1)
    if bias is not None:
        y = y + bias.float()[None, :]
    if activation == "silu":
        y = F.silu(y)
    return y.to(x.dtype), new_state
