"""Selective-scan (Mamba-1 SSM) ops in plain torch.

The per-frame step (``selective_state_update``, ``causal_conv1d_update``)
is a handful of elementwise ops, left to XLA in the JAX package and to
plain torch here.  ``selective_scan_ref`` and ``causal_conv1d`` serve the
full-sequence forward that the step is held against.

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
