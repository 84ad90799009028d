"""SSD (state-space duality) chunked scan: the Mamba-2 compute core.

The JAX package's ``ops/ssd.py``, plain torch (it is plain ``jnp`` there):
the chunked formulation of mamba_ssm's ``ssd_minimal``, whose within-chunk
part is attention-like batched products and whose state passing is a
short loop over L / chunk steps.

Shapes follow Mamba-2, with a scalar decay per head:
  x (B, L, H, P)   dt (B, L, H)   A (H,) negative
  B, C (B, L, G, N), the G groups broadcast over the H heads
Recurrence of head h, state (P, N):
  S_t = exp(dt_t A_h) S_{t-1} + dt_t x_t ⊗ B_t ;  y_t = S_t C_t + D_h x_t
Everything is computed in fp32; y is returned in x's dtype and the state
in fp32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def segsum(x: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{j < k <= i} x[..., k], -inf above the diagonal."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, float("-inf"))


def _heads(m: torch.Tensor, rep: int, axis: int) -> torch.Tensor:
    """Groups → heads: each group's slice repeated for its rep heads."""
    return m.float().repeat_interleave(rep, dim=axis)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int = 64, D: Optional[torch.Tensor] = None,
                h0: Optional[torch.Tensor] = None, return_last_state: bool = False):
    """The chunked scan; dt is already softplus'd.  L must be a multiple of
    ``chunk`` (pad upstream).  h0 (B, H, P, N) continues a carried state."""
    b, l, h, p = x.shape
    n = B.shape[3]
    if l % chunk:
        raise ValueError(f"ssd_chunked: L {l} is not a multiple of chunk {chunk}")
    nc = l // chunk
    rep = h // B.shape[2]
    x32 = x.float()
    xc = x32.reshape(b, nc, chunk, h, p)
    dtc = dt.float().reshape(b, nc, chunk, h)
    Bc = _heads(B, rep, 2).reshape(b, nc, chunk, h, n)
    Cc = _heads(C, rep, 2).reshape(b, nc, chunk, h, n)

    dA = dtc * A.float()                          # (B, NC, CH, H)
    dA_cum = torch.cumsum(dA, dim=2)

    # 1. within each chunk: an attention-like masked product
    decay = torch.exp(segsum(dA.permute(0, 1, 3, 2)))            # (B, NC, H, CH, CH)
    scores = torch.einsum("bzlhn,bzshn->bzhls", Cc, Bc)
    weights = scores * decay * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_diag = torch.einsum("bzhls,bzshp->bzlhp", weights, xc)

    # 2. each chunk's final state from its own inputs
    decay_states = torch.exp(dA_cum[:, :, -1:] - dA_cum)          # (B, NC, CH, H)
    states = torch.einsum("bzshn,bzshp->bzhpn", Bc * (decay_states * dtc)[..., None], xc)

    # 3. the states passed from chunk to chunk
    chunk_decay = torch.exp(dA.sum(dim=2))                        # (B, NC, H)
    carry = h0.float() if h0 is not None else x32.new_zeros((b, h, p, n))
    entering = []
    for z in range(nc):
        entering.append(carry)
        carry = carry * chunk_decay[:, z, :, None, None] + states[:, z]
    prev_states = torch.stack(entering, dim=1)                    # (B, NC, H, P, N)

    # 4. the entering state's part of each output
    y_off = torch.einsum("bzlhn,bzhpn->bzlhp", Cc, prev_states) * torch.exp(dA_cum)[..., None]

    y = (y_diag + y_off).reshape(b, l, h, p)
    if D is not None:
        y = y + D.float()[None, None, :, None] * x32
    y = y.to(x.dtype)
    return (y, carry) if return_last_state else y


def ssd_reference(x, dt, A, B, C, D=None, h0=None, return_last_state: bool = False):
    """The recurrence step by step (the ground truth of ``ssd_chunked``)."""
    b, l, h, p = x.shape
    n = B.shape[3]
    rep = h // B.shape[2]
    Bh, Ch = _heads(B, rep, 2), _heads(C, rep, 2)
    x32, dt32, A32 = x.float(), dt.float(), A.float()
    s = h0.float() if h0 is not None else x32.new_zeros((b, h, p, n))
    ys = []
    for t in range(l):
        s = s * torch.exp(dt32[:, t] * A32[None])[:, :, None, None] + torch.einsum(
            "bhp,bhn,bh->bhpn", x32[:, t], Bh[:, t], dt32[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", s, Ch[:, t]))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + D.float()[None, None, :, None] * x32
    y = y.to(x.dtype)
    return (y, s) if return_last_state else y


def ssd_state_update(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     B: torch.Tensor, C: torch.Tensor, D: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token (decode / streaming): state (B, H, P, N), x (B, H, P), dt
    (B, H) softplus'd, B / C (B, G, N).  Returns (y (B, H, P), new state)."""
    rep = state.shape[1] // B.shape[1]
    Bh, Ch = _heads(B, rep, 1), _heads(C, rep, 1)
    x32, dt32 = x.float(), dt.float()
    decay = torch.exp(dt32 * A.float()[None])
    state = state * decay[:, :, None, None] + torch.einsum("bhp,bhn,bh->bhpn", x32, Bh, dt32)
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    if D is not None:
        y = y + D.float()[None, :, None] * x32
    return y.to(x.dtype), state
