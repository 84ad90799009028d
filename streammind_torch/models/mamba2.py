"""Mamba-2 block (the second SSM family of the vendored mamba_ssm library).

The JAX package's ``models/mamba2.py``: grouped B / C heads, a scalar decay
per head, one causal conv over x, B and C together, a gated RMSNorm before
out_proj, and the chunked SSD scan of ``ops/ssd.py``.  ``mamba2_step``
carries the conv window and the fp32 SSM state one token at a time, and
``step∘step∘… == forward`` is held by the tests.  dt_bias, A_log and D stay
fp32 whatever the tree's dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.scan import _softplus, causal_conv1d, causal_conv1d_update
from ..ops.ssd import ssd_chunked, ssd_state_update
from ..utils.params import normal_init, ones, zeros


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int = 256
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    ngroups: int = 1
    chunk_size: int = 64
    dt_min: float = 0.001
    dt_max: float = 0.1
    A_init_range: Tuple[float, float] = (1.0, 16.0)
    norm_eps: float = 1e-5

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def nheads(self) -> int:
        return self.d_inner // self.headdim

    @property
    def d_xbc(self) -> int:
        return self.d_inner + 2 * self.ngroups * self.d_state


class Mamba2State(NamedTuple):
    conv: torch.Tensor  # (B, d_xbc, d_conv) rolling conv window, oldest first
    ssm: torch.Tensor   # (B, H, P, N) fp32


def init_mamba2_state(cfg: Mamba2Config, batch: int, device="cuda") -> Mamba2State:
    return Mamba2State(
        conv=torch.zeros((batch, cfg.d_xbc, cfg.d_conv), device=device),
        ssm=torch.zeros((batch, cfg.nheads, cfg.headdim, cfg.d_state), device=device))


def init_mamba2_params(g: torch.Generator, cfg: Mamba2Config, device="cuda",
                       dtype=torch.float32) -> dict:
    """mamba_ssm's init: A uniform in A_init_range, dt log-uniform in
    [dt_min, dt_max] and stored as softplus⁻¹(dt), D ones."""
    d_in_proj = 2 * cfg.d_inner + 2 * cfg.ngroups * cfg.d_state + cfg.nheads
    lo, hi = cfg.A_init_range
    kw = dict(device=device, dtype=dtype)
    A = torch.empty((cfg.nheads,), device=device).uniform_(lo, hi, generator=g)
    u = torch.empty((cfg.nheads,), device=device).uniform_(0.0, 1.0, generator=g)
    dt = torch.exp(u * (math.log(cfg.dt_max) - math.log(cfg.dt_min)) + math.log(cfg.dt_min))
    dt = torch.clamp(dt, min=1e-4)
    bound = 1.0 / math.sqrt(cfg.d_conv)
    return {
        "in_proj": {"weight": normal_init(g, (d_in_proj, cfg.d_model), std=0.02, **kw)},
        "conv1d": {
            "weight": torch.empty((cfg.d_xbc, cfg.d_conv), **kw).uniform_(-bound, bound,
                                                                          generator=g),
            "bias": zeros((cfg.d_xbc,), **kw),
        },
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "A_log": torch.log(A),
        "D": ones((cfg.nheads,), device),
        "norm": {"weight": ones((cfg.d_inner,), **kw)},
        "out_proj": {"weight": normal_init(g, (cfg.d_model, cfg.d_inner), std=0.02, **kw)},
    }


def _gated_rms_norm(x: torch.Tensor, z: torch.Tensor, weight: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """RMSNorm(x · silu(z)) · w in fp32, rounded to x's dtype."""
    y = x * F.silu(z.float())
    var = y.square().mean(dim=-1, keepdim=True)
    return (y * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def _split_proj(cfg: Mamba2Config, zxbcdt: torch.Tensor):
    return torch.split(zxbcdt, [cfg.d_inner, cfg.d_xbc, cfg.nheads], dim=-1)  # z, xBC, dt


def _split_xbc(cfg: Mamba2Config, xbc: torch.Tensor):
    gn = cfg.ngroups * cfg.d_state
    return torch.split(xbc, [cfg.d_inner, gn, gn], dim=-1)  # x, B, C


def mamba2_forward(params, cfg: Mamba2Config, u: torch.Tensor,
                   state: Optional[Mamba2State] = None, return_state: bool = False):
    """u (B, L, d_model) → (B, L, d_model), from ``state`` if given (the conv
    window and SSM state a previous call returned), and with the new state
    when ``return_state``."""
    b, l, _ = u.shape
    z, xbc, dt = _split_proj(cfg, u @ params["in_proj"]["weight"].T.to(u.dtype))
    xbc_t = xbc.transpose(1, 2)
    w, bias = params["conv1d"]["weight"], params["conv1d"]["bias"]
    if state is not None:
        pad_src = torch.cat([state.conv[:, :, 1:].to(xbc_t.dtype), xbc_t], dim=2)
        xbc_conv = causal_conv1d(pad_src, w, bias)[:, :, -l:]
        h0 = state.ssm
    else:
        pad_src = xbc_t
        xbc_conv = causal_conv1d(xbc_t, w, bias)
        h0 = None
    x, B, C = _split_xbc(cfg, xbc_conv.transpose(1, 2))
    x = x.reshape(b, l, cfg.nheads, cfg.headdim)
    B = B.reshape(b, l, cfg.ngroups, cfg.d_state)
    C = C.reshape(b, l, cfg.ngroups, cfg.d_state)
    dt_sp = _softplus(dt.float() + params["dt_bias"].float()[None, None])
    A = -torch.exp(params["A_log"].float())

    pad = (-l) % cfg.chunk_size  # L padded to the chunk size
    if pad:
        x, B, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, B, C))
        dt_sp = F.pad(dt_sp, (0, 0, 0, pad))
    y, last = ssd_chunked(x, dt_sp, A, B, C, chunk=cfg.chunk_size, D=params["D"], h0=h0,
                          return_last_state=True)
    y = _gated_rms_norm(y[:, :l].reshape(b, l, cfg.d_inner), z, params["norm"]["weight"],
                        cfg.norm_eps)
    out = y @ params["out_proj"]["weight"].T.to(y.dtype)
    if not return_state:
        return out
    window = F.pad(pad_src, (max(cfg.d_conv - pad_src.shape[-1], 0), 0))[:, :, -cfg.d_conv:]
    return out, Mamba2State(conv=window, ssm=last)


def mamba2_step(params, cfg: Mamba2Config, u: torch.Tensor,
                state: Mamba2State) -> Tuple[torch.Tensor, Mamba2State]:
    """One token u (B, d_model) → (B, d_model) and the new state."""
    b = u.shape[0]
    z, xbc, dt = _split_proj(cfg, u @ params["in_proj"]["weight"].T.to(u.dtype))
    xbc_c, conv = causal_conv1d_update(xbc, state.conv, params["conv1d"]["weight"],
                                       params["conv1d"]["bias"])
    x, B, C = _split_xbc(cfg, xbc_c)
    dt_sp = _softplus(dt.float() + params["dt_bias"].float()[None])
    A = -torch.exp(params["A_log"].float())
    y, ssm = ssd_state_update(state.ssm, x.reshape(b, cfg.nheads, cfg.headdim), dt_sp, A,
                              B.reshape(b, cfg.ngroups, cfg.d_state),
                              C.reshape(b, cfg.ngroups, cfg.d_state), D=params["D"])
    y = _gated_rms_norm(y.reshape(b, cfg.d_inner), z, params["norm"]["weight"], cfg.norm_eps)
    out = y @ params["out_proj"]["weight"].T.to(y.dtype)
    return out, Mamba2State(conv=conv, ssm=ssm)
