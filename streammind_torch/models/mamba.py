"""Mamba-1 block + VideoMamba stack (the temporal memory).

Two execution modes share one parameter tree:
  * ``video_mamba_forward`` — full-sequence scan;
  * ``video_mamba_step``    — O(1) carried-state update (streaming perception);
and ``step∘step∘… == forward`` is held by the tests.  The residual stream
is fp32 (mamba_ssm's ``residual_in_fp32``), and ``A = -exp(A_log)`` in fp32.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..config import MambaConfig
from ..ops.norms import layer_norm
from ..ops.scan import (
    causal_conv1d,
    causal_conv1d_update,
    selective_scan,
    selective_state_update,
)
from ..utils.params import linear, normal_init, ones, torch_linear_init, zeros


class MambaState(NamedTuple):
    """Carried streaming state of one Mamba layer stack.

    conv: (n_layers, B, d_inner, d_conv) rolling conv window
    ssm:  (n_layers, B, d_inner, d_state) fp32 SSM state
    """

    conv: torch.Tensor
    ssm: torch.Tensor


def init_mamba_state(cfg: MambaConfig, batch: int, device="cuda",
                     dtype=torch.float32) -> MambaState:
    return MambaState(
        conv=torch.zeros((cfg.n_layers, batch, cfg.d_inner, cfg.d_conv), dtype=dtype, device=device),
        ssm=torch.zeros((cfg.n_layers, batch, cfg.d_inner, cfg.d_state), dtype=torch.float32,
                        device=device),
    )


def init_mamba_block_params(g: torch.Generator, cfg: MambaConfig, device="cuda",
                            dtype=torch.float32):
    """One Mamba mixer with mamba_ssm's init (dt special init, S4D-real A)."""
    d_in = cfg.d_inner
    dt_rank = cfg.dt_rank_
    kw = dict(device=device, dtype=dtype)
    dt_w = torch.empty((d_in, dt_rank), **kw).uniform_(-dt_rank ** -0.5, dt_rank ** -0.5,
                                                        generator=g)
    u = torch.empty((d_in,), device=device).uniform_(0.0, 1.0, generator=g)
    dt = torch.exp(u * (math.log(cfg.dt_max) - math.log(cfg.dt_min)) + math.log(cfg.dt_min))
    dt = torch.clamp(dt, min=cfg.dt_init_floor)
    inv_dt = dt + torch.log(-torch.expm1(-dt))
    A_log = torch.log(torch.arange(1, cfg.d_state + 1, dtype=torch.float32, device=device)
                      ).expand(d_in, cfg.d_state).contiguous()
    in_proj = {"weight": normal_init(g, (2 * d_in, cfg.d_model), std=0.02, **kw)}
    if cfg.bias:
        in_proj["bias"] = zeros((2 * d_in,), **kw)
    bound = math.sqrt(1.0 / cfg.d_conv)
    conv = {"weight": torch.empty((d_in, cfg.d_conv), **kw).uniform_(-bound, bound, generator=g)}
    if cfg.conv_bias:
        conv["bias"] = torch.empty((d_in,), **kw).uniform_(-bound, bound, generator=g)
    return {
        "in_proj": in_proj,
        "out_proj": torch_linear_init(g, cfg.d_model, d_in, bias=cfg.bias, **kw),
        "conv1d": conv,
        "x_proj": {"weight": normal_init(g, (dt_rank + 2 * cfg.d_state, d_in), std=0.02, **kw)},
        "dt_proj": {"weight": dt_w, "bias": inv_dt.to(dtype)},
        "A_log": A_log,  # kept fp32
        "D": ones((d_in,), device=device, dtype=torch.float32),
        "norm": {"weight": ones((cfg.d_model,), **kw), "bias": zeros((cfg.d_model,), **kw)},
    }


def init_video_mamba_params(g: torch.Generator, cfg: MambaConfig, device="cuda",
                            dtype=torch.float32):
    kw = dict(device=device, dtype=dtype)
    return {
        "blocks": [init_mamba_block_params(g, cfg, **kw) for _ in range(cfg.n_layers)],
        "final_norm": {"weight": ones((cfg.d_model,), **kw), "bias": zeros((cfg.d_model,), **kw)},
    }


def _split_dbl(x_dbl, cfg: MambaConfig):
    r, n = cfg.dt_rank_, cfg.d_state
    return x_dbl[..., :r], x_dbl[..., r:r + n], x_dbl[..., r + n:]


def _mixer_forward(bp, cfg: MambaConfig, x: torch.Tensor, impl: str = "auto",
                   conv_state0: Optional[torch.Tensor] = None,
                   ssm_state0: Optional[torch.Tensor] = None):
    """Mamba mixer over (B, L, D) → (B, L, D) + final (conv, ssm) state;
    with carried states it continues a stream mid-flight.  ``impl`` picks
    the scan (``ops.scan.selective_scan``); its inputs are the projections'
    (B, L, D) products seen as (B, D, L), channels contiguous."""
    l = x.shape[1]
    xz = linear(x, bp["in_proj"])
    xs, z = xz.chunk(2, dim=-1)
    xs_t = xs.transpose(1, 2)  # (B, Din, L)
    conv_w, conv_b = bp["conv1d"]["weight"], bp["conv1d"].get("bias")
    if conv_state0 is not None:
        ext = torch.cat([conv_state0[:, :, 1:].to(xs_t.dtype), xs_t], dim=2)
        xconv = causal_conv1d(ext, conv_w, conv_b, activation="silu")[:, :, -l:]
        pad_src = ext
    else:
        xconv = causal_conv1d(xs_t, conv_w, conv_b, activation="silu")
        pad_src = xs_t
    # final conv window: the last d_conv inputs (pre-activation), zero-padded
    pad = torch.nn.functional.pad(pad_src, (max(cfg.d_conv - pad_src.shape[-1], 0), 0))
    conv_state = pad[:, :, -cfg.d_conv:]

    x_dbl = xconv.transpose(1, 2) @ bp["x_proj"]["weight"].T.to(x.dtype)
    dt, Bc, Cc = _split_dbl(x_dbl, cfg)
    dt = dt @ bp["dt_proj"]["weight"].T.to(x.dtype)
    A = -torch.exp(bp["A_log"].float())
    y, last_state = selective_scan(
        xconv, dt.transpose(1, 2), A, Bc.transpose(1, 2), Cc.transpose(1, 2),
        D=bp["D"], z=z.transpose(1, 2), delta_bias=bp["dt_proj"]["bias"],
        delta_softplus=True, return_last_state=True, h0=ssm_state0, impl=impl,
    )
    return linear(y.transpose(1, 2), bp["out_proj"]), (conv_state, last_state)


def _mixer_step(bp, cfg: MambaConfig, x: torch.Tensor, conv_state, ssm_state):
    """Single-token mixer step (B, D) → (B, D); the per-frame hot path."""
    xz = linear(x, bp["in_proj"])
    xs, z = xz.chunk(2, dim=-1)
    xc, conv_state = causal_conv1d_update(
        xs, conv_state, bp["conv1d"]["weight"], bp["conv1d"].get("bias")
    )
    x_dbl = xc @ bp["x_proj"]["weight"].T.to(x.dtype)
    dt, Bc, Cc = _split_dbl(x_dbl, cfg)
    dt = dt @ bp["dt_proj"]["weight"].T.to(x.dtype)
    A = -torch.exp(bp["A_log"].float())
    y, ssm_state = selective_state_update(
        ssm_state, xc, dt, A, Bc, Cc,
        D=bp["D"], z=z, dt_bias=bp["dt_proj"]["bias"], dt_softplus=True,
    )
    return linear(y, bp["out_proj"]), conv_state, ssm_state


def video_mamba_forward(params, cfg: MambaConfig, x: torch.Tensor,
                        state: Optional[MambaState] = None,
                        impl: str = "auto") -> Tuple[torch.Tensor, MambaState]:
    """VideoMamba over (B, L, d_model): prenorm blocks, an fp32 residual
    stream, then the final LayerNorm.  ``state`` continues a stream; ``impl``
    is the scan's (auto, ref, pallas)."""
    hidden, residual = x, None
    conv_states, ssm_states = [], []
    for i, bp in enumerate(params["blocks"]):
        residual = hidden.float() if residual is None else hidden.float() + residual
        normed = layer_norm(residual, bp["norm"]["weight"], bp["norm"]["bias"],
                            cfg.layer_norm_eps).to(x.dtype)
        hidden, (cs, ss) = _mixer_forward(
            bp, cfg, normed, impl,
            conv_state0=state.conv[i] if state is not None else None,
            ssm_state0=state.ssm[i] if state is not None else None,
        )
        conv_states.append(cs)
        ssm_states.append(ss)
    residual = hidden.float() + residual if residual is not None else hidden.float()
    out = layer_norm(residual, params["final_norm"]["weight"], params["final_norm"]["bias"],
                     cfg.layer_norm_eps).to(x.dtype)
    return out, MambaState(conv=torch.stack(conv_states, 0), ssm=torch.stack(ssm_states, 0))


def video_mamba_step(params, cfg: MambaConfig, x: torch.Tensor,
                     state: MambaState) -> Tuple[torch.Tensor, MambaState]:
    """One streaming step (B, d_model) through the block stack."""
    hidden, residual = x, None
    conv_out, ssm_out = [], []
    for i, bp in enumerate(params["blocks"]):
        # fp32 residual, exactly as video_mamba_forward
        residual = hidden.float() if residual is None else hidden.float() + residual
        normed = layer_norm(residual, bp["norm"]["weight"], bp["norm"]["bias"],
                            cfg.layer_norm_eps).to(x.dtype)
        hidden, cs, ss = _mixer_step(bp, cfg, normed, state.conv[i], state.ssm[i])
        conv_out.append(cs)
        ssm_out.append(ss)
    residual = hidden.float() + residual if residual is not None else hidden.float()
    out = layer_norm(residual, params["final_norm"]["weight"], params["final_norm"]["bias"],
                     cfg.layer_norm_eps).to(x.dtype)
    return out, MambaState(conv=torch.stack(conv_out, 0), ssm=torch.stack(ssm_out, 0))
