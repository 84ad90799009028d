"""Mamba-1 block + VideoMamba stack (the temporal memory).

Two execution modes share one parameter tree:
  * ``video_mamba_forward`` — full-sequence scan;
  * ``video_mamba_step``    — O(1) carried-state update (streaming perception);
and ``step∘step∘… == forward`` is held by the tests.  The residual stream
is fp32 (mamba_ssm's ``residual_in_fp32``), and ``A = -exp(A_log)`` in fp32.

Under a mesh d_inner splits over tp: in_proj is column-parallel (the rank
holds its chunk of the x rows and of the z rows), conv1d, dt_proj, A_log
and D hold the rank's channels, x_proj is row-parallel over d_inner (its
dt_rank + 2·d_state outputs summed over tp before dt_proj, B and C),
out_proj row-parallel; the conv and ssm carries hold the rank's channels.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..config import MambaConfig
from ..ops.norms import layer_norm, rms_norm
from ..ops.scan import (
    causal_conv1d,
    causal_conv1d_update,
    selective_scan,
    selective_state_update,
)
from ..parallel import collectives as C
from ..parallel.mesh import ambient_mesh, is_trivial
from ..parallel.partitioning import row_linear, use_leaf, use_linear
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


def _split_dbl(x_dbl, cfg: MambaConfig, bp):
    """x_proj's product as (dt, B, C); a block with ``dt_norm`` (Jamba's
    mixer) puts an RMSNorm of eps ``cfg.layer_norm_eps`` on each."""
    r, n = cfg.dt_rank_, cfg.d_state
    dt, b, c = x_dbl[..., :r], x_dbl[..., r:r + n], x_dbl[..., r + n:]
    if "dt_norm" not in bp:
        return dt, b, c
    eps = cfg.layer_norm_eps
    return (rms_norm(dt, bp["dt_norm"]["weight"], eps), rms_norm(b, bp["b_norm"]["weight"], eps),
            rms_norm(c, bp["c_norm"]["weight"], eps))


def _window_at(conv_state0, xs_t, lengths, width: int):
    """Each row's conv window (the last ``width`` inputs) after its first
    lengths[b] steps of xs_t (B, D, L), continuing conv_state0 (zeros
    where None)."""
    b, d, _ = xs_t.shape
    prev = (xs_t.new_zeros((b, d, width)) if conv_state0 is None
            else conv_state0.to(xs_t.dtype))
    full = torch.cat([prev, xs_t], dim=2)
    cols = lengths.long()[:, None] + torch.arange(width, device=xs_t.device)[None]
    return full.gather(2, cols[:, None, :].expand(b, d, width))


def _local_block(bp, path: str) -> dict:
    """A block's leaves as this rank's products read them (None off a
    mesh): in_proj by its rows, conv1d / dt_proj / A_log / D by channel,
    x_proj by its d_inner columns, the fsdp dims gathered."""
    mesh = ambient_mesh()
    if is_trivial(mesh):
        return None
    def by_channel(t, name):
        return use_leaf(t, f"{path}.{name}", mesh=mesh, tp_dim=0)
    return {
        "mesh": mesh,
        "in_proj": use_linear(bp["in_proj"], f"{path}.in_proj", "col", mesh=mesh),
        "conv_w": by_channel(bp["conv1d"]["weight"], "conv1d.weight"),
        "conv_b": (by_channel(bp["conv1d"]["bias"], "conv1d.bias")
                   if "bias" in bp["conv1d"] else None),
        "x_proj": use_leaf(bp["x_proj"]["weight"], f"{path}.x_proj.weight", mesh=mesh, tp_dim=1),
        "dt_w": by_channel(bp["dt_proj"]["weight"], "dt_proj.weight"),
        "dt_b": by_channel(bp["dt_proj"]["bias"], "dt_proj.bias"),
        "A_log": by_channel(bp["A_log"], "A_log"),
        "D": by_channel(bp["D"], "D"),
    }


def _projections(bp, loc, x):
    """(in_proj, conv w, conv b, x_proj product, dt_proj weight, dt bias,
    A_log, D) of a block, one device's or this rank's."""
    if loc is None:
        return (linear(x, bp["in_proj"]), bp["conv1d"]["weight"], bp["conv1d"].get("bias"),
                lambda xc: xc @ bp["x_proj"]["weight"].T.to(x.dtype), bp["dt_proj"]["weight"],
                bp["dt_proj"]["bias"], bp["A_log"], bp["D"])
    mesh = loc["mesh"]

    def x_proj(xc):  # row-parallel; the sum's uses are per rank again
        return C.copy_to_tp(C.reduce_from_tp(xc @ loc["x_proj"].T.to(x.dtype), mesh), mesh)

    return (linear(C.copy_to_tp(x, mesh), loc["in_proj"]), loc["conv_w"], loc["conv_b"],
            x_proj, loc["dt_w"], loc["dt_b"], loc["A_log"], loc["D"])


def _out_proj(bp, y, path: str):
    return row_linear(y, bp["out_proj"], f"{path}.out_proj")


def _mixer_forward(bp, cfg: MambaConfig, x: torch.Tensor, impl: str = "auto",
                   conv_state0: Optional[torch.Tensor] = None,
                   ssm_state0: Optional[torch.Tensor] = None, path: str = "",
                   lengths: Optional[torch.Tensor] = None):
    """Mamba mixer over (B, L, D) → (B, L, D) + final (conv, ssm) state;
    with carried states it continues a stream mid-flight.  ``impl`` picks
    the scan (``ops.scan.selective_scan``); its inputs are the projections'
    (B, L, D) products seen as (B, D, L), channels contiguous.

    ``lengths`` (B,): row b's real tokens are its first lengths[b] of a
    right-padded block, and the final state is taken there, as if the pads
    had never been fed: dt is -inf at a pad, so softplus gives a step of 0
    (dA 1, dB·u 0) and the scan carries the state through unchanged; the
    conv window is gathered at the row's length."""
    l = x.shape[1]
    xz, conv_w, conv_b, x_proj, dt_w, dt_b, A_log, D = _projections(
        bp, _local_block(bp, path), x)
    xs, z = xz.chunk(2, dim=-1)
    xs_t = xs.transpose(1, 2)  # (B, Din, L)
    if conv_state0 is not None:
        ext = torch.cat([conv_state0[:, :, 1:].to(xs_t.dtype), xs_t], dim=2)
        xconv = causal_conv1d(ext, conv_w, conv_b, activation="silu")[:, :, -l:]
    else:
        xconv = causal_conv1d(xs_t, conv_w, conv_b, activation="silu")
    # final conv window: the last d_conv inputs (pre-activation) of each row
    real = lengths if lengths is not None else torch.full((x.shape[0],), l, device=x.device)
    conv_state = _window_at(conv_state0, xs_t, real, cfg.d_conv)

    x_dbl = x_proj(xconv.transpose(1, 2))
    dt, Bc, Cc = _split_dbl(x_dbl, cfg, bp)
    dt = dt @ dt_w.T.to(x.dtype)
    if lengths is not None:
        pads = torch.arange(l, device=x.device)[None, :] >= lengths.long()[:, None]
        dt = dt.masked_fill(pads[:, :, None], float("-inf"))
    A = -torch.exp(A_log.float())
    y, last_state = selective_scan(
        xconv, dt.transpose(1, 2), A, Bc.transpose(1, 2), Cc.transpose(1, 2),
        D=D, z=z.transpose(1, 2), delta_bias=dt_b,
        delta_softplus=True, return_last_state=True, h0=ssm_state0, impl=impl,
    )
    return _out_proj(bp, y.transpose(1, 2), path), (conv_state, last_state)


def _mixer_step(bp, cfg: MambaConfig, x: torch.Tensor, conv_state, ssm_state, path: str = ""):
    """Single-token mixer step (B, D) → (B, D); the per-frame hot path."""
    xz, conv_w, conv_b, x_proj, dt_w, dt_b, A_log, D = _projections(
        bp, _local_block(bp, path), x)
    xs, z = xz.chunk(2, dim=-1)
    xc, conv_state = causal_conv1d_update(xs, conv_state, conv_w, conv_b)
    x_dbl = x_proj(xc)
    dt, Bc, Cc = _split_dbl(x_dbl, cfg, bp)
    dt = dt @ dt_w.T.to(x.dtype)
    A = -torch.exp(A_log.float())
    y, ssm_state = selective_state_update(
        ssm_state, xc, dt, A, Bc, Cc,
        D=D, z=z, dt_bias=dt_b, dt_softplus=True,
    )
    return _out_proj(bp, y, path), conv_state, ssm_state


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
            path=f"projector.mamba.blocks.{i}",
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
        hidden, cs, ss = _mixer_step(bp, cfg, normed, state.conv[i], state.ssm[i],
                                     path=f"projector.mamba.blocks.{i}")
        conv_out.append(cs)
        ssm_out.append(ss)
    residual = hidden.float() + residual if residual is not None else hidden.float()
    out = layer_norm(residual, params["final_norm"]["weight"], params["final_norm"]["bias"],
                     cfg.layer_norm_eps).to(x.dtype)
    return out, MambaState(conv=torch.stack(conv_out, 0), ssm=torch.stack(ssm_out, 0))
