"""The plain reference of a Jamba decoder (AI21's ``JambaForCausalLM``, as
transformers' ``models/jamba/modeling_jamba.py`` writes it) in float32.

Plain PyTorch, TF32 off (``model.tf32_off``); it imports nothing of the
port.  It reads the benchmark's tree, in which each kind of layer's leaves
are stacked over the layers of that kind (``dims`` gives the plan), and
casts each weight to float32 on use; ``Precision``, the int4
dequantisation, ``rms_norm``, ``attention`` and ``lm_head`` are
``model.py``'s.  No cache and no batching: one dialogue's whole sequence,
the Mamba scan a step at a time over every channel at once.

The equations, layer by layer (HF's names):
  - every layer: x += mixer(rms_norm(x)); x += ffn(rms_norm(x))
    (input_layernorm, pre_ff_layernorm);
  - attention (layer i with i % attn_layer_period == attn_layer_offset):
    GQA, causal, no positional encoding;
  - Mamba-1 elsewhere: in_proj → x, z; a causal depthwise conv of width
    d_conv over x from a zero window, then silu; x_proj → dt, B, C, each
    through an RMSNorm (dt_layernorm, b_layernorm, c_layernorm); dt =
    softplus(dt_proj(dt)); h_t = exp(dt_t·A)·h_{t-1} + dt_t·x_t·B_t with
    A = -exp(A_log); y_t = h_t·C_t + D·x_t, times silu(z_t); out_proj;
  - the MoE (i % expert_layer_period == expert_layer_offset): an fp32
    softmax over the router's logits, the top k experts weighted by their
    probabilities as they are (not renormalised); a SwiGLU MLP elsewhere;
  - final RMSNorm, then the untied lm_head.
Departures: the scan's state is float32 (HF's slow path keeps it in the
model's dtype, float32 here as well).
"""
from __future__ import annotations

import math
from types import SimpleNamespace as NS

import torch
import torch.nn.functional as F

from . import model as ref
from .model import FP32, Precision, attention, rms_norm, weight

SCAN_CHUNK = 128   # scan steps whose dA and dB·x are formed at once


def dims(raw: dict) -> NS:
    """A Jamba decoder's sizes from its HF config.json keys, and its layer
    plan: per layer (mixer, index among its kind, ffn, index)."""
    d, heads = raw["hidden_size"], raw["num_attention_heads"]
    hd = raw.get("head_dim") or d // heads
    kv = raw.get("num_key_value_heads", heads)
    t = NS(vocab=raw["vocab_size"], d=d, ffn=raw["intermediate_size"],
           layers=raw["num_hidden_layers"], heads=heads, kv_heads=kv, head_dim=hd,
           eps=raw.get("rms_norm_eps", 1e-6), experts=raw.get("num_experts", 1),
           top_k=raw.get("num_experts_per_tok", 2), q_dim=heads * hd, kv_dim=kv * hd,
           inner=raw.get("mamba_expand", 2) * d, n=raw.get("mamba_d_state", 16),
           conv=raw.get("mamba_d_conv", 4),
           dt_rank=raw.get("mamba_dt_rank") or math.ceil(d / 16),
           conv_bias=raw.get("mamba_conv_bias", True), proj_bias=raw.get("mamba_proj_bias", False))
    seen = {"attention": 0, "mamba": 0, "moe": 0, "mlp": 0}
    plan = []
    for i in range(t.layers):
        mixer = ("attention" if i % raw["attn_layer_period"] == raw["attn_layer_offset"]
                 else "mamba")
        ffn = ("moe" if t.experts > 1 and i % raw["expert_layer_period"]
               == raw["expert_layer_offset"] else "mlp")
        plan.append((mixer, seen[mixer], ffn, seen[ffn]))
        seen[mixer] += 1
        seen[ffn] += 1
    t.plan, t.counts = plan, seen
    return t


def _leaf(holder: dict, i: int) -> dict:
    """Layer i's entries of a stacked linear leaf (plain or int4)."""
    return {k: v[i] for k, v in holder.items()}


def _linear(prec: Precision, x, leaf: dict, i: int):
    return prec.linear(x, weight(leaf, i), leaf["bias"][i] if "bias" in leaf else None)


def mamba_mixer(b: dict, m: int, t, y: torch.Tensor, prec: Precision = FP32, states=None):
    """Mamba layer m (of the stacked ``b``) over (N, d) float32; appends its
    final (conv window (inner, d_conv), state (inner, n)) to ``states``."""
    n = y.shape[0]
    xz = _linear(prec, y, b["in_proj"], m)
    xs, z = xz[:, : t.inner], xz[:, t.inner:]
    w = b["conv1d"]["weight"][m].float()                               # (inner, d_conv)
    padded = F.pad(xs.T, (t.conv - 1, 0))                               # (inner, N + d_conv - 1)
    xc = sum(w[:, k, None] * padded[:, k:k + n] for k in range(t.conv)).T
    if "bias" in b["conv1d"]:
        xc = xc + b["conv1d"]["bias"][m].float()
    xc = F.silu(xc)
    dbl = prec.linear(xc, b["x_proj"]["weight"][m].float())
    dt = rms_norm(dbl[:, : t.dt_rank], b["dt_norm"]["weight"][m], t.eps)
    bb = rms_norm(dbl[:, t.dt_rank: t.dt_rank + t.n], b["b_norm"]["weight"][m], t.eps)
    cc = rms_norm(dbl[:, t.dt_rank + t.n:], b["c_norm"]["weight"][m], t.eps)
    dt = prec.linear(dt, b["dt_proj"]["weight"][m].float(), b["dt_proj"]["bias"][m])
    dt = torch.logaddexp(dt, torch.zeros_like(dt))                      # softplus
    A = -torch.exp(b["A_log"][m].float())                              # (inner, n)
    h = torch.zeros((t.inner, t.n), dtype=torch.float32, device=y.device)
    out = torch.empty((n, t.inner), dtype=torch.float32, device=y.device)
    for s in range(0, n, SCAN_CHUNK):
        e = min(s + SCAN_CHUNK, n)
        dA = torch.exp(dt[s:e, :, None] * A[None])                      # (T, inner, n)
        dBx = (dt[s:e] * xc[s:e])[:, :, None] * bb[s:e, None, :]
        hs = torch.empty_like(dA)
        for j in range(e - s):
            h = torch.addcmul(dBx[j], dA[j], h, out=hs[j])
        out[s:e] = torch.einsum("tdn,tn->td", hs, cc[s:e])
    out = (out + b["D"][m].float() * xc) * F.silu(z)
    if states is not None:
        window = F.pad(xs.T, (max(t.conv - n, 0), 0))[:, -t.conv:]
        states.append((window, h))
    return _linear(prec, out, b["out_proj"], m)


def moe(y, lay: dict, e: int, t, prec: Precision = FP32, route=None, seen=None):
    """Jamba's sparse MoE of MoE layer e: the router's fp32 softmax, the top
    k (ties to the lower id) weighted by their probabilities as they are.
    ``route`` (N, k): take these experts instead, weighted by the router's
    probabilities of them; ``seen`` collects (own top k, the margin p_k -
    p_k+1, the experts taken), as ``model._moe`` does."""
    probs = torch.softmax(prec.linear(y, lay["router"]["weight"][e].float()), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topi = idx[:, : t.top_k] if route is None else route.to(y.device).long()
    if seen is not None:
        seen.append((idx[:, : t.top_k], vals[:, t.top_k - 1] - vals[:, t.top_k], topi))
    topw = probs.gather(1, topi)
    out = torch.zeros_like(y)
    ex = {n: v if isinstance(v, dict) else {"weight": v} for n, v in lay["experts"].items()}
    for x in range(t.experts):
        rows, slot = (topi == x).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        wg, wu, wd = (weight(_leaf(ex[n], e), x) for n in ("gate", "up", "down"))
        yr = y[rows]
        hh = F.silu(prec.linear(yr, wg)) * prec.linear(yr, wu)
        out.index_add_(0, rows, prec.linear(hh, wd) * topw[rows, slot][:, None])
    return out


def decoder_layers(w: dict, t, x: torch.Tensor, prec: Precision = FP32, routes=None,
                   seen=None, states=None) -> torch.Tensor:
    """The decoder over one sequence x (N, d) float32 from position 0;
    returns the final-normed hidden states (N, d).  The MoE layers take the
    experts ``routes`` (MoE layers, N, k) names where given and record their
    routing in ``seen``; the Mamba layers' final states go to ``states``."""
    lay = w["layers"]
    n = x.shape[0]
    for i, (mixer, a, ffn, f) in enumerate(t.plan):
        y = rms_norm(x, lay["input_norm"]["weight"][i], t.eps)
        if mixer == "attention":
            q, k, v = (prec.linear(y, weight(lay[nm], a)) for nm in ("q", "k", "v"))
            o = attention(q.reshape(n, t.heads, t.head_dim), k.reshape(n, t.kv_heads, t.head_dim),
                          v.reshape(n, t.kv_heads, t.head_dim), causal=True)
            x = x + prec.linear(o.reshape(n, t.q_dim), weight(lay["o"], a))
        else:
            x = x + mamba_mixer(lay["mamba"], a, t, y, prec, states)
        y = rms_norm(x, lay["post_norm"]["weight"][i], t.eps)
        if ffn == "moe":
            x = x + moe(y, lay, f, t, prec, None if routes is None else routes[f], seen)
        else:
            mlp = lay["mlp"]
            hh = F.silu(prec.linear(y, weight(mlp["gate"], f))) * prec.linear(y, weight(mlp["up"], f))
            x = x + prec.linear(hh, weight(mlp["down"], f))
    return rms_norm(x, w["final_norm"]["weight"], t.eps)


def sequence_logits(w: dict, t, embeds: torch.Tensor, at: torch.Tensor, prec: Precision = FP32,
                    routes=None, seen=None, states=None) -> torch.Tensor:
    """A dialogue's (N, d) input embeddings from position 0 → the (len(at),
    V) float32 logits at the positions ``at`` (``routes``, ``seen``,
    ``states``: as ``decoder_layers``)."""
    h = decoder_layers(w, t, embeds.float(), prec, routes=routes, seen=seen, states=states)
    return ref.lm_head(w, h[at], prec)
