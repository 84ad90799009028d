"""The plain reference: StreamMind's perception and its decoders in float32.

Plain PyTorch, written from the published descriptions (CLIP ViT-L/14-336,
mamba_ssm's Mamba-1 step, a Mistral / Mixtral decoder), with TF32 off.  It
imports nothing of the port and takes from the benchmark only the weights
it drew (bfloat16 leaves, int4 codes and scales), each cast to float32 a
layer at a time on use.  What the port's set-up derives (the fused ViT
q/k/v, the int4 gate) it derives again with its own copies.

``Precision`` says how a product's operands are rounded: not at all (the
reference), or to fp8 e4m3 with a scale a row (the control: the step below
the bfloat16 a configuration states).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to fp8 e4m3 with one scale a row (its absmax at 448)."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Precision:
    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def linear(self, x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
        if self.fp8:
            x, w = fp8_round(x), fp8_round(w)
        y = x @ w.T
        return y if b is None else y + b.float()


FP32 = Precision(False)
FP8 = Precision(True)


# -- weights as the reference reads them -----------------------------------
def dequant_int4_pc(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Column-halved int4 pack: the low nibble of byte c is input column c,
    the high nibble column in/2 + c; one float32 scale an output row."""
    lo = (codes << 4) >> 4
    hi = codes >> 4
    return torch.cat([lo, hi], dim=-1).float() * scale.float()[..., None]


def quantize_int4_pc(w: torch.Tensor) -> torch.Tensor:
    """The int4 gate tier's rounding, done again: absmax / 7 a row, round,
    clamp to -7..7; returns the float32 weight it stands for."""
    w32 = w.float()
    scale = torch.clamp(w32.abs().amax(dim=-1, keepdim=True) / w32.new_tensor(7.0), min=1e-8)
    return torch.clamp(torch.round(w32 / scale), -7, 7) * scale


def weight(leaf: dict, i, int4_gate: bool = False) -> torch.Tensor:
    """Layer i's float32 weight of a linear leaf of the benchmark's tree."""
    if "w_int4pc" in leaf:
        return dequant_int4_pc(leaf["w_int4pc"][i], leaf["scale"][i])
    w = leaf["weight"][i]
    return quantize_int4_pc(w) if int4_gate else w.float()


# -- pieces ------------------------------------------------------------------
def layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w.float(), b.float(), eps)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate the halves of the head dim (Mistral's layout); x (N, H, hd)."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device, dtype=torch.float64) / hd)
    ang = (positions.double()[:, None] * inv[None]).float()
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, causal: bool, block: int = 512, alone: bool = False):
    """Softmax attention; q (N, H, hd), k/v (N, Hkv, hd), GQA by repeat.
    ``alone``: each row is a sequence of its own and sees only itself."""
    n, h, hd = q.shape
    rep = h // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)   # (H, N, hd)
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    out = []
    for s in range(0, n, block):
        qb = q[s:s + block].transpose(0, 1)               # (H, b, hd)
        scores = (qb @ k.transpose(1, 2)) / math.sqrt(hd)
        if causal or alone:
            rows = torch.arange(s, s + qb.shape[1], device=q.device)[:, None]
            cols = torch.arange(n, device=q.device)[None]
            scores = scores.masked_fill(cols != rows if alone else cols > rows, -math.inf)
        out.append((torch.softmax(scores, dim=-1) @ v).transpose(0, 1))
    return torch.cat(out, dim=0)


# -- the ViT ---------------------------------------------------------------------
def vit_features(w: dict, v, pixels: torch.Tensor, prec: Precision = FP32) -> torch.Tensor:
    """(B, 3, H, W) → (B, patches, d): the hidden state after ``run_layers``
    blocks of CLIP's pre-LN encoder, CLS dropped."""
    b, p, g = pixels.shape[0], v.patch, v.grid
    x = pixels.float().reshape(b, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5).reshape(b, g * g, -1)
    x = prec.linear(x, w["patch_embedding"].float())
    cls = w["class_embedding"].float()[None, None].expand(b, 1, v.d)
    x = torch.cat([cls, x], dim=1) + w["position_embedding"].float()[None]
    x = layer_norm(x, w["pre_layernorm"]["weight"], w["pre_layernorm"]["bias"], v.eps)
    L = w["layers"]
    for i in range(v.run_layers):
        y = layer_norm(x, L["ln1"]["weight"][i], L["ln1"]["bias"][i], v.eps)
        q, k, vv = (prec.linear(y, L[n]["weight"][i].float(), L[n]["bias"][i])
                    for n in ("q", "k", "v"))
        s = x.shape[1]
        o = torch.stack([attention(q[j].reshape(s, v.heads, v.head_dim),
                                   k[j].reshape(s, v.heads, v.head_dim),
                                   vv[j].reshape(s, v.heads, v.head_dim), causal=False)
                         for j in range(b)]).reshape(b, s, v.d)
        x = x + prec.linear(o, L["o"]["weight"][i].float(), L["o"]["bias"][i])
        y = layer_norm(x, L["ln2"]["weight"][i], L["ln2"]["bias"][i], v.eps)
        y = prec.linear(y, L["fc1"]["weight"][i].float(), L["fc1"]["bias"][i])
        y = y * torch.sigmoid(1.702 * y)
        x = x + prec.linear(y, L["fc2"]["weight"][i].float(), L["fc2"]["bias"][i])
    return x[:, 1:]


# -- the Mamba projector's step and the gate -------------------------------------
def mamba_step(w: dict, m, feats: torch.Tensor, conv: torch.Tensor, ssm: torch.Tensor,
               prec: Precision = FP32):
    """One frame of Video_Mamba_seq: (B, P, dv) features and the carried
    (blocks, B, inner, d_conv) / (blocks, B, inner, n) state → the (B, d)
    memory token and the new state."""
    x = feats.float().mean(dim=1)
    x = F.leaky_relu(prec.linear(x, w["pre_net"]["weight"].float(), w["pre_net"]["bias"]), 0.01)
    hidden, residual = x, None
    new_conv, new_ssm = [], []
    for i, b in enumerate(w["mamba"]["blocks"]):
        residual = hidden if residual is None else hidden + residual
        y = layer_norm(residual, b["norm"]["weight"], b["norm"]["bias"], m.eps)
        xz = prec.linear(y, b["in_proj"]["weight"].float(), b["in_proj"].get("bias"))
        xs, z = xz.chunk(2, dim=-1)
        window = torch.cat([conv[i][:, :, 1:].float(), xs[:, :, None]], dim=2)
        xc = (window * b["conv1d"]["weight"].float()[None]).sum(-1)
        if "bias" in b["conv1d"]:
            xc = xc + b["conv1d"]["bias"].float()
        xc = F.silu(xc)
        dbl = prec.linear(xc, b["x_proj"]["weight"].float())
        dt, B, C = dbl[:, : m.dt_rank], dbl[:, m.dt_rank: m.dt_rank + m.n], dbl[:, m.dt_rank + m.n:]
        dt = prec.linear(dt, b["dt_proj"]["weight"].float()) + b["dt_proj"]["bias"].float()
        dt = torch.logaddexp(dt, torch.zeros_like(dt))   # softplus
        A = -torch.exp(b["A_log"].float())
        h = ssm[i].float() * torch.exp(dt[:, :, None] * A[None]) + (dt * xc)[:, :, None] * B[:, None]
        out = (h * C[:, None]).sum(-1) + b["D"].float() * xc
        out = out * F.silu(z)
        hidden = prec.linear(out, b["out_proj"]["weight"].float(), b["out_proj"].get("bias"))
        new_conv.append(window)
        new_ssm.append(h)
    residual = hidden + residual
    fn = w["mamba"]["final_norm"]
    x = layer_norm(residual, fn["weight"], fn["bias"], m.eps)
    x = prec.linear(F.leaky_relu(x, 0.01), w["post_net"]["weight"].float(), w["post_net"]["bias"])
    return x, torch.stack(new_conv), torch.stack(new_ssm)


# -- decoders ---------------------------------------------------------------------
def _moe(y, lay, i, t, prec: Precision, route=None, seen=None):
    """Mixtral's sparse MoE over the int4 or plain banks of layer i: the
    router's softmax, the top k (ties to the lower id), renormalized.
    ``route`` (N, k): take these experts instead of the router's own top k,
    weighted by the router's probabilities of them; ``seen`` collects (own
    top k, the router's margin p_k - p_k+1, the experts taken)."""
    probs = torch.softmax(prec.linear(y, lay["router"]["weight"][i].float()), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topi = idx[:, : t.top_k] if route is None else route.to(y.device).long()
    if seen is not None:
        seen.append((idx[:, : t.top_k], vals[:, t.top_k - 1] - vals[:, t.top_k], topi))
    topw = probs.gather(1, topi)
    topw = topw / topw.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(y)
    ex = lay["experts"]
    for e in range(t.experts):
        rows, slot = (topi == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        leaf = {n: ex[n] if isinstance(ex[n], dict) else {"weight": ex[n]} for n in ex}
        wg, wu, wd = (weight({k: v[i] for k, v in leaf[n].items()}, e) for n in ("gate", "up", "down"))
        yr = y[rows]
        h = F.silu(prec.linear(yr, wg)) * prec.linear(yr, wu)
        out.index_add_(0, rows, prec.linear(h, wd) * topw[rows, slot][:, None])
    return out


def decoder_layers(w: dict, t, x: torch.Tensor, positions: torch.Tensor, prec: Precision = FP32,
                   int4_gate: bool = False, alone: bool = False, routes=None,
                   seen=None) -> torch.Tensor:
    """A causal decoder over one sequence x (N, d) float32 at ``positions``
    (``alone``: N sequences of one token each); returns the final-normed
    hidden states (N, d).  A MoE takes the experts ``routes`` (layers, N,
    k) names where given, and records its routing in ``seen``."""
    lay = w["layers"]
    n = x.shape[0]
    for i in range(t.layers):
        y = rms_norm(x, lay["input_norm"]["weight"][i], t.eps)
        q, k, v = (prec.linear(y, weight(lay[nm], i, int4_gate)) for nm in ("q", "k", "v"))
        q = rope(q.reshape(n, t.heads, t.head_dim), positions, t.theta)
        k = rope(k.reshape(n, t.kv_heads, t.head_dim), positions, t.theta)
        o = attention(q, k, v.reshape(n, t.kv_heads, t.head_dim), causal=not alone, alone=alone)
        x = x + prec.linear(o.reshape(n, t.q_dim), weight(lay["o"], i, int4_gate))
        y = rms_norm(x, lay["post_norm"]["weight"][i], t.eps)
        if t.experts > 1:
            x = x + _moe(y, lay, i, t, prec, None if routes is None else routes[i], seen)
        else:
            mlp = lay["mlp"]
            h = F.silu(prec.linear(y, weight(mlp["gate"], i, int4_gate))) * \
                prec.linear(y, weight(mlp["up"], i, int4_gate))
            x = x + prec.linear(h, weight(mlp["down"], i, int4_gate))
    return rms_norm(x, w["final_norm"]["weight"], t.eps)


def lm_head(w: dict, h: torch.Tensor, prec: Precision = FP32) -> torch.Tensor:
    return prec.linear(h, w["lm_head"]["weight"].float())


def gate_probs(w: dict, g, memory: torch.Tensor, prec: Precision = FP32) -> torch.Tensor:
    """The 4-layer gate LM (int4 per channel, rounded again here) over each
    memory token alone: (B, d) → (B, 2) probabilities."""
    pos = torch.zeros(memory.shape[0], dtype=torch.long, device=memory.device)
    h = decoder_layers(w, g, memory.float(), pos, prec, int4_gate=True, alone=True)
    return torch.softmax(lm_head(w, h, prec), dim=-1)


def sequence_logits(w: dict, t, embeds: torch.Tensor, at: torch.Tensor,
                    prec: Precision = FP32, routes=None, seen=None) -> torch.Tensor:
    """A dialogue's (N, d) input embeddings from position 0 → the (len(at),
    V) float32 logits at the positions ``at`` (``routes``, ``seen``: as
    ``decoder_layers``)."""
    pos = torch.arange(embeds.shape[0], device=embeds.device)
    h = decoder_layers(w, t, embeds.float(), pos, prec, routes=routes, seen=seen)
    return lm_head(w, h[at], prec)
