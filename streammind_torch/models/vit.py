"""CLIP ViT vision tower (ViT-L/14-336).

Taps hidden layer ``select_layer`` (default -2, so only the first
num_layers-1 blocks run) and drops the CLS token under
``select_feature="patch"``: output (frames, 576, 1024).  The patch
embedding is a reshape + matmul; attention goes through the shared
dispatcher, whose ``"exact"`` path is the hand-written CUDA kernel.  An
int8 tree (``fast_vision="int8"``) runs its linears int8 by int8.
"""
from __future__ import annotations

import torch

from ..config import VisionConfig
from ..ops.attention import attention
from ..ops.norms import layer_norm
from ..utils.params import layer_slice, linear, normal_init, ones, torch_linear_init, zeros


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """OpenAI CLIP activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def init_vit_params(g: torch.Generator, cfg: VisionConfig, device="cuda",
                    dtype=torch.float32):
    """Random ViT weights, layer leaves stacked on a leading (L,) axis and
    generated at that shape directly."""
    d = cfg.hidden_size
    L = cfg.num_layers
    patch_dim = 3 * cfg.patch_size * cfg.patch_size
    kw = dict(device=device, dtype=dtype)
    return {
        "class_embedding": normal_init(g, (d,), std=d ** -0.5, **kw),
        "patch_embedding": normal_init(g, (d, patch_dim), std=0.02, **kw),
        "position_embedding": normal_init(g, (cfg.num_patches + 1, d), std=0.02, **kw),
        "pre_layernorm": {"weight": ones((d,), **kw), "bias": zeros((d,), **kw)},
        "layers": {
            "ln1": {"weight": ones((L, d), **kw), "bias": zeros((L, d), **kw)},
            "q": torch_linear_init(g, d, d, lead=(L,), **kw),
            "k": torch_linear_init(g, d, d, lead=(L,), **kw),
            "v": torch_linear_init(g, d, d, lead=(L,), **kw),
            "o": torch_linear_init(g, d, d, lead=(L,), **kw),
            "ln2": {"weight": ones((L, d), **kw), "bias": zeros((L, d), **kw)},
            "fc1": torch_linear_init(g, cfg.intermediate_size, d, lead=(L,), **kw),
            "fc2": torch_linear_init(g, d, cfg.intermediate_size, lead=(L,), **kw),
        },
    }


def _embed(params, cfg: VisionConfig, pixel_values: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) → (B, 1+P, D): patchify as reshape+matmul, prepend CLS."""
    b = pixel_values.shape[0]
    p = cfg.patch_size
    g = cfg.image_size // p
    x = pixel_values.reshape(b, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(b, g * g, 3 * p * p)
    x = x @ params["patch_embedding"].T.to(x.dtype)
    cls = params["class_embedding"].to(x.dtype)[None, None].expand(b, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1)
    return x + params["position_embedding"].to(x.dtype)[None]


def _linear_q(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Encoder linear.  Full-precision leaves go to ``utils.params.linear``;
    int8 leaves (``utils.quantize.quantize_vit_params``) run the int8 tier:
    the activations are quantized per token (symmetric absmax over the
    feature axis), multiplied int8 by int8 into int32 (an exact integer
    product: ``torch._int_mm``, a library product as the JAX package leaves
    its einsum to XLA), then rescaled by act_scale ⊗ weight_scale in fp32."""
    if "w_int8" not in p:
        return linear(x, p)
    x32 = x.float()
    ax = x32.abs().amax(dim=-1, keepdim=True)
    ax = torch.clamp(ax / ax.new_tensor(127.0), min=1e-8)
    xq = torch.clamp(torch.round(x32 / ax), -127, 127).to(torch.int8)
    y = torch._int_mm(xq.reshape(-1, x.shape[-1]), p["w_int8"].T)
    y = y.reshape(*x.shape[:-1], -1).float() * ax * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


def fuse_vit_qkv(vit_params: dict) -> dict:
    """Concatenate each layer's q/k/v projections into one (3D, D) weight
    (output-dim concat: every output column is the same dot as before), on
    full-precision and int8 trees alike; on the int8 tier it also saves two
    of the three activation quantizations."""
    layers = vit_params.get("layers", {})
    if "q" not in layers:
        return vit_params
    out = dict(vit_params)
    layers = dict(layers)
    q, k, v = layers.pop("q"), layers.pop("k"), layers.pop("v")
    wkey = "w_int8" if "w_int8" in q else "weight"
    fused = {wkey: torch.cat([q[wkey], k[wkey], v[wkey]], dim=-2)}
    for key in ("scale", "bias"):
        if key in q:
            fused[key] = torch.cat([q[key], k[key], v[key]], dim=-1)
    layers["qkv"] = fused
    out["layers"] = layers
    return out


def _encoder_layer(x, lp, cfg: VisionConfig, attn_impl: str):
    b, s, d = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    res = x
    y = layer_norm(x, lp["ln1"]["weight"], lp["ln1"]["bias"], cfg.layer_norm_eps)
    if "qkv" in lp:
        # strided views of the fused product; the exact kernel reads them as is
        qkv = _linear_q(y, lp["qkv"]).reshape(b, s, 3, h, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q = _linear_q(y, lp["q"]).reshape(b, s, h, hd)
        k = _linear_q(y, lp["k"]).reshape(b, s, h, hd)
        v = _linear_q(y, lp["v"]).reshape(b, s, h, hd)
    o = attention(q, k, v, causal=False, impl=attn_impl).reshape(b, s, d)
    x = res + _linear_q(o, lp["o"])
    res = x
    y = layer_norm(x, lp["ln2"]["weight"], lp["ln2"]["bias"], cfg.layer_norm_eps)
    return res + _linear_q(quick_gelu(_linear_q(y, lp["fc1"])), lp["fc2"])


def vit_forward(params, cfg: VisionConfig, pixel_values: torch.Tensor,
                attn_impl: str = "auto") -> torch.Tensor:
    """(B, 3, H, W) frames → (B, 576, hidden) patch features at the selected
    hidden layer (``select_feature="patch"``; "cls_patch" keeps CLS)."""
    x = _embed(params, cfg, pixel_values)
    x = layer_norm(x, params["pre_layernorm"]["weight"], params["pre_layernorm"]["bias"],
                   cfg.layer_norm_eps)
    # hidden_states[select_layer]: -2 runs every block but the last
    n_run = (cfg.num_layers + cfg.select_layer + 1 if cfg.select_layer < 0
             else cfg.select_layer)
    for i in range(n_run):
        x = _encoder_layer(x, layer_slice(params["layers"], i), cfg, attn_impl)
    if cfg.select_feature == "patch":
        return x[:, 1:]
    if cfg.select_feature == "cls_patch":
        return x
    raise ValueError(f"Unexpected select feature: {cfg.select_feature}")
