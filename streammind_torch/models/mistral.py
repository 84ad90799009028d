"""Decoder-only transformer (Mistral / Llama family, dense MLP).

Serves both the Mistral-7B decoder and the 4-layer, 2-way gate LM.  Layer
leaves are stacked on a leading (L,) axis and the forward loops over the
layers in Python.  The KV cache has a static capacity with length masking;
new K/V rows are written into it IN PLACE (the JAX package builds a new
cache with dynamic_update_slice on a donated buffer), so the cache a
caller passes in is updated by the call.  Cached prefill attends through
the hand-written flash kernel (``ops/attention.py::flash_attention``);
training (no cache, ``attn_impl="flash"``) through the differentiable
``flash_mha``, each layer rematerialized in the backward under
``remat=True``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import TextConfig
from ..ops.attention import _repeat_kv, attention, decode_attention, flash_attention
from ..ops.norms import rms_norm
from ..ops.rotary import apply_rope, rope_cos_sin
from ..utils.params import linear, normal_init, ones, unstack_layers


class KVCache(NamedTuple):
    """Static-capacity KV cache.

    k, v: (n_layers, B, capacity, n_kv_heads, head_dim)
    length: (B,) int32 — valid prefix length (shared across layers).
    """

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.k.shape[2]


def init_kv_cache(cfg: TextConfig, batch: int, capacity: int, dtype=torch.bfloat16,
                  device="cuda") -> KVCache:
    shape = (cfg.num_layers, batch, capacity, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def require_dense_decoder(cfg: TextConfig) -> None:
    """Raise for a decoder the port does not run yet: q/k/v biases (Qwen2)
    or experts (Mixtral)."""
    if cfg.num_experts > 1 or cfg.qkv_bias:
        raise NotImplementedError(
            "only the dense, bias-free decoder is ported; Qwen2 (qkv_bias) and Mixtral "
            "(num_experts > 1) wait for ROADMAP Queue 1 item 12, MoE and Qwen2")


def init_text_params(g: torch.Generator, cfg: TextConfig, device="cuda", dtype=torch.float32):
    """Random dense weights, stacked leaves generated at (L, ...) directly."""
    require_dense_decoder(cfg)
    d, L = cfg.hidden_size, cfg.num_layers
    kw = dict(device=device, dtype=dtype)
    params = {
        "embed_tokens": normal_init(g, (cfg.vocab_size, d), **kw),
        "layers": {
            "input_norm": {"weight": ones((L, d), **kw)},
            "q": {"weight": normal_init(g, (L, cfg.q_dim, d), **kw)},
            "k": {"weight": normal_init(g, (L, cfg.kv_dim, d), **kw)},
            "v": {"weight": normal_init(g, (L, cfg.kv_dim, d), **kw)},
            "o": {"weight": normal_init(g, (L, d, cfg.q_dim), **kw)},
            "post_norm": {"weight": ones((L, d), **kw)},
            "mlp": {
                "gate": {"weight": normal_init(g, (L, cfg.intermediate_size, d), **kw)},
                "up": {"weight": normal_init(g, (L, cfg.intermediate_size, d), **kw)},
                "down": {"weight": normal_init(g, (L, d, cfg.intermediate_size), **kw)},
            },
        },
        "final_norm": {"weight": ones((d,), **kw)},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"weight": normal_init(g, (cfg.vocab_size, d), **kw)}
    return params


def embed_tokens(params, input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed_tokens"][input_ids]


# Concat axes for fusing linear leaves along the OUTPUT dim of stacked
# (L, out, in) trees; packed int4 leaves pack along the input dim, so their
# out axis is still -2; per-channel scales and biases are (L, out), group
# scales (L, out, groups).
_FUSE_AXES = {"weight": -2, "w_int8": -2, "w_int4": -2, "w_int4pc": -2,
              "scale": -1, "scale4": -2, "bias": -1}


def _fuse_leaves(leaves):
    """Row-concat same-scheme linear leaves, or None if not fusable."""
    keys = set(leaves[0])
    if any(set(l) != keys for l in leaves[1:]) or not keys <= set(_FUSE_AXES):
        return None
    return {k: torch.cat([l[k] for l in leaves], dim=_FUSE_AXES[k]) for k in keys}


def fuse_text_linears(text_params: dict) -> dict:
    """Serving fusion: q/k/v → one "qkv" leaf and mlp gate/up → one
    "gateup" leaf, rows concatenated along the output dim (each output is
    the same dot as before).  The gate LM's tree must NOT be fused: its
    single-token shortcut reads only v.  A tree with LoRA factors attached
    (``train/lora.py::attach_lora``) is refused: a fused leaf would drop
    them."""
    out = dict(text_params)
    layers = dict(out["layers"])
    if any("lora_a" in leaf for leaf in (*layers.values(), *layers.get("mlp", {}).values())
           if isinstance(leaf, dict)):
        raise ValueError("fuse_text_linears: the tree carries LoRA factors (attach_lora); "
                         "merge them first (train/lora.py::apply_lora)")
    if all(k in layers for k in ("q", "k", "v")):
        fused = _fuse_leaves([layers["q"], layers["k"], layers["v"]])
        if fused is not None:
            layers["qkv"] = fused
            del layers["q"], layers["k"], layers["v"]
    if "mlp" in layers and "gate" in layers["mlp"]:
        mlp = dict(layers["mlp"])
        fused = _fuse_leaves([mlp["gate"], mlp["up"]])
        if fused is not None:
            mlp["gateup"] = fused
            del mlp["gate"], mlp["up"]
            layers["mlp"] = mlp
    out["layers"] = layers
    return out


def qkv_proj(x, lp, cfg: TextConfig):
    """(q, k, v) heads from either the separate or the fused layout."""
    b, s, _ = x.shape
    if "qkv" in lp:
        qkv = linear(x, lp["qkv"])
        q = qkv[..., : cfg.q_dim]
        k = qkv[..., cfg.q_dim: cfg.q_dim + cfg.kv_dim]
        v = qkv[..., cfg.q_dim + cfg.kv_dim:]
    else:
        q, k, v = linear(x, lp["q"]), linear(x, lp["k"]), linear(x, lp["v"])
    return (
        q.reshape(b, s, cfg.num_heads, cfg.head_dim),
        k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim),
        v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim),
    )


def _mlp(x, lp, cfg: TextConfig):
    mlp = lp["mlp"]
    if "gateup" in mlp:
        gu = linear(x, mlp["gateup"])
        g, u = gu[..., : cfg.intermediate_size], gu[..., cfg.intermediate_size:]
        return linear(F.silu(g) * u, mlp["down"])
    return linear(F.silu(linear(x, mlp["gate"])) * linear(x, mlp["up"]), mlp["down"])


def _write_cache(cache_l: torch.Tensor, new: torch.Tensor, start: torch.Tensor) -> None:
    """In-place write of new (B, S, Hkv, D) rows at per-row ``start`` into one
    layer's cache (B, C, Hkv, D).  The start is clamped so the block fits,
    as dynamic_update_slice clamps it in the JAX package."""
    b, s = new.shape[:2]
    start = torch.clamp(start.long(), max=cache_l.shape[1] - s)
    pos = start[:, None] + torch.arange(s, device=new.device)[None, :]
    rows = torch.arange(b, device=new.device)[:, None].expand(b, s)
    cache_l[rows, pos] = new.to(cache_l.dtype)


def _attn_block(x, lp, cfg: TextConfig, positions, kv_mask, cache_k, cache_v, cache_len,
                attn_impl):
    """One attention sub-block.  With a cache (one layer's (B, C, Hkv, D) k and
    v), the new K/V are written at cache_len and attention runs over the
    cache; else causal self-attention over the block."""
    b, s, _ = x.shape
    if cache_k is None and s == 1 and kv_mask is None and "v" in lp:
        # Single-token self-attention (the streaming gate LM's shape): the
        # softmax over one logit is exactly 1, so the output is v itself —
        # the q/k projections and rope drop out and are never read.
        v = linear(x, lp["v"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
        o = _repeat_kv(v, cfg.num_heads // cfg.num_kv_heads)
        return linear(o.reshape(b, s, cfg.q_dim), lp["o"])
    q, k, v = qkv_proj(x, lp, cfg)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cache_k is not None:
        _write_cache(cache_k, k, cache_len)
        _write_cache(cache_v, v, cache_len)
        total_len = cache_len + s
        if s == 1:
            o = decode_attention(q, cache_k, cache_v, total_len)
        else:
            # prefill: causal inside the block, the whole prefix visible,
            # nothing past total_len — the kernel reads the cache in place
            o = flash_attention(q, cache_k.to(q.dtype), cache_v.to(q.dtype), causal=True,
                                kv_len=total_len, q_offset=cache_len)
    else:
        o = attention(q, k, v, causal=True, kv_mask=kv_mask, impl=attn_impl)
    return linear(o.reshape(b, s, cfg.q_dim), lp["o"])


def _layer(x, lp, cfg: TextConfig, positions, attn_mask, attn_impl):
    """One decoder layer without a cache (the training and gate shape)."""
    y = rms_norm(x, lp["input_norm"]["weight"], cfg.rms_norm_eps)
    x = x + _attn_block(y, lp, cfg, positions, attn_mask, None, None, None, attn_impl)
    y = rms_norm(x, lp["post_norm"]["weight"], cfg.rms_norm_eps)
    return x + _mlp(y, lp, cfg)


def text_forward(
    params,
    cfg: TextConfig,
    input_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    attn_mask: Optional[torch.Tensor] = None,  # (B, S) bool padding mask
    positions: Optional[torch.Tensor] = None,  # (B, S) int
    cache: Optional[KVCache] = None,
    cache_advance: Optional[torch.Tensor] = None,
    attn_impl: str = "auto",
    return_hidden: bool = False,
    remat: bool = False,
):
    """Forward over a token block.

    ``remat`` (no cache): per-layer rematerialization — each layer runs
    under ``torch.utils.checkpoint`` (non-reentrant), so its activations are
    recomputed in the backward and only the layer inputs stay alive (the
    JAX package's ``jax.checkpoint`` on the layer body).

    Without a cache: causal self-attention over the block.  With a cache:
    the block is written at cache.length (prefill, or one decode token) and
    attends to the whole valid prefix; the cache tensors are updated in
    place and a KVCache with the advanced length is returned.
    cache_advance (B,) — how far to advance the length (default: the block
    size); right-padded prefill blocks pass their real length, so the pad
    rows are overwritten by the next block.
    """
    x = inputs_embeds if inputs_embeds is not None else embed_tokens(params, input_ids)
    b, s, _ = x.shape
    if positions is None:
        base = cache.length[:, None] if cache is not None else torch.zeros(
            (b, 1), dtype=torch.int32, device=x.device)
        positions = base + torch.arange(s, device=x.device)[None, :]
    for i, lp in enumerate(unstack_layers(params["layers"], cfg.num_layers)):
        if cache is None:
            if remat:
                x = checkpoint(_layer, x, lp, cfg, positions, attn_mask, attn_impl,
                               use_reentrant=False)
            else:
                x = _layer(x, lp, cfg, positions, attn_mask, attn_impl)
            continue
        y = rms_norm(x, lp["input_norm"]["weight"], cfg.rms_norm_eps)
        x = x + _attn_block(y, lp, cfg, positions, attn_mask, cache.k[i], cache.v[i],
                            cache.length, attn_impl)
        y = rms_norm(x, lp["post_norm"]["weight"], cfg.rms_norm_eps)
        x = x + _mlp(y, lp, cfg)
    new_cache = None
    if cache is not None:
        advance = cache_advance if cache_advance is not None else s
        new_cache = KVCache(k=cache.k, v=cache.v, length=cache.length + advance)
    x = rms_norm(x, params["final_norm"]["weight"], cfg.rms_norm_eps)
    if return_hidden:
        return x, new_cache
    return lm_head(params, cfg, x), new_cache


def lm_head(params, cfg: TextConfig, hidden: torch.Tensor) -> torch.Tensor:
    w = params["embed_tokens"] if cfg.tie_word_embeddings else params["lm_head"]["weight"]
    return (hidden @ w.T.to(hidden.dtype)).float()
