"""Decoder-only transformer: Mistral / Llama, Qwen2 (q/k/v biases) and
Mixtral (sparse MoE).

Serves the Mistral-7B, Qwen2-7B and Mixtral-8x7B decoders and the 4-layer,
2-way gate LM.  Layer leaves are stacked on a leading (L,) axis and the
forward loops over the layers in Python.  The KV cache has a static
capacity with length masking; new K/V rows are written into it IN PLACE
(the JAX package builds a new cache with dynamic_update_slice on a donated
buffer), so the cache a caller passes in is updated by the call.  Cached prefill attends through
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
from ..utils.params import fill_layers, linear, normal_init, ones, unstack_layers, zeros


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


def init_text_params(g: torch.Generator, cfg: TextConfig, device="cuda", dtype=torch.float32,
                     layer_fn=None):
    """Random weights, stacked leaves generated at (L, ...) directly.  Qwen2
    (``qkv_bias``) gets zero q/k/v biases; Mixtral (``num_experts > 1``) a
    router and (L, E, F, D) expert banks in place of the MLP.

    ``layer_fn`` draws the layer leaves one layer at a time instead: each
    layer's tree (leaves with a leading axis of 1) goes through ``layer_fn``
    (a quantizer, say) and is written into stacked leaves allocated from the
    first result, so one layer's full-precision weights live at a time (a
    bf16 Mixtral-8x7B is 93 GB, its int4 tree 24 GB).  The draws come in
    another order than the stacked ones, so the values differ."""
    d, L = cfg.hidden_size, cfg.num_layers
    kw = dict(device=device, dtype=dtype)
    params = {"embed_tokens": normal_init(g, (cfg.vocab_size, d), **kw)}
    if layer_fn is None:
        params["layers"] = _init_layers(g, cfg, L, kw)
    else:
        params["layers"] = fill_layers(L, lambda i: layer_fn(_init_layers(g, cfg, 1, kw)))
    params["final_norm"] = {"weight": ones((d,), **kw)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"weight": normal_init(g, (cfg.vocab_size, d), **kw)}
    return params


def _init_layers(g: torch.Generator, cfg: TextConfig, L: int, kw: dict) -> dict:
    d, E, F_ = cfg.hidden_size, cfg.num_experts, cfg.intermediate_size
    layers = {
        "input_norm": {"weight": ones((L, d), **kw)},
        "q": {"weight": normal_init(g, (L, cfg.q_dim, d), **kw)},
        "k": {"weight": normal_init(g, (L, cfg.kv_dim, d), **kw)},
        "v": {"weight": normal_init(g, (L, cfg.kv_dim, d), **kw)},
        "o": {"weight": normal_init(g, (L, d, cfg.q_dim), **kw)},
        "post_norm": {"weight": ones((L, d), **kw)},
    }
    if cfg.qkv_bias:  # Qwen2 puts biases on q/k/v only (not o)
        layers["q"]["bias"] = zeros((L, cfg.q_dim), **kw)
        layers["k"]["bias"] = zeros((L, cfg.kv_dim), **kw)
        layers["v"]["bias"] = zeros((L, cfg.kv_dim), **kw)
    if E > 1:
        layers["router"] = {"weight": normal_init(g, (L, E, d), **kw)}
        layers["experts"] = {"gate": normal_init(g, (L, E, F_, d), **kw),
                             "up": normal_init(g, (L, E, F_, d), **kw),
                             "down": normal_init(g, (L, E, d, F_), **kw)}
    else:
        layers["mlp"] = {"gate": {"weight": normal_init(g, (L, F_, d), **kw)},
                         "up": {"weight": normal_init(g, (L, F_, d), **kw)},
                         "down": {"weight": normal_init(g, (L, d, F_), **kw)}}
    return layers


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


def _mlp(x, lp, cfg: TextConfig, moe_dispatch=None):
    if cfg.num_experts > 1:
        return _moe_mlp(x, lp, cfg, moe_dispatch)
    mlp = lp["mlp"]
    if "gateup" in mlp:
        gu = linear(x, mlp["gateup"])
        g, u = gu[..., : cfg.intermediate_size], gu[..., cfg.intermediate_size:]
        return linear(F.silu(g) * u, mlp["down"])
    return linear(F.silu(linear(x, mlp["gate"])) * linear(x, mlp["up"]), mlp["down"])


_MOE_GATHER_MAX_TOKENS = 4


def _wrap_expert_leaf(leaf):
    """Expert banks are raw (E, F, D) tensors at init and {"w_int8" /
    "w_int4" / "w_int4pc", scale} dicts once quantized: as linear() leaves."""
    return leaf if isinstance(leaf, dict) else {"weight": leaf}


def _expert(bank: dict, e: int) -> dict:
    """Expert ``e``'s (F, ·) slice of every leaf of a bank: contiguous views at
    offsets of whole rows, which the matvec kernels take as they are."""
    return {k: v[e] for k, v in bank.items()}


def router_top_k(probs: torch.Tensor, k: int):
    """The k largest router probs of each row and their expert ids, ties to
    the lowest id (``jax.lax.top_k``'s rule; ``torch.topk`` promises no
    order among ties on CUDA, and bf16 router logits tie often): the first k
    of a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _moe_mlp(x, p, cfg: TextConfig, dispatch=None):
    """Mixtral's sparse MoE: the router in the working dtype, an fp32
    softmax, the top k experts renormalized (HF MixtralSparseMoeBlock).

    Dispatch, by token count T = B*S and bank kind:
      - T <= _MOE_GATHER_MAX_TOKENS (decode): each token runs its k experts'
        slices through ``linear``, so on the card int8 / per-channel int4
        slices reach the matvec kernels and only k/E of the expert bytes
        are read;
      - quantized banks: every expert over every token, weighted by its
        routing weight (zero where unrouted), each through ``linear``;
      - plain banks: rows sorted stably by expert, one matmul per expert's
        contiguous row block (what ``lax.ragged_dot`` computes in the JAX
        package), k/E of the dense products; differentiable.
    ``dispatch``: None (one device: grouped), "dense" or "grouped"; a mesh
    raises (``_resolve_moe_dispatch``)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    router_logits = xt @ p["router"]["weight"].T.to(xt.dtype)  # (T, E)
    probs = torch.softmax(router_logits.float(), dim=-1)
    topw, topi = router_top_k(probs, cfg.num_experts_per_tok)
    topw = topw / topw.sum(dim=-1, keepdim=True)
    banks = tuple(_wrap_expert_leaf(p["experts"][n]) for n in ("gate", "up", "down"))
    if b * s <= _MOE_GATHER_MAX_TOKENS:
        return _moe_apply_gathered(xt, banks, cfg, topi, topw).reshape(b, s, d)
    mode = _resolve_moe_dispatch(dispatch, cfg)
    plain = all(not isinstance(p["experts"][n], dict) for n in ("gate", "up", "down"))
    if mode == "grouped" and plain:
        out = _moe_apply_grouped(xt, p["experts"], cfg, topi, topw)
    else:
        out = _moe_apply_dense(xt, banks, cfg, topi, topw)
    return out.reshape(b, s, d)


def _resolve_moe_dispatch(dispatch, cfg: TextConfig) -> str:
    """None (one device) → "grouped"; "dense" and "grouped" as asked.  The
    JAX package's expert-parallel form over a mesh ("sharded_grouped") is
    not ported."""
    if dispatch is None:
        return "grouped"
    if dispatch in ("dense", "grouped"):
        return dispatch
    raise NotImplementedError(
        f"MoE dispatch {dispatch!r}: the expert-parallel dispatch over a mesh is not ported "
        "(ROADMAP Queue 1 item 17, parallelism); pass None, 'dense' or 'grouped'")


def _moe_apply_dense(xt, banks, cfg: TextConfig, topi, topw):
    """Every expert over every token, weighted by its routing weight (zero
    where unrouted), summed in expert order.  E/k times the products of the
    grouped form, but each through ``linear``, so quantized banks work."""
    combine = torch.zeros((xt.shape[0], cfg.num_experts), dtype=topw.dtype,
                          device=xt.device).scatter_add_(1, topi, topw)  # (T, E)
    out = torch.zeros_like(xt)
    for e in range(cfg.num_experts):
        gw, uw, dw = (_expert(bank, e) for bank in banks)
        y = linear(F.silu(linear(xt, gw)) * linear(xt, uw), dw)
        out = out + y * combine[:, e, None].to(xt.dtype)
    return out


def _moe_apply_grouped(xt, experts, cfg: TextConfig, topi, topw):
    """Sort-by-expert dispatch over plain banks: every (token, expert) pair
    is one row of a (T*k, D) matrix sorted stably by expert id, and each
    expert's contiguous row block goes through that expert's weights (one
    torch.matmul each).  Exact (no token is dropped).  Each token's k
    weighted outputs are put back in (token, slot) order and summed over
    the slots, so the sum's order does not depend on the device."""
    T, d = xt.shape
    k = cfg.num_experts_per_tok
    flat_e = topi.reshape(-1)                              # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    xs = xt[order // k]                                    # (T*k, D) by expert
    sizes = torch.bincount(flat_e, minlength=cfg.num_experts).tolist()
    ys, start = [], 0
    for e, n in enumerate(sizes):
        if n:
            rows = xs[start:start + n]
            g = rows @ experts["gate"][e].T.to(xt.dtype)
            u = rows @ experts["up"][e].T.to(xt.dtype)
            ys.append((F.silu(g) * u) @ experts["down"][e].T.to(xt.dtype))
            start += n
    y = torch.cat(ys) * topw.reshape(-1)[order].to(xt.dtype)[:, None]
    return y[torch.argsort(order)].reshape(T, k, d).sum(dim=1)


def _moe_apply_gathered(xt, banks, cfg: TextConfig, topi, topw):
    """Top-k gather for a few tokens: each token runs its k experts' slices
    (``_expert``) through ``linear``, one token at a time.  The expert ids
    are read on the host, once a layer."""
    out = []
    for x_row, ids, wts in zip(xt, topi.tolist(), topw):
        y = torch.zeros_like(x_row)
        for j, e in enumerate(ids):
            gw, uw, dw = (_expert(bank, e) for bank in banks)
            g = F.silu(linear(x_row[None], gw))[0]
            u = linear(x_row[None], uw)[0]
            y = y + linear((g * u)[None], dw)[0] * wts[j].to(x_row.dtype)
        out.append(y)
    return torch.stack(out)


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


def _layer(x, lp, cfg: TextConfig, positions, attn_mask, attn_impl, moe_dispatch=None):
    """One decoder layer without a cache (the training and gate shape)."""
    y = rms_norm(x, lp["input_norm"]["weight"], cfg.rms_norm_eps)
    x = x + _attn_block(y, lp, cfg, positions, attn_mask, None, None, None, attn_impl)
    y = rms_norm(x, lp["post_norm"]["weight"], cfg.rms_norm_eps)
    return x + _mlp(y, lp, cfg, moe_dispatch)


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
    moe_dispatch=None,
):
    """Forward over a token block.

    ``moe_dispatch`` (Mixtral): None (one device, the grouped form), "dense"
    or "grouped" (``_moe_mlp``).

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
                               moe_dispatch, use_reentrant=False)
            else:
                x = _layer(x, lp, cfg, positions, attn_mask, attn_impl, moe_dispatch)
            continue
        y = rms_norm(x, lp["input_norm"]["weight"], cfg.rms_norm_eps)
        x = x + _attn_block(y, lp, cfg, positions, attn_mask, cache.k[i], cache.v[i],
                            cache.length, attn_impl)
        y = rms_norm(x, lp["post_norm"]["weight"], cfg.rms_norm_eps)
        x = x + _mlp(y, lp, cfg, moe_dispatch)
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
