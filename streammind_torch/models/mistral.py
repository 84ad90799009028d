"""Decoder-only transformer: Mistral / Llama, Qwen2 (q/k/v biases),
Mixtral (sparse MoE) and Jamba's Mamba and attention hybrid (``jamba.py``).

Layer leaves are stacked on a leading (L,) axis, and ``decoder_forward``,
the one loop over the layers, runs every decoder over a store: the dense
ring (``KVCache``), the page pool (``streaming/paged.py``), or none
(training, the gate LM).  The ring has a static capacity with length
masking; new K/V rows are written into it IN PLACE (the JAX package builds
a new cache with dynamic_update_slice on a donated buffer), so the cache a
caller passes in is updated by the call.  Cached prefill attends through
the hand-written flash kernel (``ops/attention.py::flash_attention``);
training (no cache, ``attn_impl="flash"``) through the differentiable
``flash_mha``, each layer rematerialized in the backward under
``remat=True``.

Under a mesh (``parallel/mesh.py::set_mesh``) the layers run on the rank's
shards (``parallel/partitioning.py``): q, k, v, gate and up are
column-parallel (this rank's heads and channels), o and down row-parallel
(summed over tp), the embedding and the lm head vocab-parallel, the fsdp
dims gathered at use; ``sequence_axis`` keeps the activations between
blocks sharded along S; Mixtral's experts split over tp.  A mesh whose
every axis has size 1 runs the one-device code.
"""
from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import TextConfig
from ..ops.attention import _repeat_kv, attention, decode_attention, flash_attention
from ..ops import int4_grouped_gemm as grouped_int4
from ..ops.int4_matvec import int4_matvec
from ..ops.norms import rms_norm
from ..ops.rotary import apply_rope, rope_cos_sin
from ..parallel import collectives as C
from ..parallel.mesh import ambient_mesh, axis_index, axis_size, is_trivial
from ..parallel.partitioning import row_linear, spec_for, use_leaf, use_linear
from ..utils.params import fill_layers, linear, normal_init, ones, unstack_layers, zeros
from ..utils.profiling import tracer
from . import jamba


class KVCache(NamedTuple):
    """Static-capacity KV cache: the dense ring, one of the decoder's stores
    (``decoder_forward``).

    k, v: (n_layers, B, capacity, n_kv_heads, head_dim)
    length: (B,) int32 — valid prefix length (shared across layers).
    """

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.k.shape[2]

    def attend(self, j: int, q, k, v):
        """Layer j's (B, S, Hkv, D) K/V written in place at ``length``, clamped
        so the block fits (as in the JAX package), then q over the valid
        prefix: ``decode_attention`` for a token, the flash kernel for a block."""
        b, s = k.shape[:2]
        start = torch.clamp(self.length.long(), max=self.capacity - s)
        pos = start[:, None] + torch.arange(s, device=k.device)[None, :]
        rows = torch.arange(b, device=k.device)[:, None].expand(b, s)
        cache_k, cache_v = self.k[j], self.v[j]
        cache_k[rows, pos] = k.to(cache_k.dtype)
        cache_v[rows, pos] = v.to(cache_v.dtype)
        total_len = self.length + s
        if s == 1:
            return decode_attention(q, cache_k, cache_v, total_len)
        return flash_attention(q, cache_k.to(q.dtype), cache_v.to(q.dtype), causal=True,
                               kv_len=total_len, q_offset=self.length)


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
    another order than the stacked ones, so the values differ.

    A hybrid decoder (``cfg.hybrid``) gets ``models/jamba.py``'s layout:
    each kind's leaves stacked over the layers of that kind."""
    d, L = cfg.hidden_size, cfg.num_layers
    kw = dict(device=device, dtype=dtype)
    params = {"embed_tokens": normal_init(g, (cfg.vocab_size, d), **kw)}
    if cfg.hybrid:
        if layer_fn is not None:
            raise ValueError("init_text_params: layer_fn draws identical layers; a hybrid "
                             "decoder's kinds are stacked apart")
        params["layers"] = jamba.init_hybrid_layers(g, cfg, kw)
    elif layer_fn is None:
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


def embed_tokens(params, input_ids: torch.Tensor, path: str = "text") -> torch.Tensor:
    """Token embeddings.  Under a mesh whose rule puts the vocab on tp (the
    decoder's), each rank looks up the ids in its rows, zeros the others,
    and the ranks' lookups are summed (vocab-parallel embedding)."""
    mesh = ambient_mesh()
    if is_trivial(mesh):
        return params["embed_tokens"][input_ids]
    w = use_leaf(params["embed_tokens"], f"{path}.embed_tokens", mesh=mesh)
    if spec_for(f"{path}.embed_tokens", 2)[:1] != ("tp",):
        return w[input_ids]
    rows = w.shape[0]
    local = input_ids - axis_index(mesh, "tp") * rows
    inside = (local >= 0) & (local < rows)
    emb = w[torch.where(inside, local, 0)] * inside[..., None].to(w.dtype)
    return C.reduce_from_tp(emb, mesh)


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


def qkv_proj(x, lp, cfg: TextConfig, path: str = "text"):
    """This rank's (q, k, v) heads from either the separate or the fused
    layout: every head with no mesh; under one, q/k/v column-parallel (the
    rank's heads, ``_tp_heads``).  A fused leaf is the one-device layout."""
    mesh = ambient_mesh()
    b, s, _ = x.shape
    h, hkv, kv_head = _tp_heads(cfg, mesh)
    L = f"{path}.layers"
    if "qkv" in lp:
        _unfused_under(mesh, "q/k/v")
        qkv = linear(x, lp["qkv"])
        q = qkv[..., : cfg.q_dim]
        k = qkv[..., cfg.q_dim: cfg.q_dim + cfg.kv_dim]
        v = qkv[..., cfg.q_dim + cfg.kv_dim:]
    else:
        q = linear(x, use_linear(lp["q"], f"{L}.q", "col", 1, mesh))
        k = _kv_proj(x, lp, "k", L, cfg, mesh, kv_head)
        v = _kv_proj(x, lp, "v", L, cfg, mesh, kv_head)
    return (
        q.reshape(b, s, h, cfg.head_dim),
        k.reshape(b, s, hkv, cfg.head_dim),
        v.reshape(b, s, hkv, cfg.head_dim),
    )


def _mlp(x, lp, cfg: TextConfig, path: str = "text", seq: bool = False):
    """The MLP, or Mixtral's MoE.  Under a mesh gate/up are column- and down
    row-parallel (the rank's channels), the MoE over the rank's experts;
    ``seq``: x is this rank's S shard (``text_forward(sequence_axis=)``)."""
    mesh = ambient_mesh()
    if "router" in lp:
        xin = C.gather(x, mesh, "tp", 1, bwd="slice") if seq else x
        out = _moe_mlp(xin, lp, cfg, path)
        return C.scatter(out, mesh, "tp", 1) if seq else out
    mlp, L = lp["mlp"], f"{path}.layers.mlp"
    x = _tp_enter(x, mesh, seq)
    if "gateup" in mlp:
        _unfused_under(mesh, "gate/up")
        gu = linear(x, mlp["gateup"])
        g, u = gu[..., : cfg.intermediate_size], gu[..., cfg.intermediate_size:]
    else:
        g = linear(x, use_linear(mlp["gate"], f"{L}.gate", "col", 1, mesh))
        u = linear(x, use_linear(mlp["up"], f"{L}.up", "col", 1, mesh))
    return row_linear(F.silu(g) * u, mlp["down"], f"{L}.down", 1,
                      sequence_dim=1 if seq else None)


def _unfused_under(mesh, what: str) -> None:
    if not is_trivial(mesh):
        raise ValueError(f"a fused {what} leaf under a mesh: shard the unfused tree")


# the output dim of each key of a linear's leaf dict
_OUT_DIM = {"weight": -2, "w_int8": -2, "w_int4": -2, "w_int4pc": -2, "scale": -1,
            "scale4": -2, "bias": -1, "lora_b": -2}


def _tp_heads(cfg: TextConfig, mesh):
    """(this rank's q heads, its kv heads, the kv head it reads where tp
    exceeds the kv heads, else None).  Past the kv heads each rank holds the
    one kv head its q heads read, so k and v repeat over tp/Hkv ranks."""
    tp = axis_size(mesh, "tp")
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    if H % tp or (Hkv % tp and tp % Hkv):
        raise ValueError(f"tp={tp} does not split {H} heads over {Hkv} kv heads")
    h = H // tp
    if Hkv % tp == 0:
        return h, Hkv // tp, None
    return h, 1, axis_index(mesh, "tp") * h // (H // Hkv)


def _kv_proj(x, lp, name: str, L: str, cfg: TextConfig, mesh, kv_head):
    """This rank's k or v heads: a column shard (all of them with no mesh),
    or past the kv heads the gathered weight's rows of the one head it
    reads (the backward sums the ranks' shares into the stored shards)."""
    if kv_head is None:
        return linear(x, use_linear(lp[name], f"{L}.{name}", "col", 1, mesh))
    full = use_linear(lp[name], f"{L}.{name}", "full", 1, mesh)
    lo = kv_head * cfg.head_dim
    rows = {k: t.narrow(_OUT_DIM[k] % t.dim(), lo, cfg.head_dim) if k in _OUT_DIM else t
            for k, t in full.items()}
    return linear(x, rows)


def _tp_enter(y, mesh, seq: bool):
    """The input of a column-parallel product: under sequence parallelism
    the S shards gathered (the backward reduce-scattered), else y as it is
    (the backward all-reduced over tp; nothing with no mesh)."""
    return C.gather(y, mesh, "tp", 1, bwd="sum") if seq else C.copy_to_tp(y, mesh)


_MOE_GATHER_MAX_TOKENS = 4


def _wrap_expert_leaf(leaf):
    """Expert banks are raw (E, F, D) tensors at init and {"w_int8" /
    "w_int4" / "w_int4pc", scale} dicts once quantized: as linear() leaves."""
    return leaf if isinstance(leaf, dict) else {"weight": leaf}


def _expert(bank: dict, e: int) -> dict:
    """Expert ``e``'s (F, ·) slice of every leaf of a bank: contiguous views at
    offsets of whole rows, which the matvec kernels take as they are."""
    return {k: v[e] for k, v in bank.items()}


_routing = threading.local()


@contextlib.contextmanager
def routing_breaks(fn):
    """Inside the block, on this thread, each MoE layer hands its router's
    fp32 softmax (T, E) to ``fn(probs, k)`` in place of ``router_top_k``
    and takes the (weights, ids) it returns: where a CUDA graph of a decode
    step breaks at the routing (``streaming/paged.py``)."""
    prev = getattr(_routing, "fn", None)
    _routing.fn = fn
    try:
        yield
    finally:
        _routing.fn = prev


def router_top_k(probs: torch.Tensor, k: int):
    """The k largest router probs of each row and their expert ids, ties to
    the lowest id (``jax.lax.top_k``'s rule; ``torch.topk`` promises no
    order among ties on CUDA, and bf16 router logits tie often): the first k
    of a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _moe_mlp(x, p, cfg: TextConfig, path: str = "text"):
    """Mixtral's sparse MoE: the router in the working dtype, an fp32
    softmax, the top k experts renormalized (HF MixtralSparseMoeBlock);
    where ``cfg.norm_topk_prob`` is False (Jamba's JambaSparseMoeBlock),
    the top k probabilities weight the experts as they are.

    The form, from T = B*S, the banks, device, dtype, autograd and mesh:
      - T <= _MOE_GATHER_MAX_TOKENS (decode): each token runs its k experts'
        slices through ``linear``, so on the card int8 / per-channel int4
        slices reach the matvec kernels and only k/E of the expert bytes
        are read; the gather skips other ranks' experts, so under a mesh
        with autograd on (every rank's backward must run the same
        collectives) a few tokens take the forms below;
      - plain banks, where ``_resolve_moe_dispatch`` allows: rows sorted
        stably by expert, one matmul per expert's row block (JAX's
        ``lax.ragged_dot``), k/E of the dense products; differentiable;
      - off a mesh, ``_grouped_int4`` (per-channel int4 banks, bf16 on the
        card, no gradient asked of x): the grouped int4 kernel pair;
      - else every expert over every token, weighted by its routing weight
        (zero where unrouted), each through ``linear``.
    Under a mesh each rank holds E/tp experts (expert parallel), runs the
    chosen form over them alone, and the ranks' outputs are summed over tp."""
    b, s, d = x.shape
    mesh = ambient_mesh()
    xt = x.reshape(b * s, d)
    router = p["router"]["weight"]
    one = is_trivial(mesh)
    if not one:
        router = use_leaf(router, f"{path}.layers.router.weight", 1, mesh)
    router_logits = xt @ router.T.to(xt.dtype)  # (T, E)
    probs = torch.softmax(router_logits.float(), dim=-1)
    brk = getattr(_routing, "fn", None)
    topw, topi = (router_top_k if brk is None else brk)(probs, cfg.num_experts_per_tok)
    if cfg.norm_topk_prob:
        topw = topw / topw.sum(dim=-1, keepdim=True)
    tp = axis_size(mesh, "tp")
    if cfg.num_experts % tp:
        raise ValueError(f"tp={tp} does not split {cfg.num_experts} experts")
    few = b * s <= _MOE_GATHER_MAX_TOKENS and (one or not torch.is_grad_enabled())
    experts = p["experts"]
    plain = all(not isinstance(experts[n], dict) for n in ("gate", "up", "down"))
    if plain and not few and _resolve_moe_dispatch(mesh, cfg) != "dense":
        return _moe_apply_grouped_sharded(xt, experts, cfg, topi, topw, mesh,
                                          f"{path}.layers.experts").reshape(b, s, d)
    banks = tuple(_wrap_expert_leaf(experts[n]) for n in ("gate", "up", "down"))
    if not one:  # this rank's E/tp experts, the fsdp dims gathered at use
        banks = tuple({k: use_leaf(t, f"{path}.layers.experts.{n}" + f".{k}" * (k != "weight"),
                                   1, mesh, tp_dim=0) for k, t in leaf.items()}
                      for n, leaf in zip(("gate", "up", "down"), banks))
    lo = axis_index(mesh, "tp") * (cfg.num_experts // tp)
    xt, topw = C.copy_to_tp(xt, mesh), C.copy_to_tp(topw, mesh)
    if few:
        out = _moe_apply_gathered(xt, banks, cfg, topi, topw, lo=lo)
    elif one and _grouped_int4(banks, xt, cfg):
        out = _moe_apply_grouped_int4(xt, banks, cfg, topi, topw)
    else:
        out = _moe_apply_dense(xt, banks, cfg, topi, topw, lo=lo)
    return C.reduce_from_tp(out, mesh).reshape(b, s, d)


def _resolve_moe_dispatch(mesh, cfg: TextConfig):
    """The MoE form plain banks may take under ``mesh`` (None: the ambient
    one): "grouped" | ("sharded_grouped", mesh) | "dense", with the JAX
    package's guards: tp 1 takes the grouped form; E % tp == 0 and E/tp > k
    the expert-parallel grouped form; anything else the dense one."""
    mesh = mesh if mesh is not None else ambient_mesh()
    tp = axis_size(mesh, "tp")
    if tp == 1:
        return "grouped"
    e_loc, rem = divmod(cfg.num_experts, tp)
    if rem == 0 and e_loc > cfg.num_experts_per_tok:
        return ("sharded_grouped", mesh)
    return "dense"


def _moe_apply_dense(xt, banks, cfg: TextConfig, topi, topw, lo: int = 0):
    """Every expert of the banks over every token, weighted by its routing
    weight (zero where unrouted), summed in expert order.  E/k times the
    products of the grouped form, but each through ``linear``, so quantized
    banks work.  The banks hold experts lo, lo+1, ... (a rank's share)."""
    tracer.count("moe.dense")
    combine = torch.zeros((xt.shape[0], cfg.num_experts), dtype=topw.dtype,
                          device=xt.device).scatter_add(1, topi, topw)  # (T, E)
    out = torch.zeros_like(xt)
    for e in range(next(iter(banks[0].values())).shape[0]):
        gw, uw, dw = (_expert(bank, e) for bank in banks)
        y = linear(F.silu(linear(xt, gw)) * linear(xt, uw), dw)
        out = out + y * combine[:, lo + e, None].to(xt.dtype)
    return out


def _moe_apply_grouped(xt, experts, cfg: TextConfig, topi, topw):
    """Sort-by-expert dispatch over plain banks: every (token, expert) pair
    is one row of a (T*k, D) matrix sorted stably by expert id, and each
    expert's contiguous row block goes through that expert's weights (one
    torch.matmul each).  Exact (no token is dropped).  Each token's k
    weighted outputs are put back in (token, slot) order and summed over
    the slots, so the sum's order does not depend on the device."""
    return _moe_grouped_local(xt, experts, cfg, topi, topw, 0, 1)


def _moe_grouped_local(xt, experts, cfg: TextConfig, topi, topw, index: int, tp: int):
    """Rank ``index`` of ``tp``'s share of the grouped dispatch: ``experts``
    holds its E/tp banks (experts index·E/tp, ...), the rows routed to them
    go through them, every other row is zero; summing the ``tp`` ranks'
    outputs gives the grouped dispatch (``tp`` 1: the whole of it)."""
    T, d = xt.shape
    k = cfg.num_experts_per_tok
    e_loc = cfg.num_experts // tp
    lo = index * e_loc
    flat_e = topi.reshape(-1)                              # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    sizes = torch.bincount(flat_e, minlength=cfg.num_experts).tolist()
    start = sum(sizes[:lo])
    stop = start + sum(sizes[lo:lo + e_loc])
    mine = order[start:stop]
    xs = xt[mine // k]                                     # this rank's rows, by expert
    ys, off = [], 0
    for j, n in enumerate(sizes[lo:lo + e_loc]):
        if n or tp > 1:  # under a mesh every bank joins the graph, so every
            rows = xs[off:off + n]  # rank's backward runs the same collectives
            g = rows @ experts["gate"][j].T.to(xt.dtype)
            u = rows @ experts["up"][j].T.to(xt.dtype)
            ys.append((F.silu(g) * u) @ experts["down"][j].T.to(xt.dtype))
            off += n
    y = torch.cat([xt.new_zeros((start, d)), *ys, xt.new_zeros((T * k - stop, d))])
    w = topw.reshape(-1)[order].to(xt.dtype)
    y = y * w[:, None]
    return y[torch.argsort(order)].reshape(T, k, d).sum(dim=1)


def _moe_apply_grouped_sharded(xt, experts, cfg: TextConfig, topi, topw, mesh,
                               path: str = "text.layers.experts"):
    """Expert-parallel grouped dispatch: ``experts`` are this rank's shards
    of one layer's banks (E/tp experts; the fsdp in-dim gathered here, the
    gather at use of ZeRO-3), the rank runs ``_moe_grouped_local`` over its
    experts, and one all-reduce over tp sums each row's k expert outputs
    from their owners.  Rows enter replicated over tp, so no token
    all-to-all is needed.  Differentiable: the backward all-reduces the
    rows' and routing weights' gradients over tp."""
    if is_trivial(mesh):
        return _moe_apply_grouped(xt, experts, cfg, topi, topw)
    tp = axis_size(mesh, "tp")
    ex = {n: use_leaf(experts[n], f"{path}.{n}", 1, mesh) for n in ("gate", "up", "down")}
    out = _moe_grouped_local(C.copy_to_tp(xt, mesh), ex, cfg, topi, C.copy_to_tp(topw, mesh),
                             axis_index(mesh, "tp"), tp)
    return C.reduce_from_tp(out, mesh)


def _ids_on_device(banks, dtype, device, n_experts: int, lo: int = 0) -> bool:
    """Whether a few tokens' experts run through the indexed int4 matvec,
    their ids read on the card: per-channel int4 banks that hold every
    expert (no other rank's share), bf16 activations on a CUDA device, the
    kernel's 16-byte rows."""
    return (device.type == "cuda" and dtype == torch.bfloat16 and lo == 0
            and all(set(b) == {"w_int4pc", "scale"} and b["w_int4pc"].shape[0] == n_experts
                    and b["w_int4pc"].shape[-1] % 16 == 0 for b in banks))


def _grouped_int4(banks, xt, cfg: TextConfig) -> bool:
    """Whether a prefill's experts run through the grouped int4 kernel pair:
    ``_ids_on_device``'s banks, device and dtype, no gradient asked of x,
    and widths the kernel takes."""
    if not _ids_on_device(banks, xt.dtype, xt.device, cfg.num_experts) or (
            torch.is_grad_enabled() and xt.requires_grad):
        return False
    f, d = banks[0]["w_int4pc"].shape[1], xt.shape[-1]
    return grouped_int4.fits(d, f) and grouped_int4.fits(f, d)


def _moe_apply_grouped_int4(xt, banks, cfg: TextConfig, topi, topw):
    """Sort-by-expert dispatch over per-channel int4 banks: the (T*k) rows
    sorted stably by expert id on the card (offsets by ``searchsorted``, so
    nothing of the routing reaches the host), one grouped launch for gate
    and up (h = silu(g) * u, never g and u in device memory) and one for
    down, whose epilogue weights each row by its routing weight and puts it
    back at its (token, slot) place; a token's k slots are then added in
    slot order.

    A divergence by design from ``_moe_apply_dense`` (and the JAX package,
    which keeps quantized banks dense): products exact and summed in fp32
    against the integer weights, the per-channel scale and the routing
    weight in fp32, h and each slot's y rounded to bf16 once; the dense
    form rounds each dequantized weight to bf16 and adds the experts in
    expert order with a bf16 rounding each."""
    tracer.count("moe.grouped_int4")
    T, d = xt.shape
    k = topi.shape[1]
    flat = topi.reshape(-1)
    order = torch.argsort(flat, stable=True)
    experts = torch.arange(cfg.num_experts + 1, device=flat.device, dtype=flat.dtype)
    offsets = torch.searchsorted(flat[order], experts, out_int32=True)
    xs = xt.index_select(0, order // k)
    (gw, gs), (uw, us), (dw, ds) = ((b["w_int4pc"], b["scale"]) for b in banks)
    h = grouped_int4.int4_grouped_gemm(xs, offsets, gw, gs, up=(uw, us))
    y = grouped_int4.int4_grouped_gemm(h, offsets, dw, ds, dst=order,
                                       row_weight=topw.reshape(-1)[order].float())
    return y.view(T, k, d).sum(dim=1)


def moe_ids_on_device(params, cfg: TextConfig, device) -> bool:
    """Whether a MoE decoder's decode steps on ``device`` keep their expert
    ids on the card (``_ids_on_device`` for the tree's banks and its
    embedding's dtype, the activations' dtype)."""
    ex = params["layers"]["experts"]
    banks = [{k: v[0] for k, v in _wrap_expert_leaf(ex[n]).items()}
             for n in ("gate", "up", "down")]   # layer 0's (E, ...) banks
    return _ids_on_device(banks, params["embed_tokens"].dtype, torch.device(device),
                          cfg.num_experts)


def _moe_apply_indexed(xt, banks, topi, topw):
    """The gathered dispatch with the ids left on the device: each (row,
    slot)'s gate, up and down launch the indexed int4 matvec over the whole
    bank, pointed at that id of ``topi``.  The launches, their order and the
    routing weights are the slice launches' of ``_moe_apply_gathered``, so
    on the card the outputs are theirs, bitwise."""
    tracer.count("moe.expert_id_reads", 0)
    ids = topi.contiguous()
    gw, uw, dw = ((b["w_int4pc"], b["scale"]) for b in banks)
    out = []
    for r, (x_row, wts) in enumerate(zip(xt, topw)):
        y = torch.zeros_like(x_row)
        for j in range(ids.shape[1]):
            e = ids[r, j:j + 1]
            g = F.silu(int4_matvec(x_row[None], *gw, expert=e))[0]
            u = int4_matvec(x_row[None], *uw, expert=e)[0]
            y = y + int4_matvec((g * u)[None], *dw, expert=e)[0] * wts[j].to(x_row.dtype)
        out.append(y)
    return torch.stack(out)


def _moe_apply_gathered(xt, banks, cfg: TextConfig, topi, topw, lo: int = 0):
    """Top-k gather for a few tokens: each token runs its k experts' slices
    (``_expert``) through ``linear``, one token at a time.  Where
    ``_ids_on_device`` (and no gradient is asked of x), the ids stay on the
    card (``_moe_apply_indexed``).  Elsewhere they are read on the host,
    once a layer; the banks hold experts lo, lo+1, ... and a token's other
    experts are skipped (another rank's)."""
    n_local = next(iter(banks[0].values())).shape[0]
    if _ids_on_device(banks, xt.dtype, xt.device, cfg.num_experts, lo) and not (
            torch.is_grad_enabled() and xt.requires_grad):
        return _moe_apply_indexed(xt, banks, topi, topw)
    with tracer.span("moe.expert_ids"):
        expert_ids = topi.tolist()
    tracer.count("moe.expert_id_reads")
    out = []
    for x_row, ids, wts in zip(xt, expert_ids, topw):
        y = torch.zeros_like(x_row)
        for j, e in enumerate(ids):
            if not lo <= e < lo + n_local:
                continue
            gw, uw, dw = (_expert(bank, e - lo) for bank in banks)
            g = F.silu(linear(x_row[None], gw))[0]
            u = linear(x_row[None], uw)[0]
            y = y + linear((g * u)[None], dw)[0] * wts[j].to(x_row.dtype)
        out.append(y)
    return torch.stack(out)


class _Forward(NamedTuple):
    """What every layer of one ``decoder_forward`` shares."""

    cfg: TextConfig
    store: object              # ``decoder_forward``'s store, or None
    rope: Optional[tuple]      # (cos, sin), or None where no layer reads them
    v_only: bool               # one token, no store, no mask: attention is v
    attn_mask: Optional[torch.Tensor]
    attn_impl: str
    state: object              # a hybrid's RecurrentState rows
    real_len: Optional[torch.Tensor]
    path: str
    seq: bool                  # x is this rank's S shard (sequence parallel)


def _attn_block(x, lp, j: int, f: _Forward):
    """Attention layer j over this rank's heads (every head with no mesh; o
    row-parallel under one): the new K/V handed to the store, which writes
    them and attends; with no store, causal self-attention over the
    block."""
    cfg = f.cfg
    mesh = ambient_mesh()
    h, hkv, kv_head = _tp_heads(cfg, mesh)
    hd, L = cfg.head_dim, f"{f.path}.layers"
    x = _tp_enter(x, mesh, f.seq)
    b, s, _ = x.shape
    if f.v_only:
        # Single-token self-attention (the streaming gate LM's shape): the
        # softmax over one logit is exactly 1, so the output is v itself —
        # the q/k projections and rope drop out and are never read.
        v = _kv_proj(x, lp, "v", L, cfg, mesh, kv_head).reshape(b, s, hkv, hd)
        o = _repeat_kv(v, h // hkv)
        return row_linear(o.reshape(b, s, h * hd), lp["o"], f"{L}.o", 1)
    q, k, v = qkv_proj(x, lp, cfg, f.path)
    if f.rope is not None:
        q = apply_rope(q, *f.rope)
        k = apply_rope(k, *f.rope)
    if f.store is not None:
        o = f.store.attend(j, q, k, v)
    else:
        o = attention(q, k, v, causal=True, kv_mask=f.attn_mask, impl=f.attn_impl)
    return row_linear(o.reshape(b, s, h * hd), lp["o"], f"{L}.o", 1,
                      sequence_dim=1 if f.seq else None)


def _layer(x, lp, kind: str, j: int, f: _Forward):
    """One decoder layer: attention layer j, or Mamba layer j, whose rows of
    ``f.state`` advance in place (by one token a row, or by a block's first
    ``f.real_len``); then the MLP or MoE."""
    def norm(t, name):  # on S shards, each rank's weight gradient is a part
        w = lp[name]["weight"]
        return rms_norm(t, C.copy_to_tp(w, ambient_mesh()) if f.seq else w, f.cfg.rms_norm_eps)

    y = norm(x, "input_norm")
    if kind == "attention":
        x = x + _attn_block(y, lp, j, f)
    elif y.shape[1] == 1:
        x = x + jamba.mamba_mixer_step(lp["mamba"], jamba.mamba_sizes(f.cfg), y[:, 0],
                                       f.state.conv[j], f.state.ssm[j])[:, None]
    else:
        x = x + jamba.mamba_mixer(lp["mamba"], jamba.mamba_sizes(f.cfg), y, f.state.conv[j],
                                  f.state.ssm[j], f.real_len)
    return x + _mlp(norm(x, "post_norm"), lp, f.cfg, f.path, f.seq)


def decoder_forward(params, cfg: TextConfig, store=None, input_ids=None, inputs_embeds=None,
                    positions=None, attn_mask=None, attn_impl="auto", remat=False,
                    sequence_axis=None, state=None, real_len=None, return_hidden=False,
                    path="text"):
    """The decoder over a token block, the one loop over its layers: fp32
    logits, or with ``return_hidden`` the final norm's output.

    ``store``: where attention layers keep the block's K/V, with ``length``
    (B,), where the block starts, and ``attend(j, q, k, v)``, which writes
    attention layer j's K/V and attends over the valid prefix (the ring's
    ``KVCache``, the page pool's store in ``streaming/paged.py``); None:
    causal self-attention over the block (the other options as
    ``text_forward`` says).  A hybrid's layer kinds come from
    ``jamba.layer_plan``; its Mamba layers continue ``state`` (the rows'
    ``RecurrentState``) in place.  The rotary tables are computed once, and
    not where no layer reads them: ``cfg.use_rope`` off, or the gate LM's
    one-token tick."""
    mesh = ambient_mesh()
    x = inputs_embeds if inputs_embeds is not None else embed_tokens(params, input_ids, path)
    b, s, _ = x.shape
    if positions is None:
        base = store.length[:, None] if store is not None else torch.zeros(
            (b, 1), dtype=torch.int32, device=x.device)
        positions = base + torch.arange(s, device=x.device)[None, :]
    seq = sequence_axis is not None and store is None and not is_trivial(mesh)
    if seq:
        if sequence_axis != "tp":
            raise ValueError(f"sequence_axis {sequence_axis!r}: the S shards ride tp")
        x = C.scatter(x, mesh, "tp", 1)
    v_only = store is None and s == 1 and attn_mask is None and "v" in params["layers"]
    rope = (rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
            if cfg.use_rope and not v_only else None)
    f = _Forward(cfg, store, rope, v_only, attn_mask, attn_impl, state, real_len, path, seq)
    plan = jamba.layer_plan(cfg) if cfg.hybrid else None
    layers = unstack_layers(params["layers"], cfg.num_layers) if plan is None else None
    for i in range(cfg.num_layers):
        if plan is None:
            lp, kind, j = layers[i], "attention", i
        else:
            lp, (kind, j) = jamba.layer_view(params["layers"], cfg, i), plan[i][:2]
        if remat and store is None:
            x = checkpoint(_layer, x, lp, kind, j, f, use_reentrant=False)
        else:
            x = _layer(x, lp, kind, j, f)
    if seq:
        x = C.gather(x, mesh, "tp", 1, bwd="slice")
    x = rms_norm(x, params["final_norm"]["weight"], cfg.rms_norm_eps)
    return x if return_hidden else lm_head(params, cfg, x, path)


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
    sequence_axis: Optional[str] = None,
    path: str = "text",
):
    """Forward over a token block, over the dense ring or no cache
    (``decoder_forward``).

    ``path``: the tree path of ``params`` ("text", or "projector.cls_net"
    for the gate LM), which the partitioning rules read under a mesh.

    ``sequence_axis`` (no cache, under a mesh): Megatron-style sequence
    parallelism — the activations between blocks live sharded along S over
    that axis ("tp"), the column-parallel inputs are gathered along S and
    the row-parallel sums reduce-scattered along S (the reference's
    ParallelLinearFunc all-gather / reduce-scatter pair); the numerics are
    those of the unsharded forward.

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
    if cfg.hybrid:
        raise ValueError("text_forward runs attention-only decoders; a hybrid decoder's Mamba "
                         "state lives in the paged pool (streaming/paged.py)")
    out = decoder_forward(params, cfg, cache, input_ids, inputs_embeds, positions=positions,
                          attn_mask=attn_mask, attn_impl=attn_impl, remat=remat,
                          sequence_axis=sequence_axis, return_hidden=return_hidden, path=path)
    if cache is None:
        return out, None
    advance = cache_advance if cache_advance is not None else out.shape[1]
    return out, KVCache(k=cache.k, v=cache.v, length=cache.length + advance)


def lm_head(params, cfg: TextConfig, hidden: torch.Tensor, path: str = "text") -> torch.Tensor:
    """fp32 logits.  Under a mesh whose rule puts the vocab on tp (the
    decoder's), each rank computes its vocab rows' logits and the ranks'
    are gathered over tp, so every rank samples from the same row."""
    key = "embed_tokens" if cfg.tie_word_embeddings else "lm_head.weight"
    w = params["embed_tokens"] if cfg.tie_word_embeddings else params["lm_head"]["weight"]
    mesh = ambient_mesh()
    if is_trivial(mesh):
        return (hidden @ w.T.to(hidden.dtype)).float()
    w = use_leaf(w, f"{path}.{key}", mesh=mesh)
    if spec_for(f"{path}.{key}", 2)[:1] != ("tp",):
        return (hidden @ w.T.to(hidden.dtype)).float()
    logits = C.copy_to_tp(hidden, mesh) @ w.T.to(hidden.dtype)
    return C.gather(logits, mesh, "tp", -1, bwd="slice").float()
