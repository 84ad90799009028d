"""Parameter-tree helpers: initializers, linear, tree walking.

Models are plain functions over nested dicts of tensors ("param trees"),
with the same leaf names and layout as the JAX package: linear weights
are ``(out_features, in_features)`` and per-layer leaves of a transformer
are stacked along a leading layer axis, so one converter
(``utils.from_jax``) serves both packages.
"""
from __future__ import annotations

import math
from typing import Any, Iterator, Tuple

import torch
import torch.nn.functional as F

from ..ops.int4_matvec import MAX_TOKENS, int4_matvec
from ..ops.int8_matvec import int8_matvec
from .quantize import dequantize_linear_weight_int4, dequantize_linear_weight_int4_pc


def _normal(g: torch.Generator, shape, std: float, device, dtype) -> torch.Tensor:
    return torch.empty(shape, device=device, dtype=dtype).normal_(0.0, std, generator=g)


def _uniform(g: torch.Generator, shape, bound: float, device, dtype) -> torch.Tensor:
    return torch.empty(shape, device=device, dtype=dtype).uniform_(-bound, bound, generator=g)


def torch_linear_init(g: torch.Generator, out_features: int, in_features: int,
                      bias: bool = True, device="cuda", dtype=torch.float32,
                      lead: Tuple[int, ...] = ()):
    """torch.nn.Linear's default init: uniform(±sqrt(1/fan_in)) weights and
    bias.  ``lead`` prepends stacked-layer axes."""
    bound = math.sqrt(1.0 / in_features)
    out = {"weight": _uniform(g, (*lead, out_features, in_features), bound, device, dtype)}
    if bias:
        out["bias"] = _uniform(g, (*lead, out_features), bound, device, dtype)
    return out


def normal_init(g: torch.Generator, shape, std: float = 0.02, device="cuda",
                dtype=torch.float32) -> torch.Tensor:
    return _normal(g, shape, std, device, dtype)


def zeros(shape, device="cuda", dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(shape, device=device, dtype=dtype)


def ones(shape, device="cuda", dtype=torch.float32) -> torch.Tensor:
    return torch.ones(shape, device=device, dtype=dtype)


def linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    """x @ W.T + b with (out, in)-layout weights.

    Also takes the quantized leaves of utils.quantize.  With at most 8
    tokens on a CUDA tensor, int8 ({"w_int8", "scale"}) and per-channel int4
    ({"w_int4pc", "scale"}) leaves go through their fused matvec kernels
    (ops/int8_matvec.py, ops/int4_matvec.py), which read the quantized
    bytes directly and round once; otherwise int8 takes the JAX package's
    formula (a product in x's dtype, then the scale in x's dtype), and int4
    the matmul with the dequantized weight.
    """
    t = x.numel() // x.shape[-1]
    fused = x.is_cuda and t <= MAX_TOKENS
    if "w_int8" in p:
        if fused:
            y = int8_matvec(x.reshape(t, x.shape[-1]).contiguous(), p["w_int8"], p["scale"]
                            ).reshape(*x.shape[:-1], -1)
        else:
            y = (x @ p["w_int8"].T.to(x.dtype)) * p["scale"].to(x.dtype)
    elif "w_int4" in p:
        y = F.linear(x, dequantize_linear_weight_int4(p, x.dtype))
    elif "w_int4pc" in p:
        if fused:
            y = int4_matvec(
                x.reshape(t, x.shape[-1]).contiguous(), p["w_int4pc"], p["scale"]
            ).reshape(*x.shape[:-1], -1)
        else:
            y = F.linear(x, dequantize_linear_weight_int4_pc(p, x.dtype))
    elif "weight" in p:
        y = F.linear(x, p["weight"].to(x.dtype))
    else:
        raise ValueError(f"linear: unsupported leaf scheme {sorted(p)}")
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def tree_leaves(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def layer_slice(tree, i: int):
    """Layer i of a layer-stacked tree (every leaf indexed on axis 0)."""
    return tree_map(lambda a: a[i], tree)


def unstack_layers(tree, n: int):
    """The n per-layer trees of a layer-stacked tree, as views.  Unbinding
    each leaf once (instead of indexing it per layer) makes the backward of
    a trained stacked leaf one stack of the layers' grads, not one
    leaf-sized scatter per layer."""
    parts = tree_map(lambda a: a.unbind(0), tree)  # tuples are leaves to tree_map
    return [tree_map(lambda t: t[i], parts) for i in range(n)]


def param_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def param_count(tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree))


def flatten_with_paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """Yield ('a.b.c', leaf) pairs for a nested dict tree; a list's items
    are keyed by their index ('blocks.0.w')."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            yield from flatten_with_paths(v, f"{prefix}{k}." if prefix or k != "" else k)
    else:
        yield prefix.rstrip("."), tree


def cast_tree(tree, dtype: torch.dtype):
    """Every floating leaf cast to ``dtype`` (integer leaves kept)."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def stack_layers(layer_params: list):
    """Identical per-layer trees stacked along a new leading layer axis."""
    first = layer_params[0]
    if isinstance(first, dict):
        return {k: stack_layers([p[k] for p in layer_params]) for k in first}
    if isinstance(first, list):
        return [stack_layers([p[i] for p in layer_params]) for i in range(len(first))]
    return torch.stack(layer_params, dim=0)
