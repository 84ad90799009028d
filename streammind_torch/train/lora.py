"""LoRA fine-tuning as a parameterization over the base tree.

The JAX package's functional LoRA: a mirror tree of {A, B} pairs for every
attention and MLP projection of the decoder (q, k, v, o; gate, up, down),
A (L, r, in) ~ N(0, 0.02) and B (L, out, r) zero, so the initial delta is
zero.  Only the LoRA leaves train.  ``attach_lora`` hangs the factors on the
base leaves, and ``utils/params.py::linear`` adds ``x @ Aᵀ @ Bᵀ · scale``
at matmul time, so the base may rest quantized (int8 or int4: QLoRA).
``apply_lora`` and ``merge_lora_into_params`` merge ``W + scale · B @ A``
for export, dequantizing a quantized base first.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..utils.quantize import (
    dequantize_linear_weight,
    dequantize_linear_weight_int4,
    dequantize_linear_weight_int4_pc,
)

# decoder projections peft targets by default for Mistral-family models
_TARGETS = ("q", "k", "v", "o")
_MLP_TARGETS = ("gate", "up", "down")


def _leaf_shape(leaf: Dict) -> Tuple[int, int, int]:
    """(L, out, in) of a projection leaf: full precision, int8, or packed
    int4 (groups or per channel, two inputs a byte)."""
    if "weight" in leaf:
        return tuple(leaf["weight"].shape)
    if "w_int8" in leaf:
        return tuple(leaf["w_int8"].shape)
    packed = leaf["w_int4"] if "w_int4" in leaf else leaf["w_int4pc"]
    L, out_f, half_in = packed.shape
    return (L, out_f, half_in * 2)


def init_lora_params(g: torch.Generator, text_params, r: int = 128,
                     dtype=torch.float32) -> Dict:
    """LoRA trees for stacked decoder layers on the decoder's device, drawn
    from ``g`` in the order q, k, v, o, gate, up, down: A ~ N(0, 0.02),
    B = 0."""
    layers = text_params["layers"]
    device = next(iter(layers["q"].values())).device

    def pair(leaf):
        L, out_f, in_f = _leaf_shape(leaf)
        a = torch.empty((L, r, in_f), device=device, dtype=dtype).normal_(0.0, 0.02, generator=g)
        return {"A": a, "B": torch.zeros((L, out_f, r), device=device, dtype=dtype)}

    lora = {"layers": {name: pair(layers[name]) for name in _TARGETS}}
    if "mlp" in layers:
        lora["layers"]["mlp"] = {name: pair(layers["mlp"][name]) for name in _MLP_TARGETS}
    return lora


def _base_weight(leaf) -> torch.Tensor:
    """Full-precision view of a projection leaf's base weight; quantized
    bases are dequantized (fp32)."""
    if "weight" in leaf:
        return leaf["weight"]
    if "w_int8" in leaf:
        return dequantize_linear_weight(leaf)
    if "w_int4" in leaf:
        return dequantize_linear_weight_int4(leaf)
    if "w_int4pc" in leaf:
        return dequantize_linear_weight_int4_pc(leaf)
    raise KeyError(f"no base weight in leaf with keys {sorted(leaf)}")


def _merged_leaf(leaf, ab, scaling: float):
    w = _base_weight(leaf)
    delta = torch.einsum("lor,lri->loi", ab["B"].to(w.dtype), ab["A"].to(w.dtype))
    out = {k: v for k, v in leaf.items() if k == "bias"}  # quantized leaves go: W is fp
    out["weight"] = w + scaling * delta
    return out


def _map_targets(text_params, lora, fn):
    """A copy of the text tree with fn(leaf, ab) at every LoRA target."""
    out = dict(text_params)
    layers = dict(text_params["layers"])
    for name, ab in lora["layers"].items():
        if name == "mlp":
            mlp = dict(layers["mlp"])
            for mname, mab in ab.items():
                mlp[mname] = fn(mlp[mname], mab)
            layers["mlp"] = mlp
        else:
            layers[name] = fn(layers[name], ab)
    out["layers"] = layers
    return out


def apply_lora(text_params, lora, scaling: float):
    """A text tree with W + scaling · B @ A merged in (the export path);
    quantized bases become full-precision merged weights."""
    return _map_targets(text_params, lora, lambda leaf, ab: _merged_leaf(leaf, ab, scaling))


def attach_lora(text_params, lora, scaling: float):
    """A text tree whose projection leaves carry the factors next to the
    base weight (``lora_a``, ``lora_b``, and ``lora_scale``, an (L,) fp32
    leaf so that ``unstack_layers`` slices it with the rest).  The attached
    leaves are the tensors of ``lora``, so gradients reach the lora tree;
    no merged weight is ever made, and the base may rest quantized."""

    def attach(leaf, ab):
        s = torch.full((ab["A"].shape[0],), scaling, dtype=torch.float32, device=ab["A"].device)
        return {**leaf, "lora_a": ab["A"], "lora_b": ab["B"], "lora_scale": s}

    return _map_targets(text_params, lora, attach)


def merge_lora_into_params(params, lora, r: int, alpha: float):
    """Permanent merge for export (the reference's merge_and_unload)."""
    out = dict(params)
    out["text"] = apply_lora(params["text"], lora, alpha / r)
    return out
