"""Weight-only int4 quantization of the gate LM (the ``quantize_gate="int4"`` tier).

Per-output-channel symmetric int4 with a COLUMN-HALVED nibble pack: the
low nibble of packed byte ``c`` holds input column ``c`` and the high
nibble holds column ``in/2 + c``.  ``ops/int4_matvec.py`` unpacks this
layout right before its dot products, so the weight stream is the packed
bytes plus one fp32 scale per output row.  The bytes equal those of the
JAX package's ``quantize_linear_weight_int4_pc``.
"""
from __future__ import annotations

import torch


def quantize_linear_weight_int4_pc(w: torch.Tensor) -> dict:
    """(..., out, in) float → {"w_int4pc": (..., out, in/2) int8, "scale":
    (..., out) fp32}.  An odd input width is left unquantized."""
    w32 = w.float()
    din = w32.shape[-1]
    if din % 2 != 0:
        return {"weight": w}
    absmax = w32.abs().amax(dim=-1, keepdim=True)
    # divide by a tensor: on CUDA, torch turns division by a Python scalar
    # into a product with its reciprocal, which can move a scale by one ulp
    # and so a packed byte; the bytes must not depend on the device
    scale = torch.clamp(absmax / absmax.new_tensor(7.0), min=1e-8)
    q = torch.clamp(torch.round(w32 / scale), -7, 7).to(torch.int8)
    lo = q[..., : din // 2]
    hi = q[..., din // 2:]
    packed = (lo & 0x0F) | (hi << 4)
    return {"w_int4pc": packed.contiguous(), "scale": scale[..., 0].contiguous()}


def dequantize_linear_weight_int4_pc(p: dict, dtype=torch.float32) -> torch.Tensor:
    packed = p["w_int4pc"]
    lo = (packed << 4) >> 4  # int8 arithmetic shifts sign-extend each nibble
    hi = packed >> 4
    q = torch.cat([lo, hi], dim=-1).float()
    return (q * p["scale"][..., None]).to(dtype)


def quantize_gate_params(cls_net_params: dict, bits: int = 4) -> dict:
    """Quantize every attention/MLP projection of the gate LM to int4;
    embeddings, norms and the 2-way lm_head stay full precision.  Only
    ``bits=4`` is ported; the int8 tier waits for a later slice."""
    if bits != 4:
        raise NotImplementedError(f"quantize_gate_params: bits={bits} is not ported")

    def quant(leaf: dict) -> dict:
        q = quantize_linear_weight_int4_pc(leaf["weight"])
        if "bias" in leaf:
            q["bias"] = leaf["bias"]
        return q

    out = dict(cls_net_params)
    layers = dict(out["layers"])
    for name in ("q", "k", "v", "o"):
        layers[name] = quant(layers[name])
    mlp = dict(layers["mlp"])
    for name in ("gate", "up", "down"):
        mlp[name] = quant(mlp[name])
    layers["mlp"] = mlp
    out["layers"] = layers
    return out
