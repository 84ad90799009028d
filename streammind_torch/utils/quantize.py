"""Weight quantization of the serving tiers.

- int8, per output channel (``{"w_int8": (out, in) int8, "scale": (out,)
  fp32}``): the gate under ``quantize_gate="int8"``, the decoder under the
  ``load_8bit`` transform (``quantize_text_params(bits=8)``) and the int8 ViT
  (``quantize_vit_params``).  ``utils.params.linear`` reads these leaves
  through the int8 matvec kernel (``ops/int8_matvec.py``) at ≤ 8 tokens.
- int4 in groups of 64 inputs (``{"w_int4": (out, in/2) int8, "scale4":
  (out, in/64) fp32}``, nibbles interleaved): the ``load_4bit`` memory tier,
  dequantized at matmul time.
- int4 per output channel with a COLUMN-HALVED nibble pack (``{"w_int4pc":
  (out, in/2) int8, "scale": (out,) fp32}``; the low nibble of packed byte
  ``c`` holds input column ``c``, the high nibble column ``in/2 + c``): the
  ``quantize_gate="int4"`` tier, unpacked by ``ops/int4_matvec.py``.

Every quantizer works on single (out, in) weights and layer-stacked (L, out,
in) ones alike, and its bytes equal those of the JAX package's.  Divisions
are by tensors, never by a Python scalar: on CUDA, torch computes a division
by a scalar as a product with its reciprocal, which can move a scale by one
ulp and so a quantized byte; the bytes must not depend on the device.
"""
from __future__ import annotations

import torch


def _div(t: torch.Tensor, c: float) -> torch.Tensor:
    return t / t.new_tensor(c)


def _per_layer(fn, w: torch.Tensor) -> dict:
    """Apply a row-wise quantizer to each (out, in) matrix of a stacked
    leaf in turn, so the fp32 transients are one layer's, not the stack's
    (every output row depends on its own input row alone, so the bytes are
    those of one call over the whole stack)."""
    if w.dim() <= 2:
        return fn(w)
    parts = [_per_layer(fn, w[i]) for i in range(w.shape[0])]
    return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}


def _quantize_int8(w: torch.Tensor) -> dict:
    w32 = w.float()
    absmax = w32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(_div(absmax, 127.0), min=1e-8)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"w_int8": q, "scale": scale[..., 0].contiguous()}


def quantize_linear_weight(w: torch.Tensor) -> dict:
    """(..., out, in) float → {"w_int8": int8, "scale": (..., out) fp32}:
    symmetric absmax over the input (last) axis."""
    return _per_layer(_quantize_int8, w)


def dequantize_linear_weight(p: dict, dtype=torch.float32) -> torch.Tensor:
    return (p["w_int8"].float() * p["scale"][..., None]).to(dtype)


def _quantize_int4(w: torch.Tensor, group: int) -> dict:
    w32 = w.float()
    din = w32.shape[-1]
    wg = w32.reshape(*w32.shape[:-1], din // group, group)
    scale = torch.clamp(_div(wg.abs().amax(dim=-1), 7.0), min=1e-8)  # (..., out, n_groups)
    q = torch.clamp(torch.round(wg / scale[..., None]), -7, 7).to(torch.int8)
    q = q.reshape(*w32.shape[:-1], din)
    packed = (q[..., 0::2] & 0x0F) | (q[..., 1::2] << 4)
    return {"w_int4": packed.contiguous(), "scale4": scale.contiguous()}


def quantize_linear_weight_int4(w: torch.Tensor, group: int = 64) -> dict:
    """(..., out, in) float → {"w_int4": (..., out, in/2) int8 (input column
    2c in the low nibble of byte c, 2c+1 in the high), "scale4": (..., out,
    in/group) fp32}.  An odd input width stays unquantized; a width that is
    no multiple of ``group`` takes one group a row."""
    din = w.shape[-1]
    if din % 2 != 0:
        return {"weight": w}
    if din % group != 0:
        group = din
    return _per_layer(lambda m: _quantize_int4(m, group), w)


def dequantize_linear_weight_int4(p: dict, dtype=torch.float32) -> torch.Tensor:
    packed = p["w_int4"]
    lo = (packed << 4) >> 4  # int8 arithmetic shifts sign-extend each nibble
    hi = packed >> 4
    q = torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)
    scale = p["scale4"]
    n_groups = scale.shape[-1]
    w = q.reshape(*q.shape[:-1], n_groups, q.shape[-1] // n_groups).float() * scale[..., None]
    return w.reshape(q.shape).to(dtype)


def _quantize_int4_pc(w: torch.Tensor) -> dict:
    w32 = w.float()
    din = w32.shape[-1]
    absmax = w32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(_div(absmax, 7.0), min=1e-8)
    q = torch.clamp(torch.round(w32 / scale), -7, 7).to(torch.int8)
    packed = (q[..., : din // 2] & 0x0F) | (q[..., din // 2:] << 4)
    return {"w_int4pc": packed.contiguous(), "scale": scale[..., 0].contiguous()}


def quantize_linear_weight_int4_pc(w: torch.Tensor) -> dict:
    """(..., out, in) float → {"w_int4pc": (..., out, in/2) int8, "scale":
    (..., out) fp32}.  An odd input width is left unquantized."""
    if w.shape[-1] % 2 != 0:
        return {"weight": w}
    return _per_layer(_quantize_int4_pc, w)


def dequantize_linear_weight_int4_pc(p: dict, dtype=torch.float32) -> torch.Tensor:
    packed = p["w_int4pc"]
    lo = (packed << 4) >> 4
    hi = packed >> 4
    q = torch.cat([lo, hi], dim=-1).float()
    return (q * p["scale"][..., None]).to(dtype)


def quantize_text_params(text_params: dict, bits: int = 8, free_source: bool = False,
                         scheme: str = "group") -> dict:
    """The decoder's ``load_8bit`` / ``load_4bit`` transform: every
    attention and MLP projection stored int8 (per channel, ``bits=8``) or
    packed int4 (``bits=4``: ``scheme="group"``, groups of 64, or ``"pc"``,
    per channel with the column-halved pack); Mixtral's expert banks the
    same way; embeddings, norms, the router and lm_head keep their
    precision.

    ``free_source=True`` pops each source weight out of the INPUT tree
    right before quantizing it, so a full-precision tree and its quantized
    copy never live at once (the input tree is mutated)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")

    def quant(leaf: dict) -> dict:
        w = leaf.pop("weight") if free_source else leaf["weight"]
        if bits == 8:
            q = quantize_linear_weight(w)
        elif scheme == "pc":
            q = quantize_linear_weight_int4_pc(w)
        else:
            q = quantize_linear_weight_int4(w)
        del w
        if "bias" in leaf:
            q["bias"] = leaf["bias"]
        return q

    out = dict(text_params)
    layers = dict(out["layers"])
    for name in ("q", "k", "v", "o"):
        layers[name] = quant(layers[name])
    if "mlp" in layers:
        mlp = dict(layers["mlp"])
        for name in ("gate", "up", "down"):
            mlp[name] = quant(mlp[name])
        layers["mlp"] = mlp
    if "experts" in layers:
        # Mixtral's (L, E, F, D) banks, quantized along the input (last) axis
        # like any linear (one (F, D) matrix at a time); the router keeps its
        # precision.  free_source pops each raw bank out of the input tree
        # before quantizing it: the banks are ~90% of a Mixtral's weights.
        orig = layers["experts"]
        experts = {}
        for name in ("gate", "up", "down"):
            src = orig[name]
            if isinstance(src, dict):
                experts[name] = quant(src)
                continue
            if free_source:
                orig.pop(name)
            experts[name] = quant({"weight": src})
            del src
        layers["experts"] = experts
    out["layers"] = layers
    return out


def quantize_vit_params(vit_params: dict) -> dict:
    """The ``fast_vision="int8"`` ViT: every encoder linear int8 per channel
    (``models/vit.py::_linear_q`` quantizes the activations per token and
    multiplies int8 by int8); embeddings and layer norms keep their
    precision."""
    out = dict(vit_params)
    layers = dict(out["layers"])
    for name in ("q", "k", "v", "o", "fc1", "fc2"):
        leaf = layers[name]
        q = quantize_linear_weight(leaf["weight"])
        if "bias" in leaf:
            q["bias"] = leaf["bias"]
        layers[name] = q
    out["layers"] = layers
    return out


def quantize_gate_params(cls_net_params: dict, bits: int = 8) -> dict:
    """Quantize every attention and MLP projection of the gate LM:
    ``bits=8`` per-channel int8 (the text transform), ``bits=4`` per-channel
    int4 with the column-halved pack.  Embeddings, norms and the 2-way
    lm_head keep their precision."""
    if bits == 8:
        return quantize_text_params(cls_net_params, bits=8)
    if bits != 4:
        raise ValueError(f"bits must be 4 or 8, got {bits}")

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


def synth_quantized_text_params(cfg, bits: int = 8, scheme: str = "group", device="cuda",
                                dtype=torch.bfloat16) -> dict:
    """A decoder tree made directly at its QUANTIZED shapes, for runs whose
    weight values do not matter: the shapes come from the init and the
    quantizer run on the meta device (no memory), then integer leaves are
    filled with ones and float leaves with 0.01, on ``device``.  Peak memory
    is the quantized tree alone."""
    from ..models.mistral import init_text_params
    from .params import tree_map

    shapes = quantize_text_params(init_text_params(None, cfg, device="meta", dtype=dtype),
                                  bits=bits, scheme=scheme)

    def fill(s: torch.Tensor) -> torch.Tensor:
        if s.is_floating_point():
            return torch.full(s.shape, 0.01, dtype=s.dtype, device=device)
        return torch.ones(s.shape, dtype=s.dtype, device=device)

    return tree_map(fill, shapes)
