"""Checkpoint conversion: HF / torch state dicts → this package's param trees.

The released checkpoint layouts:
  - full SFT: one state dict holding the decoder (``model.*``), the
    projector (``model.mm_projector.*``) and optionally the vision tower
    (``model.vision_tower.vision_tower.*``);
  - base + ``mm_projector.bin``: the projector dir over a base decoder dir;
  - LoRA: ``adapter_model.bin`` (+ ``adapter_config.json``) and
    ``non_lora_trainables.bin`` over a base decoder dir; the lora_A/B pairs
    are merged into the base weights.

Shards are ``.bin`` (``torch.load(weights_only=True)``) or ``.safetensors``,
read by the small reader below (JSON header, then the byte ranges), so no
``safetensors`` package is needed.  Conversion is name mapping, stacking
and reshaping; a cast to the target dtype goes through fp32, so an fp32 →
bf16 conversion rounds as the JAX package's ``astype(jnp.bfloat16)`` does
(to nearest, ties to even).  The decoder may be Mistral / Llama, Qwen2 or
Mixtral; the projector any of cfg.mm_projector_type's types: the mamba
projector (Video_Mamba_seq naming), the STC / STP / v35 connectors and
their spatial (depth-0) forms (timm RegStage naming, with the embedded gate
LM), linear and mlpNx_gelu (nn.Linear / nn.Sequential naming) and
identity.
"""
from __future__ import annotations

import json
import os
import re
import struct
from typing import Dict, Optional

import numpy as np
import torch

from ..config import StreamMindConfig, TextConfig, VisionConfig

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}

# files the HF Trainer writes beside the weight shards; training_args.bin is
# a pickled object that torch.load(weights_only=True) refuses
_SKIP_PREFIXES = ("training_args", "optimizer", "scheduler", "rng_state", "trainer_state",
                  "scaler")


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file → {name: CPU tensor}: an 8-byte little-endian
    header length, the JSON header ({name: {dtype, shape, data_offsets}},
    offsets relative to the end of the header), then the raw bytes."""
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        base = 8 + n
        for name, info in header.items():
            if name == "__metadata__":
                continue
            start, end = info["data_offsets"]
            buf = bytearray(end - start)
            f.seek(base + start)
            f.readinto(buf)
            dtype = _SAFETENSORS_DTYPES[info["dtype"]]
            t = (torch.frombuffer(buf, dtype=dtype) if buf
                 else torch.empty((0,), dtype=dtype))
            out[name] = t.reshape(info["shape"])
    return out


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """One shard, or every weight shard of a directory (trainer artifacts
    skipped), as {name: CPU tensor} in the stored dtypes."""
    if os.path.isdir(path):
        files = [os.path.join(path, f) for f in sorted(os.listdir(path))
                 if f.endswith((".bin", ".safetensors")) and not f.startswith(_SKIP_PREFIXES)]
    else:
        files = [path]
    sd = {}
    for f in files:
        if f.endswith(".safetensors"):
            sd.update(read_safetensors(f))
        else:
            sd.update(torch.load(f, map_location="cpu", weights_only=True))
    return sd


def _cast(t, dtype: torch.dtype) -> torch.Tensor:
    """A state-dict value in ``dtype``, rounded once from its fp32 value."""
    t = torch.as_tensor(t)
    if t.dtype == dtype:
        return t
    return t.to(torch.float32).to(dtype)


def _strip(sd: Dict, prefix: str) -> Dict:
    plen = len(prefix)
    return {k[plen:]: v for k, v in sd.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# CLIP vision tower (HF CLIPVisionModel naming)
# ---------------------------------------------------------------------------
_CLIP_NAMES = {
    "ln1": "layer_norm1", "q": "self_attn.q_proj", "k": "self_attn.k_proj",
    "v": "self_attn.v_proj", "o": "self_attn.out_proj", "ln2": "layer_norm2",
    "fc1": "mlp.fc1", "fc2": "mlp.fc2",
}


def convert_clip_vision(sd: Dict, cfg: VisionConfig, dtype=torch.float32) -> Dict:
    pre = "vision_model." if any(k.startswith("vision_model.") for k in sd) else ""

    def g(k):
        return _cast(sd[pre + k], dtype)

    layers = {
        ours: {p: torch.stack([g(f"encoder.layers.{i}.{theirs}.{p}")
                               for i in range(cfg.num_layers)]) for p in ("weight", "bias")}
        for ours, theirs in _CLIP_NAMES.items()
    }
    patch = g("embeddings.patch_embedding.weight")  # (D, 3, P, P)
    return {
        "class_embedding": g("embeddings.class_embedding"),
        "patch_embedding": patch.reshape(patch.shape[0], -1),
        "position_embedding": g("embeddings.position_embedding.weight"),
        "pre_layernorm": {"weight": g("pre_layrnorm.weight"), "bias": g("pre_layrnorm.bias")},
        "layers": layers,
    }


# ---------------------------------------------------------------------------
# Mistral / Llama / Qwen2 / Mixtral decoder (HF naming)
# ---------------------------------------------------------------------------
def convert_hf_text(sd: Dict, cfg: TextConfig, dtype=torch.float32) -> Dict:
    """Qwen2 (``qkv_bias``) adds the q/k/v projections' biases; Mixtral
    (``num_experts > 1``) takes ``block_sparse_moe``: the router from its
    ``gate`` and (L, E, F, D) banks from the experts' w1 (gate), w3 (up) and
    w2 (down)."""
    pre = "model." if any(k.startswith("model.") for k in sd) else ""

    def g(k):
        return _cast(sd[k], dtype)

    def stack(name, leaf="weight"):
        return torch.stack([g(f"{pre}layers.{i}.{name}.{leaf}") for i in range(cfg.num_layers)])

    layers = {
        "input_norm": {"weight": stack("input_layernorm")},
        "q": {"weight": stack("self_attn.q_proj")},
        "k": {"weight": stack("self_attn.k_proj")},
        "v": {"weight": stack("self_attn.v_proj")},
        "o": {"weight": stack("self_attn.o_proj")},
        "post_norm": {"weight": stack("post_attention_layernorm")},
    }
    if cfg.qkv_bias:  # Qwen2's biases are on q/k/v only
        for name in ("q", "k", "v"):
            layers[name]["bias"] = stack(f"self_attn.{name}_proj", "bias")
    if cfg.num_experts > 1:
        layers["router"] = {"weight": stack("block_sparse_moe.gate")}

        def bank(w):
            return torch.stack([torch.stack([
                g(f"{pre}layers.{i}.block_sparse_moe.experts.{e}.{w}.weight")
                for e in range(cfg.num_experts)]) for i in range(cfg.num_layers)])

        layers["experts"] = {"gate": bank("w1"), "up": bank("w3"), "down": bank("w2")}
    else:
        layers["mlp"] = {"gate": {"weight": stack("mlp.gate_proj")},
                         "up": {"weight": stack("mlp.up_proj")},
                         "down": {"weight": stack("mlp.down_proj")}}
    out = {
        "embed_tokens": g(pre + "embed_tokens.weight"),
        "layers": layers,
        "final_norm": {"weight": g(pre + "norm.weight")},
    }
    if not cfg.tie_word_embeddings:
        out["lm_head"] = {"weight": g("lm_head.weight")}
    return out


# ---------------------------------------------------------------------------
# mm_projector (Video_Mamba_seq naming)
# ---------------------------------------------------------------------------
def convert_projector(sd: Dict, cfg: StreamMindConfig, dtype=torch.float32) -> Dict:
    """Keys: pre_net.fc3.*, mamba_model.ssms.{i}.norm.*,
    mamba_model.ssms.{i}.mixer.{in_proj,conv1d,x_proj,dt_proj,out_proj,A_log,D},
    mamba_model.norm_fn.*, post_net.fc3.*, and the gate as
    cls_net.cls_model.(model.*|lm_head.*) in HF Mistral naming.  A_log and D
    stay fp32."""
    for candidate in ("model.mm_projector.", "mm_projector.", ""):
        if any(k.startswith(candidate + "pre_net") for k in sd):
            sd = _strip(sd, candidate) if candidate else sd
            break

    def g(k):
        return _cast(sd[k], dtype)

    def affine(k):
        return {"weight": g(k + ".weight"), "bias": g(k + ".bias")}

    blocks = []
    for i in range(cfg.mamba.n_layers):
        mx = f"mamba_model.ssms.{i}.mixer."
        block = {
            "norm": affine(f"mamba_model.ssms.{i}.norm"),
            "in_proj": {"weight": g(mx + "in_proj.weight")},
            "conv1d": {"weight": g(mx + "conv1d.weight").squeeze(1)},  # (D, 1, W) → (D, W)
            "x_proj": {"weight": g(mx + "x_proj.weight")},
            "dt_proj": affine(mx + "dt_proj"),
            "A_log": _cast(sd[mx + "A_log"], torch.float32),
            "D": _cast(sd[mx + "D"], torch.float32),
            "out_proj": {"weight": g(mx + "out_proj.weight")},
        }
        for leaf in ("conv1d", "in_proj", "out_proj"):
            if mx + leaf + ".bias" in sd:
                block[leaf]["bias"] = g(mx + leaf + ".bias")
        blocks.append(block)

    out = {
        "pre_net": affine("pre_net.fc3"),
        "mamba": {"blocks": blocks, "final_norm": affine("mamba_model.norm_fn")},
        "post_net": affine("post_net.fc3"),
    }
    cls_sd = _strip(sd, "cls_net.cls_model.")
    if cls_sd:
        out["cls_net"] = convert_hf_text(cls_sd, cfg.gate, dtype)
    return out


def convert_stc_connector(sd: Dict, depth: int = 4, mlp_depth: int = 2, variant: str = "stc",
                          dtype=torch.float32) -> Dict:
    """A timm-style STCConnector state dict → the connectors tree.  The
    reference builds its RegStages with LayerNorm2d, which timm still names
    'bn'.  Keys: s{1,2}.b{n}.conv{1,2,3}.{conv.weight,bn.weight,bn.bias},
    .se.fc{1,2}.{weight,bias}, .downsample.{conv.weight,bn.*} (where the
    width changes), sampler.0.{weight,bias} (the conv variants) and
    readout.{0,2,...}.{weight,bias}; the embedded gate (cls_net.*) is left
    to the caller."""
    def g(k):
        return _cast(sd[k], dtype)

    def affine(k):
        return {"weight": g(k + ".weight"), "bias": g(k + ".bias")}

    def block(prefix):
        p = {
            "conv1": g(prefix + ".conv1.conv.weight"),
            "ln1": affine(prefix + ".conv1.bn"),
            "conv2": g(prefix + ".conv2.conv.weight"),
            "ln2": affine(prefix + ".conv2.bn"),
            "se_fc1": g(prefix + ".se.fc1.weight"),
            "se_fc1_bias": g(prefix + ".se.fc1.bias"),
            "se_fc2": g(prefix + ".se.fc2.weight"),
            "se_fc2_bias": g(prefix + ".se.fc2.bias"),
            "conv3": g(prefix + ".conv3.conv.weight"),
            "ln3": affine(prefix + ".conv3.bn"),
        }
        if prefix + ".downsample.conv.weight" in sd:
            p["proj"] = g(prefix + ".downsample.conv.weight")
            p["proj_ln"] = affine(prefix + ".downsample.bn")
        return p

    out = {
        "s1": [block(f"s1.b{i + 1}") for i in range(depth)],
        "s2": [block(f"s2.b{i + 1}") for i in range(depth)],
        "readout": [affine(f"readout.{2 * i}") for i in range(mlp_depth)],
    }
    if variant in ("stc", "stc_v35"):
        out["sampler"] = affine("sampler.0")
    return out


def convert_simple_projector(sd: Dict, cfg: StreamMindConfig, dtype=torch.float32) -> Dict:
    """linear / mlpNx_gelu projector state dicts: a bare nn.Linear
    ({weight, bias}) or an nn.Sequential with GELUs between ({0,2,4,...}.*)."""
    t = cfg.mm_projector_type
    if t == "linear":
        return {"proj": {"weight": _cast(sd["weight"], dtype), "bias": _cast(sd["bias"], dtype)}}
    m = re.match(r"^mlp(\d+)x_gelu$", t)
    if not m:
        raise ValueError(f"not a simple projector type: {t!r}")
    return {"mlp": [{"weight": _cast(sd[f"{2 * i}.weight"], dtype),
                     "bias": _cast(sd[f"{2 * i}.bias"], dtype)} for i in range(int(m.group(1)))]}


_CONNECTOR_VARIANTS = {"stc_connector": ("stc", 4), "stp_connector": ("stp", 4),
                       "stc_connector_v35": ("stc_v35", 4), "spatial_conv": ("stc", 0),
                       "spatial_pool": ("stp", 0)}


def convert_projector_dispatch(sd: Dict, cfg: StreamMindConfig, dtype=torch.float32) -> Dict:
    """The converter of cfg.mm_projector_type.  The keys may carry the
    ``model.mm_projector.`` or ``mm_projector.`` prefix; a connector's
    embedded gate (``cls_net.cls_model.*``, HF Mistral naming) becomes
    ``projector["cls_net"]``."""
    t = cfg.mm_projector_type
    if t == "mamba":
        return convert_projector(sd, cfg, dtype)
    psd = dict(sd)
    for candidate in ("model.mm_projector.", "mm_projector."):
        if any(k.startswith(candidate) for k in sd):
            psd = _strip(sd, candidate)
            break
    if t in _CONNECTOR_VARIANTS:
        variant, depth = _CONNECTOR_VARIANTS[t]
        out = convert_stc_connector(psd, depth=depth, variant=variant, dtype=dtype)
        cls_sd = _strip(psd, "cls_net.cls_model.")
        if cls_sd:
            out["cls_net"] = convert_hf_text(cls_sd, cfg.gate, dtype)
        return out
    if t == "identity":
        return {}
    if t == "linear" or re.match(r"^mlp(\d+)x_gelu$", t):
        return convert_simple_projector(psd, cfg, dtype)
    raise ValueError(
        f"no converter for mm_projector_type={t!r} checkpoints; use one of mamba, linear, "
        "mlpNx_gelu, stc/stp/v35 connectors, spatial_conv/spatial_pool or identity")


# ---------------------------------------------------------------------------
# LoRA merge
# ---------------------------------------------------------------------------
def _np32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).cpu().numpy()
    return np.asarray(t, np.float32)


def merge_lora(sd: Dict, lora_sd: Dict, scaling: Optional[float] = None,
               r: Optional[int] = None, alpha: Optional[float] = None) -> Dict:
    """Merge peft-style lora_A / lora_B pairs into the base weights,
    W' = W + scaling * B @ A, in fp32 numpy (the JAX package's arithmetic)."""
    out = dict(sd)
    pairs: Dict[str, Dict[str, np.ndarray]] = {}
    for k, v in lora_sd.items():
        m = re.match(r"(?:base_model\.model\.)?(.+)\.lora_(A|B)(?:\.default)?\.weight", k)
        if m:
            base, which = m.groups()
            pairs.setdefault(base, {})[which] = _np32(v)
    for base, ab in pairs.items():
        if "A" not in ab or "B" not in ab:
            continue
        A, B = ab["A"], ab["B"]
        s = scaling if scaling is not None else (alpha / (r or A.shape[0]) if alpha else 1.0)
        key = base + ".weight"
        if key in out:
            out[key] = torch.from_numpy(_np32(out[key]) + s * (B @ A))
    return out


def _strip_lora_prefixes(sd: Dict) -> Dict:
    """non_lora_trainables keys: drop 'base_model.' and a doubled 'model.'."""
    out = {(k[len("base_model."):] if k.startswith("base_model.") else k): v
           for k, v in sd.items()}
    if any(k.startswith("model.model.") for k in out):
        out = {(k[len("model."):] if k.startswith("model.") else k): v for k, v in out.items()}
    return out


def convert_streammind_checkpoint(model_path: str, cfg: StreamMindConfig, dtype=torch.float32,
                                  vision_path: Optional[str] = None,
                                  base_path: Optional[str] = None) -> Dict:
    """A param tree (CPU tensors) from a checkpoint directory, in any of the
    three layouts (module docstring).  ``base_path`` is the base decoder
    dir of the LoRA and the base + mm_projector.bin layouts; the vision
    tower may come from a separate CLIP checkpoint (``vision_path``)."""
    adapter_file = None
    if os.path.isdir(model_path):
        for f in ("adapter_model.bin", "adapter_model.safetensors"):
            p = os.path.join(model_path, f)
            if os.path.exists(p):
                adapter_file = p
                break

    if adapter_file is not None:
        if not base_path:
            raise ValueError(
                f"{model_path} holds a LoRA adapter checkpoint (adapter_model.bin); merging "
                "needs the base decoder: pass base_path / model_base.  Without it the "
                "lora_A/B pairs would match nothing and the decoder would be random.")
        sd = load_state_dict(base_path)
        scaling = None
        acfg = os.path.join(model_path, "adapter_config.json")
        if os.path.exists(acfg):
            with open(acfg) as f:
                a = json.load(f)
            if a.get("r"):
                scaling = float(a.get("lora_alpha", a["r"])) / float(a["r"])
        sd = merge_lora(sd, load_state_dict(adapter_file), scaling=scaling)
        nlt = os.path.join(model_path, "non_lora_trainables.bin")
        if os.path.exists(nlt):
            sd.update(_strip_lora_prefixes(load_state_dict(nlt)))
    else:
        sd = load_state_dict(model_path)
        if base_path:
            base_sd = load_state_dict(base_path)
            base_sd.update(sd)  # the adapter's keys win over the base's
            sd = base_sd

    params = {}
    text_sd = {k: v for k, v in sd.items()
               if (k.startswith("model.")
                   and not k.startswith(("model.mm_projector", "model.vision_tower")))
               or k.startswith("lm_head")}
    if text_sd:
        params["text"] = convert_hf_text(text_sd, cfg.text, dtype)
    if any(k.startswith("model.mm_projector") or k.startswith("pre_net") for k in sd):
        params["projector"] = convert_projector_dispatch(sd, cfg, dtype)
    vision_sd = _strip(sd, "model.vision_tower.vision_tower.")
    if vision_sd:
        params["vision"] = convert_clip_vision(vision_sd, cfg.vision, dtype)
    elif vision_path:
        params["vision"] = convert_clip_vision(load_state_dict(vision_path), cfg.vision, dtype)
    return params
