"""Key and shape manifests of the released StreamMind checkpoints.

Their key naming is fixed by the reference module tree: an HF
MistralForCausalLM with the meta-arch's ``model.mm_projector`` and
``model.vision_tower`` submodules, saved by the HF Trainer.  This module
rebuilds that surface with ``transformers`` modules on torch's meta device
(no memory at 7B widths), so the converter's naming can be held by a test.
``transformers`` is imported inside each builder: the card's machine has
none, and ``tests/data/checkpoint_manifest_*.json`` hold the 7B manifests.

Layouts covered:
  - full-SFT: model.* decoder + model.mm_projector.* +
    model.vision_tower.vision_tower.* in one state dict;
  - base + mm_projector.bin: keys keep the model.mm_projector. prefix.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch


def mistral_lm_manifest(
    hidden_size: int = 4096,
    intermediate_size: int = 14336,
    num_layers: int = 32,
    num_heads: int = 32,
    num_kv_heads: int = 8,
    vocab_size: int = 32000,
    head_dim: int | None = None,
) -> Dict[str, List[int]]:
    """HF MistralForCausalLM state-dict surface (model.* + lm_head.*)."""
    from transformers import MistralConfig, MistralForCausalLM

    cfg = MistralConfig(
        hidden_size=hidden_size,
        intermediate_size=intermediate_size,
        num_hidden_layers=num_layers,
        num_attention_heads=num_heads,
        num_key_value_heads=num_kv_heads,
        vocab_size=vocab_size,
        **({"head_dim": head_dim} if head_dim else {}),
    )
    with torch.device("meta"):
        m = MistralForCausalLM(cfg)
    return {k: list(v.shape) for k, v in m.state_dict().items()}


def clip_vision_manifest(
    hidden_size: int = 1024,
    intermediate_size: int = 4096,
    num_layers: int = 24,
    num_heads: int = 16,
    image_size: int = 336,
    patch_size: int = 14,
) -> Dict[str, List[int]]:
    """CLIPVisionModel surface (ViT-L/14-336 defaults) — lives under
    model.vision_tower.vision_tower. in the full-SFT dict
    (clip_encoder.py wraps CLIPVisionModel as self.vision_tower)."""
    from transformers import CLIPVisionConfig, CLIPVisionModel

    cfg = CLIPVisionConfig(
        hidden_size=hidden_size,
        intermediate_size=intermediate_size,
        num_hidden_layers=num_layers,
        num_attention_heads=num_heads,
        image_size=image_size,
        patch_size=patch_size,
    )
    with torch.device("meta"):
        m = CLIPVisionModel(cfg)
    return {k: list(v.shape) for k, v in m.state_dict().items()}


def projector_manifest(
    mm_hidden_size: int = 1024,
    hidden_size: int = 4096,
    n_ssm: int = 1,
    d_state: int = 16,
    d_conv: int = 4,
    expand: int = 2,
    gate_layers: int = 4,
    gate_vocab: int = 2,
    gate_hidden: int = 4096,
    gate_intermediate: int = 14336,
    gate_heads: int = 32,
    gate_kv_heads: int = 8,
) -> Dict[str, List[int]]:
    """Video_Mamba_seq surface per the reference module tree
    (multimodal_projector/builder.py:390-401 + ssm.py VideoMamba +
    mamba_ssm create_block → Block(norm=LayerNorm, mixer=Mamba)):

      pre_net.fc3.{weight,bias}
      mamba_model.ssms.{i}.norm.{weight,bias}
      mamba_model.ssms.{i}.mixer.{in_proj,conv1d,x_proj,dt_proj,A_log,D,out_proj}
      mamba_model.norm_fn.{weight,bias}
      post_net.fc3.{weight,bias}
      cls_net.cls_model.*  (4-layer Mistral, vocab 2 — builder.py:370-385;
        ClsNet uses MistralConfig() DEFAULTS except vocab/layers, so the
        gate is 7B-width)
    """
    d_inner = expand * hidden_size
    dt_rank = math.ceil(hidden_size / 16)
    out: Dict[str, List[int]] = {
        "pre_net.fc3.weight": [hidden_size, mm_hidden_size],
        "pre_net.fc3.bias": [hidden_size],
        "post_net.fc3.weight": [hidden_size, hidden_size],
        "post_net.fc3.bias": [hidden_size],
        "mamba_model.norm_fn.weight": [hidden_size],
        "mamba_model.norm_fn.bias": [hidden_size],
    }
    for i in range(n_ssm):
        p = f"mamba_model.ssms.{i}."
        out[p + "norm.weight"] = [hidden_size]
        out[p + "norm.bias"] = [hidden_size]
        mx = p + "mixer."
        out[mx + "in_proj.weight"] = [2 * d_inner, hidden_size]
        out[mx + "conv1d.weight"] = [d_inner, 1, d_conv]
        out[mx + "conv1d.bias"] = [d_inner]
        out[mx + "x_proj.weight"] = [dt_rank + 2 * d_state, d_inner]
        out[mx + "dt_proj.weight"] = [d_inner, dt_rank]
        out[mx + "dt_proj.bias"] = [d_inner]
        out[mx + "A_log"] = [d_inner, d_state]
        out[mx + "D"] = [d_inner]
        out[mx + "out_proj.weight"] = [hidden_size, d_inner]
    gate = mistral_lm_manifest(
        hidden_size=gate_hidden,
        intermediate_size=gate_intermediate,
        num_layers=gate_layers,
        num_heads=gate_heads,
        num_kv_heads=gate_kv_heads,
        vocab_size=gate_vocab,
    )
    for k, v in gate.items():
        out["cls_net.cls_model." + k] = v
    return out


def full_sft_manifest_7b() -> Dict[str, List[int]]:
    """The full-SFT checkpoint surface at released dims (Mistral-7B +
    CLIP ViT-L/14-336 + mamba projector + 4-layer gate)."""
    out: Dict[str, List[int]] = {}
    out.update(mistral_lm_manifest())
    for k, v in projector_manifest().items():
        out["model.mm_projector." + k] = v
    for k, v in clip_vision_manifest().items():
        out["model.vision_tower.vision_tower." + k] = v
    return out


def mm_projector_bin_manifest_7b() -> Dict[str, List[int]]:
    """mm_projector.bin adapter surface (model.mm_projector. prefix kept)."""
    return {"model.mm_projector." + k: v for k, v in projector_manifest().items()}
