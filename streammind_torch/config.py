"""Configuration dataclasses for every component of the stack.

A copy of the JAX package's configuration (same fields, defaults, presets
and tiny test configs), kept here so this package imports nothing of it.
``StreamMindConfig.to_json`` writes the same JSON as the JAX package's, so
a config written by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
import math


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """CLIP ViT (default: ViT-L/14-336, the frozen frame encoder)."""

    image_size: int = 336
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    layer_norm_eps: float = 1e-5
    # Which hidden state to tap: -2 == output of the second-to-last block
    # (reference clip_encoder.py:18,31 mm_vision_select_layer).
    select_layer: int = -2
    # "patch": drop CLS; "cls_patch": keep it (reference feature_select).
    select_feature: str = "patch"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    """Mamba-1 selective SSM block (the temporal memory).

    Defaults follow mamba_ssm 2.2.2 Mamba (reference
    model/mamba_ssm/modules/mamba_simple.py:31-66): d_inner = 2*d_model,
    dt_rank = ceil(d_model/16), S4D-real A init.
    """

    d_model: int = 4096
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 → auto (ceil(d_model / 16))
    dt_min: float = 0.001
    dt_max: float = 0.1
    dt_init_floor: float = 1e-4
    conv_bias: bool = True
    bias: bool = False
    layer_norm_eps: float = 1e-5
    n_layers: int = 1  # VideoMamba n_ssm (reference ssm.py:19)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank if self.dt_rank > 0 else math.ceil(self.d_model / 16)


@dataclasses.dataclass(frozen=True)
class TextConfig:
    """Decoder-only transformer (Mistral / Llama / Mixtral families).

    Mistral-7B defaults.  The 4-layer gate LM is the same architecture with
    vocab_size=2, num_layers=4 (reference builder.py:376-378).
    Mixtral: set num_experts > 1.
    """

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 32768
    sliding_window: int = 0  # 0 → full causal attention
    tie_word_embeddings: bool = False
    qkv_bias: bool = False  # Qwen2: biases on q/k/v projections only
    # MoE (Mixtral); num_experts == 1 → dense MLP.
    num_experts: int = 1
    num_experts_per_tok: int = 2
    # attention logit soft-capping etc. left off — not in any backbone we match

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


def mistral_7b() -> TextConfig:
    return TextConfig()


def gate_lm_config(hidden_size: int = 4096) -> TextConfig:
    """The 2-way gate LM: 4-layer Mistral with a 2-token vocabulary."""
    return TextConfig(
        vocab_size=2,
        hidden_size=hidden_size,
        intermediate_size=14336,
        num_layers=4,
        num_heads=32,
        num_kv_heads=8,
        head_dim=hidden_size // 32,
    )


def mixtral_8x7b() -> TextConfig:
    return TextConfig(num_experts=8, num_experts_per_tok=2)


def text_config_from_hf(raw: dict) -> TextConfig:
    """A TextConfig from an HF-style config.json dict: mistral, mixtral
    (num_local_experts > 1) and qwen2 (q/k/v biases)."""
    hidden = raw.get("hidden_size", 4096)
    heads = raw.get("num_attention_heads", 32)
    model_type = raw.get("model_type", "mistral").lower()
    return TextConfig(
        vocab_size=raw.get("vocab_size", 32000),
        hidden_size=hidden,
        intermediate_size=raw.get("intermediate_size", 14336),
        num_layers=raw.get("num_hidden_layers", 32),
        num_heads=heads,
        num_kv_heads=raw.get("num_key_value_heads", heads),
        head_dim=raw.get("head_dim", hidden // heads),
        rms_norm_eps=raw.get("rms_norm_eps", 1e-5),
        rope_theta=raw.get("rope_theta", 10000.0),
        max_position_embeddings=raw.get("max_position_embeddings", 32768),
        sliding_window=raw.get("sliding_window") or 0,
        tie_word_embeddings=raw.get("tie_word_embeddings", False),
        qkv_bias=model_type == "qwen2",
        num_experts=raw.get("num_local_experts", 1),
        num_experts_per_tok=raw.get("num_experts_per_tok", 2),
    )


def qwen2_7b() -> TextConfig:
    """Qwen2-7B-Instruct: the Mistral decoder family with q/k/v biases and a
    larger vocabulary and rope base."""
    return TextConfig(
        vocab_size=152064,
        hidden_size=3584,
        intermediate_size=18944,
        num_layers=28,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        rope_theta=1_000_000.0,
        qkv_bias=True,
    )


def llama2_7b() -> TextConfig:
    return TextConfig(
        vocab_size=32000,
        intermediate_size=11008,
        num_kv_heads=32,
        max_position_embeddings=4096,
    )


@dataclasses.dataclass(frozen=True)
class StreamMindConfig:
    """Top-level model: vision tower + Mamba projector + gate + decoder."""

    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig)
    mamba: MambaConfig = dataclasses.field(default_factory=MambaConfig)
    text: TextConfig = dataclasses.field(default_factory=TextConfig)
    gate: TextConfig = dataclasses.field(default_factory=lambda: gate_lm_config())
    # mm projector type: "mamba" (StreamMind), "linear", "mlp2x_gelu",
    # "stc_connector", "stp_connector", "spatial_conv", "spatial_pool", "identity"
    mm_projector_type: str = "mamba"
    mm_hidden_size: int = 1024  # vision tower output width
    # Streaming limits (static sizes of the memory ring and the turn)
    max_stream_frames: int = 600   # ring-buffer capacity == reference 600 cap
    max_turn_tokens: int = 2048    # decode budget per cognition turn
    num_frames: int = 8            # offline uniform-sample default

    def replace(self, **kw) -> "StreamMindConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "StreamMindConfig":
        raw = json.loads(text)
        return StreamMindConfig(
            vision=VisionConfig(**raw["vision"]),
            mamba=MambaConfig(**raw["mamba"]),
            text=TextConfig(**raw["text"]),
            gate=TextConfig(**raw["gate"]),
            **{k: v for k, v in raw.items() if k not in ("vision", "mamba", "text", "gate")},
        )


# ---------------------------------------------------------------------------
# Tiny configs for tests / CI (CPU-runnable, same code paths)
# ---------------------------------------------------------------------------
def tiny_vision_config() -> VisionConfig:
    return VisionConfig(
        image_size=56,
        patch_size=14,
        hidden_size=32,
        intermediate_size=64,
        num_layers=2,
        num_heads=4,
    )


def tiny_text_config(vocab_size: int = 256) -> TextConfig:
    return TextConfig(
        vocab_size=vocab_size,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
    )


def tiny_mamba_config() -> MambaConfig:
    return MambaConfig(d_model=64, d_state=16, d_conv=4, expand=2)


def tiny_streammind_config() -> StreamMindConfig:
    return StreamMindConfig(
        vision=tiny_vision_config(),
        mamba=tiny_mamba_config(),
        text=tiny_text_config(),
        gate=dataclasses.replace(tiny_text_config(vocab_size=2), num_layers=2),
        mm_hidden_size=32,
        max_stream_frames=16,
        max_turn_tokens=32,
    )
