"""A configuration file read into plain sizes, shared by the weights, the
reference and the operation counts (nothing of the port is imported)."""
from __future__ import annotations

import math
from types import SimpleNamespace as NS


def text_dims(raw: dict) -> NS:
    """A decoder's sizes from HF config.json keys."""
    d, heads = raw["hidden_size"], raw["num_attention_heads"]
    hd = raw.get("head_dim") or d // heads
    return NS(vocab=raw["vocab_size"], d=d, ffn=raw["intermediate_size"],
              layers=raw["num_hidden_layers"], heads=heads,
              kv_heads=raw.get("num_key_value_heads", heads), head_dim=hd,
              eps=raw.get("rms_norm_eps", 1e-5), theta=raw.get("rope_theta", 10000.0),
              experts=raw.get("num_local_experts", 1), top_k=raw.get("num_experts_per_tok", 2),
              q_dim=heads * hd, kv_dim=raw.get("num_key_value_heads", heads) * hd)


def dims(config: dict) -> NS:
    """vision, mamba, gate and text sizes, and whether the decoder is int4."""
    sm = config["streammind"]
    v = sm["vision"]
    vision = NS(image=v["image_size"], patch=v["patch_size"], d=v["hidden_size"],
                ffn=v["intermediate_size"], layers=v["num_hidden_layers"],
                heads=v["num_attention_heads"], eps=v["layer_norm_eps"],
                select_layer=v["select_layer"], grid=v["image_size"] // v["patch_size"])
    vision.head_dim = vision.d // vision.heads
    vision.patches = vision.grid ** 2
    vision.run_layers = (vision.layers + vision.select_layer + 1 if vision.select_layer < 0
                         else vision.select_layer)
    m = sm["mamba"]
    mamba = NS(d=m["d_model"], n=m["d_state"], conv=m["d_conv"], inner=m["expand"] * m["d_model"],
               dt_rank=m.get("dt_rank") or math.ceil(m["d_model"] / 16), blocks=m["n_layers"],
               conv_bias=m["conv_bias"], bias=m["bias"], eps=m["layer_norm_eps"])
    return NS(vision=vision, mamba=mamba, gate=text_dims(sm["gate"]), text=text_dims(config),
              int4_decoder=bool(config["serving"].get("decoder_int4_pc")))
