"""Training argument dataclasses: the JAX package's Model/Data/
TrainingArguments (the reference's train_new_stream.py:79-139, minus HF
plumbing) with the same fields and defaults, plus ``device``.  Parsed from
CLI flags or a JSON config file."""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class ModelArguments:
    model_path: Optional[str] = None           # base checkpoint dir
    model_base: Optional[str] = None           # base decoder for LoRA /
    # adapter checkpoint dirs (reference --model-base, builder.py:60-142)
    version: str = "v1_mistral"
    vision_tower: Optional[str] = None          # CLIP checkpoint dir
    mm_projector_type: str = "mamba"
    mm_vision_select_layer: int = -2
    mm_vision_select_feature: str = "patch"
    pretrain_mm_mlp_adapter: Optional[str] = None  # mm_projector.bin to load
    tune_mm_mlp_adapter: bool = False
    freeze_backbone: bool = False
    train_skip_cls: bool = False                # copy first gate-depth decoder
                                                # layers into the gate LM
    num_frames: int = 32
    # reference --bits (train_new_stream.py:694-712, bnb 4/8-bit): rest the
    # FROZEN decoder at int8/int4 during the adapter/cls stages.  Not ported
    # yet: train() raises for 4 and 8 (ROADMAP Queue 1 item 17).
    bits: int = 16


@dataclasses.dataclass
class DataArguments:
    data_path: Optional[str] = None             # features_video root / json
    data_folder: Optional[str] = None
    anno_path: Optional[str] = None             # ego4d annotations
    dataset: str = "matchtime"                  # matchtime | ego4d | sft
    image_aspect_ratio: str = "pad"
    cur_fps: float = 2.0
    num_workers: int = 4
    # stage selectors (reference soccer_dataset_train_{llm,cls})
    score_dataset_train_llm: bool = False
    score_dataset_train_cls: bool = False


@dataclasses.dataclass
class TrainingArguments:
    output_dir: str = "./checkpoints/streammind"
    learning_rate: float = 2e-5
    mm_projector_lr: Optional[float] = None
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    lr_scheduler_type: str = "cosine"
    num_train_epochs: int = 1
    max_steps: int = -1
    per_device_train_batch_size: int = 1
    gradient_accumulation_steps: int = 2
    model_max_length: int = 2048
    bf16: bool = True
    save_steps: int = 500
    save_total_limit: int = 3
    logging_steps: int = 10
    seed: int = 42
    grad_clip: float = 1.0
    gradient_checkpointing: bool = True
    # attention of the training forward/backward.  "auto" resolves to the
    # flash kernels (lse forward + dQ and dK/dV backward) on a CUDA device
    # and to the plain reference attention on the CPU.  The reference trains
    # with flash-attn 2.5.8 (requirements.txt:87).
    attn_impl: str = "auto"
    resume: bool = True
    # LoRA (reference lora_enable/lora_r/lora_alpha, train_new_stream.py:110-118)
    lora_enable: bool = False
    lora_r: int = 128
    lora_alpha: int = 256
    lora_dropout: float = 0.05
    # mesh: only 1 x 1 x 1 is ported (train() raises otherwise)
    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    # where the model and the step run: "cuda" (the kernels) or "cpu" (their
    # plain versions)
    device: str = "cuda"

    @property
    def stage(self) -> str:
        return "cls"  # overridden by caller from DataArguments


def parse_args(argv=None):
    """CLI → (ModelArguments, DataArguments, TrainingArguments).

    Accepts --config file.json overriding defaults, then flag overrides.
    """
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=None)
    for dc in (ModelArguments, DataArguments, TrainingArguments):
        for f in dataclasses.fields(dc):
            arg = "--" + f.name.replace("_", "-")
            if f.type == "bool" or isinstance(f.default, bool):
                parser.add_argument(arg, type=lambda s: s.lower() in ("1", "true", "yes"),
                                    default=None)
            else:
                parser.add_argument(arg, type=str, default=None)
    ns = vars(parser.parse_args(argv))

    overrides = {}
    if ns.get("config"):
        with open(ns["config"]) as f:
            overrides.update(json.load(f))
    for k, v in ns.items():
        if k != "config" and v is not None:
            overrides[k.replace("-", "_")] = v

    def build(dc):
        kwargs = {}
        for f in dataclasses.fields(dc):
            if f.name in overrides:
                v = overrides[f.name]
                ftype = f.type if isinstance(f.type, type) else None
                if isinstance(f.default, bool):
                    v = v if isinstance(v, bool) else str(v).lower() in ("1", "true", "yes")
                elif isinstance(f.default, int) and not isinstance(f.default, bool):
                    v = int(v)
                elif isinstance(f.default, float):
                    v = float(v)
                elif f.default is None and isinstance(v, str):
                    # Optional numeric fields (e.g. mm_projector_lr) arrive as
                    # CLI strings; coerce when they parse as numbers
                    try:
                        v = int(v)
                    except ValueError:
                        try:
                            v = float(v)
                        except ValueError:
                            pass
                kwargs[f.name] = v
        return dc(**kwargs)

    return build(ModelArguments), build(DataArguments), build(TrainingArguments)
