"""Public inference API, with the JAX package's call shapes:

  model_init(model_path) -> (model, processor, tokenizer, version)
  infer(model, video, instruct, tokenizer, ...) -> str
  infer_beams(model, video, instruct, tokenizer, num_beams=5, ...) -> [str]
  x_infer(video, question, model, tokenizer, mode=...) -> str

``model`` is a StreamMindModel bundle (param tree + config + engine).
Everything runs on ``cuda`` unless ``model_init`` is given ``device="cpu"``.
``video`` is a (T, 3, H, W) array or tensor of CLIP pixel values (what the
``processor`` returned by model_init makes of a file or of raw frames).
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings
from functools import partial
from typing import Optional

import numpy as np
import torch

from .config import StreamMindConfig
from .constants import DEFAULT_MMODAL_TOKEN, MMODAL_TOKEN_INDEX, NUM_FRAMES
from .conversation import SeparatorStyle, conv_templates
from .mm_utils import (
    get_model_name_from_path,
    process_video,
    tokenizer_multimodal_token,
    trim_at_stop_strings,
)
from .models import mistral as lm
from .models import projector as proj_mod
from .models.meta import build_splice_plan, bucket_length, encode_frames, init_projector
from .models.vit import init_vit_params
from .streaming.engine import (
    StreamMindEngine,
    StreamSession,
    _float_dtype,
    decode_tokens_to_text,
    stop_id_matrix,
)
from .utils.params import tree_map


@dataclasses.dataclass
class StreamMindModel:
    """Loaded model bundle: the engine's param tree, the config, the engine."""

    params: dict
    cfg: StreamMindConfig
    engine: StreamMindEngine
    model_path: str = ""

    def new_session(self, tokenizer, **kw) -> StreamSession:
        return StreamSession(self.engine, tokenizer, **kw)


def _load_config(model_path: str) -> StreamMindConfig:
    """streammind_config.json if the checkpoint has one; else the decoder
    from an HF config.json (mistral / mixtral / qwen2 by model_type) with
    the gate LM at its width; else the default StreamMind-7B config."""
    p = os.path.join(model_path, "streammind_config.json")
    if os.path.exists(p):
        with open(p) as f:
            return StreamMindConfig.from_json(f.read())
    p = os.path.join(model_path, "config.json")
    if os.path.exists(p):
        from .config import text_config_from_hf

        with open(p) as f:
            raw = json.load(f)
        cfg = StreamMindConfig()
        text = text_config_from_hf(raw)
        return cfg.replace(text=text, gate=dataclasses.replace(
            cfg.gate, hidden_size=text.hidden_size,
            head_dim=text.hidden_size // cfg.gate.num_heads))
    return StreamMindConfig()


def _init_component(name: str, g: torch.Generator, cfg: StreamMindConfig, device, dtype):
    if name == "vision":
        return init_vit_params(g, cfg.vision, device=device, dtype=dtype)
    if name == "projector":
        return init_projector(g, cfg, device=device, dtype=dtype)
    return lm.init_text_params(g, cfg.text, device=device, dtype=dtype)


def model_init(
    model_path: Optional[str] = None,
    model_name: Optional[str] = None,  # None → from model_path
    cfg: Optional[StreamMindConfig] = None,
    dtype: torch.dtype = torch.bfloat16,
    params: Optional[dict] = None,
    tokenizer=None,
    seed: int = 0,
    quantize_gate=False,
    fast_vision=False,  # False | True (bf16 softmax) | "int8" (int8 ViT)
    load_8bit: bool = False,
    load_4bit=False,  # False | True (int4, groups of 64) | "pc" (the int4 decode tier)
    model_base: Optional[str] = None,  # base decoder dir (LoRA, base + mm_projector.bin)
    vit_attn: str = "auto",  # the engine's ViT attention: auto | exact | flash | bf16
    device="cuda",
):
    """Load a checkpoint directory (or take ``params``, or random weights
    from ``seed`` when neither is given).  Returns (model, processor,
    tokenizer, version).

    A ``model_path`` that is not a directory is refused.  Components the
    checkpoint lacks (vision, projector, text) are random, with a warning.
    The tokenizer comes from ``transformers`` when it is installed and the
    checkpoint holds one; otherwise it is None (pass ``tokenizer=``).  The
    version (conversation template) follows the model name: "v1" for
    vicuna, "qwen" for qwen, else "llama_2"."""
    model_name = model_name or get_model_name_from_path(model_path or "StreamMind-7B")
    if cfg is None:
        cfg = _load_config(model_path) if model_path else StreamMindConfig()
    lm.require_dense_decoder(cfg.text)

    if params is None:
        g = torch.Generator(device=device).manual_seed(seed)
        if model_path:
            if not os.path.isdir(model_path):
                raise FileNotFoundError(
                    f"model_path {model_path!r} is not a local checkpoint directory; "
                    "refusing to fall back to random weights (pass params=/cfg= for a "
                    "scratch model)")
            from .utils.convert import convert_streammind_checkpoint

            params = convert_streammind_checkpoint(model_path, cfg, dtype, base_path=model_base)
            params = tree_map(lambda t: t.to(device), params)
            missing = {"vision", "projector", "text"} - set(params)
            if missing:
                warnings.warn(f"checkpoint {model_path} lacks {sorted(missing)}; those "
                              "components are randomly initialized")
                for k in sorted(missing):
                    params[k] = _init_component(k, g, cfg, device, dtype)
        else:
            params = {k: _init_component(k, g, cfg, device, dtype)
                      for k in ("vision", "projector", "text")}

    if tokenizer is None and model_path:
        try:
            import transformers

            tokenizer = transformers.AutoTokenizer.from_pretrained(model_path)
            if tokenizer.unk_token is not None:
                tokenizer.pad_token = tokenizer.unk_token
        except Exception:  # noqa: BLE001 — no transformers, or no tokenizer files
            tokenizer = None

    if load_8bit or load_4bit:
        # the decoder rests int8 (per channel) or packed int4 (groups of 64,
        # or per channel with the column-halved pack of the int4 kernel)
        from .utils.quantize import quantize_text_params

        params = dict(params)
        params["text"] = quantize_text_params(
            params["text"], bits=4 if load_4bit else 8, free_source=True,
            scheme="pc" if load_4bit == "pc" else "group")

    eos_id = getattr(tokenizer, "eos_token_id", None) if tokenizer else None
    if eos_id is None:  # `or 2` would remap a legitimate eos_token_id of 0
        eos_id = 2
    engine = StreamMindEngine(params, cfg, eos_token_id=eos_id, quantize_gate=quantize_gate,
                              fast_vision=fast_vision, attn_impl=vit_attn, device=device)
    # the bundle holds the engine's tree (fused, quantized tiers applied), so
    # no second copy of the encoder's projections stays resident
    model = StreamMindModel(params=engine.params, cfg=cfg, engine=engine,
                            model_path=model_path or "")

    name = model_name.lower()
    version = "v1" if "vicuna" in name else "qwen" if "qwen" in name else "llama_2"
    processor = partial(process_video, num_frames=cfg.num_frames or NUM_FRAMES,
                        aspect_ratio=None, image_size=cfg.vision.image_size)
    return model, processor, tokenizer, version


def _pixels(model: StreamMindModel, video) -> torch.Tensor:
    """(T, 3, H, W) pixel values on the engine's device in its working dtype."""
    dev, dtype = model.engine.device, engine_dtype(model)
    if isinstance(video, torch.Tensor):
        return video.to(device=dev, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(video, dtype=np.float32)).to(dev).to(dtype)


def encode_memory(model: StreamMindModel, pixels: torch.Tensor) -> torch.Tensor:
    """(T, 3, H, W) pixels → (1, T, hidden) memory tokens: the ViT over the
    frames (600 at most) with the default attention whatever the engine's
    vit_attn, as the JAX package's offline path does, then the projector's
    scan over the clip through the scan kernel."""
    cfg = model.cfg
    feats = encode_frames(model.params, cfg, pixels)
    return proj_mod.project_memory(model.params["projector"], cfg, feats, impl="pallas")


def splice_inputs(model: StreamMindModel, input_ids: list, memory: torch.Tensor):
    """A prompt's ids with one modal slot and (1, T, D) memory → (splice
    plan, memory ring buffer of max(max_stream_frames, T) slots)."""
    cfg, engine = model.cfg, model.engine
    T = memory.shape[1]
    plan = build_splice_plan(input_ids, [T], MMODAL_TOKEN_INDEX["VIDEO"],
                             bucket_length(len(input_ids) - 1 + T, engine.buckets))
    mem_buf = torch.zeros((1, max(cfg.max_stream_frames, T), memory.shape[-1]),
                          dtype=memory.dtype, device=memory.device)
    mem_buf[:, :T] = memory
    return plan, mem_buf


@torch.no_grad()
def _prepare_cognition_inputs(model: StreamMindModel, video, instruct: str, tokenizer,
                              version: str, history=None, sample_type: str = "all",
                              sample_per: float = 0.5):
    """The front half of infer / infer_beams: prompt → splice plan and
    memory ring buffer.  history: [(user, assistant), ...] earlier turns;
    the <video> token goes with the first user turn only.  sample_type /
    sample_per subsample the memory tokens before the splice."""
    modal_index = MMODAL_TOKEN_INDEX["VIDEO"]
    conv = conv_templates["mistral_instruct" if version == "llama_2" else version].copy()
    turns = list(history or []) + [(instruct, None)]
    for i, (user, assistant) in enumerate(turns):
        text = (DEFAULT_MMODAL_TOKEN["VIDEO"] + "\n" + user) if i == 0 else user
        conv.append_message(conv.roles[0], text)
        conv.append_message(conv.roles[1], assistant)
    input_ids = tokenizer_multimodal_token(conv.get_prompt(), tokenizer, modal_index)

    memory = encode_memory(model, _pixels(model, video))
    if sample_type not in (None, "all") and memory.shape[1] > 1:
        from .streaming.memory_subsample import subsample_span_indices

        values = memory[0].float().cpu().numpy() if sample_type == "similarity" else None
        idx = subsample_span_indices(memory.shape[1], sample_type, sample_per, values)
        memory = memory[:, torch.as_tensor(idx, dtype=torch.long, device=memory.device)]
    return splice_inputs(model, input_ids, memory)


@torch.no_grad()
def infer(
    model: StreamMindModel,
    video,
    instruct: str,
    tokenizer,
    do_sample: bool = False,
    version: str = "llama_2",
    max_new_tokens: int = 1024,
    seed: int = 0,
    temperature: Optional[float] = None,
    top_k: int = 0,
    top_p: float = 0.0,
    history=None,
    sample_type: str = "all",
    sample_per: float = 0.5,
):
    """Offline video QA: all frames → memory tokens → splice → prefill →
    decode, stopping at EOS or the template's separator.  history: earlier
    (user, assistant) turns.  top_k / top_p filter the draws when
    temperature > 0 (do_sample without a temperature samples at 0.2);
    draws come from a torch.Generator seeded with ``seed``."""
    engine = model.engine
    plan, mem_buf = _prepare_cognition_inputs(model, video, instruct, tokenizer, version,
                                              history=history, sample_type=sample_type,
                                              sample_per=sample_per)
    if temperature is None:
        temperature = 0.2 if do_sample else 0.0
    # one-shot: a cache of the prompt's bucket plus the decode budget, since
    # dense decode attention reads the whole ring every step
    cache = engine.new_kv_cache(
        dtype=mem_buf.dtype,
        capacity=engine.cache_capacity_for(len(plan.token_ids), max_new_tokens))
    last, cache = engine.prefill(plan, mem_buf, cache)
    tokens, _ = engine.generate_from_prefill(
        last, cache, max_new_tokens=max_new_tokens, temperature=temperature, top_k=top_k,
        top_p=top_p, generator=torch.Generator(device=engine.device).manual_seed(seed),
        stop_ids=stop_id_matrix(tokenizer, _stop_strings(version)))
    if not hasattr(tokenizer, "decode"):
        return ""
    return trim_at_stop_strings(decode_tokens_to_text(tokenizer, tokens).strip(),
                                _stop_strings(version))


@torch.no_grad()
def infer_beams(
    model: StreamMindModel,
    video,
    instruct: str,
    tokenizer,
    num_beams: int = 5,
    num_return_sequences: int = 5,
    max_new_tokens: int = 512,
    version: str = "llama_2",
):
    """Beam-search inference returning the candidate texts, best first (the
    LTA eval's generate(num_beams=5, num_return_sequences=5))."""
    plan, mem_buf = _prepare_cognition_inputs(model, video, instruct, tokenizer, version)
    beams = model.engine.beam_generate(plan, mem_buf, num_beams=num_beams,
                                       num_return_sequences=num_return_sequences,
                                       max_new_tokens=max_new_tokens, kv_dtype=mem_buf.dtype)
    return [trim_at_stop_strings(decode_tokens_to_text(tokenizer, tokens).strip(),
                                 _stop_strings(version)) for tokens, _score in beams]


def _stop_strings(version: str) -> list:
    """The template separator that ends a reply: conv.sep for the SINGLE and
    MPT styles, conv.sep2 otherwise."""
    conv = conv_templates.get(version)
    if conv is None:
        return []
    if conv.sep_style in (SeparatorStyle.SINGLE, SeparatorStyle.MPT):
        stop = conv.sep.strip()
    else:
        stop = conv.sep2
    return [stop] if stop else []


def engine_dtype(model: StreamMindModel) -> torch.dtype:
    return _float_dtype(model.params["vision"])


def x_infer(video, question, model, tokenizer, mode: str = "vanilla", do_sample: bool = False,
            version: str = "llama_2"):
    """Benchmark-mode wrapper: "mcqa", "openend" or "vanilla" instructions."""
    if mode == "mcqa":
        instruction = (f"{question}\nAnswer with the option's letter from the given "
                       f"choices directly and only give the best option.")
    elif mode == "openend":
        instruction = (f"{question}\nAnswer the question using a single word or a short "
                       f"phrase with multiple words.")
    elif mode == "vanilla":
        instruction = question
    else:
        raise ValueError(f"unknown x_infer mode: {mode}")
    return infer(model=model, tokenizer=tokenizer, video=video, instruct=instruction,
                 do_sample=do_sample, version=version)
